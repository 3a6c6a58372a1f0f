"""HJB / parabolic path-space solver (JAX rebuild of ``Solver``,
solver.py:18-557).

Differences from the reference by design (not capability):
  * The whole iteration — rollout, loss, gradients, optimizer update,
    diagnostics — is ONE jitted function; the reference runs an eager
    Python time loop with a host round-trip per step (solver.py:440-494).
  * One optax optimizer over the combined parameter PyTree (with an
    optional separate learning rate for y_0) replaces per-module Adam
    (solver.py:194-200).
  * Reference-control lookups (u L2 error) are device-side table gathers
    prepared at setup (solver.py:491-494 forces a CPU sync per step).
  * With a ``jax.sharding.Mesh``, the path ensemble is sharded over the
    'dp' axis via sharding constraints; XLA inserts the all-reduces the
    global-mean losses need.
"""

from __future__ import annotations

import json
import os
import time
from datetime import date

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ansatz import DenseNet, ScalarParam, TanhMLP
from ..losses.pathspace import (hjb_loss, log_variance_y0_losses)
from ..rollout.sde import (HJBRolloutConfig, hjb_rollout,
                           hjb_rollout_batched_grad, hjb_rollout_dk)
from ._chunk import resolve_steps_per_call, run_training

ROLLOUT_MODES = ("scan", "batched_grad")

# layout='auto' switches the scan to the transposed dk layout at this path
# count.  The threshold was set on another accelerator (where K >= 1024
# filled its 128-wide vector lanes); it has not been measured on the GPU.
DK_MIN_PATHS = 1024


def check_rollout_mode(mode, valid=ROLLOUT_MODES):
    if mode not in valid:
        raise ValueError("rollout_mode=%r is not supported; valid modes: %s"
                         % (mode, ", ".join(repr(m) for m in valid)))
    return mode


def init_stacked(module, key, n_copies: int, sample_in: jnp.ndarray):
    """Init N per-step parameter copies, stacked on a leading axis
    (the 'outer' time approximation, solver.py:88)."""
    keys = jax.random.split(key, n_copies)
    return jax.vmap(lambda k: module.init(k, sample_in))(keys)


def select_step(stacked, n, n_max: int):
    n = jnp.clip(n, 0, n_max - 1)
    return jax.tree.map(lambda p: p[n], stacked)


class HJBSolver:
    """Drives a parabolic/HJB problem with the path-space loss zoo.

    Constructor kwargs mirror ``Solver.__init__`` (solver.py:20-25); the
    ansatz can be overridden by passing a module as ``control_net`` /
    ``value_net`` (replacing the reference's post-construction attribute
    mutation protocol, SURVEY.md section 5.6).
    """

    def __init__(self, name, problem, lr=0.001, L=10000, K=50, delta_t=0.05,
                 approx_method="control", loss_method="log-variance",
                 time_approx="outer", learn_Y_0=False,
                 adaptive_forward_process=True, detach_forward=False,
                 early_stopping_time=10000, random_X_0=False,
                 compute_gradient_variance=0,
                 IS_variance_K=0, IS_variance_iter=1,
                 metastability_logs=None, print_every=100, seed=42,
                 save_results=False, u_l2_error_flag=True,
                 log_gradient=False, plot_trajectories=None,
                 burgers_drift=False, verbose=True,
                 control_net=None, value_net=None, lr_y0=None,
                 remat=None, mesh=None, dtype=jnp.float32,
                 rollout_mode="scan", steps_per_call="auto",
                 rng_impl="threefry", layout="auto", antithetic=False):
        self.problem = problem
        self.name = name
        self.date = date.today().strftime("%Y-%m-%d")
        self.d = problem.d
        self.T = problem.T
        self.seed = seed
        self.delta_t = float(delta_t)
        self.N = int(np.floor(self.T / self.delta_t))
        self.lr = lr
        self.lr_y0 = lr if lr_y0 is None else lr_y0
        self.L = L
        self.K = K
        self.random_X_0 = random_X_0
        self.dtype = dtype

        self.loss_method = loss_method
        self.approx_method = approx_method
        self.time_approx = time_approx
        self.learn_Y_0 = learn_Y_0
        self.adaptive_forward_process = adaptive_forward_process
        self.detach_forward = detach_forward
        self.early_stopping_time = early_stopping_time
        self.burgers_drift = burgers_drift

        # solver.py:61-64
        if self.loss_method == "relative_entropy":
            self.adaptive_forward_process = True
        if self.loss_method == "cross_entropy":
            self.learn_Y_0 = False

        # Degenerate-gradient trap (beyond-reference guard; the reference
        # has the same silent failure): the relative-entropy loss
        # E[∫(½|Z|²+f)dt + g] is an ON-POLICY objective — its gradient
        # carries a measure term that only exists when the graph runs
        # through the trajectory (Nüsken & Richter's motivation for the
        # log-variance loss).  With detach_forward=True that term is cut
        # and the surviving E[∫Z·∂Z dt] just shrinks Z toward 0: training
        # silently stalls at init (measured round 5: LLGC d=10 u_L2 stays
        # 4.18 for 200 iters).  Warn once instead of wasting the run.
        if detach_forward and self.loss_method == "relative_entropy":
            import warnings
            warnings.warn(
                "loss_method='relative_entropy' with detach_forward=True "
                "has a degenerate gradient (the on-policy measure term is "
                "detached; the remaining term only shrinks Z toward 0) - "
                "use detach_forward=False, or a detach-compatible loss "
                "(log-variance / moment / cross_entropy)", stacklevel=2)

        self.has_ref_solution = (hasattr(problem, "u_ref_fn")
                                 or hasattr(problem, "u_ref"))
        self.u_l2_error_flag = u_l2_error_flag and self.has_ref_solution

        self.print_every = print_every
        self.verbose = verbose
        self.save_results = save_results
        self.IS_variance_K = IS_variance_K
        self.IS_variance_iter = IS_variance_iter
        self.metastability_logs = metastability_logs
        self.plot_trajectories = plot_trajectories
        self.compute_gradient_variance = compute_gradient_variance
        self.log_gradient = log_gradient
        self.mesh = mesh
        self.steps_per_call = steps_per_call
        self.remat = (self.N > 512) if remat is None else remat
        # 'scan' (default: lax.scan with optional remat) or 'batched_grad'
        # (gradient-free forward + one flattened (N*K)-row differentiable
        # control evaluation; requires detach_forward and y-free h, and
        # falls back to the scan with a warning otherwise).  Any other
        # mode raises.
        self.rollout_mode = check_rollout_mode(rollout_mode)
        # layout='dk' carries the scan path state transposed (d, K)
        # (rollout/sde.py: hjb_rollout_dk; requires the problem's
        # transposed-coefficient protocol, control mode, and a
        # transposed-apply-capable net — falls back to 'kd' with a warning
        # otherwise).  'auto' (default) picks dk when those gates pass AND
        # K >= DK_MIN_PATHS, a threshold set on another accelerator and
        # not measured on the GPU; explicit 'kd'/'dk' force.
        self.layout = layout
        # antithetic: simulate the K training paths as K/2 mirrored noise
        # pairs (xi, -xi) (no reference counterpart; see
        # eval/importance_sampling.py for the serve-path variant).
        # Measured (LLGC d=10, K=2048, identical params): helps MEAN-type
        # losses — relative_entropy loss-value std 180x smaller, total
        # gradient variance -37% (the KL Ito term is odd in the noise and
        # cancels exactly pairwise) — but HURTS variance-type losses
        # (log-variance grad variance +40%: correlated pairs degrade a
        # batch-variance estimator).  Use with relative_entropy /
        # cross_entropy / moment; leave off for log-variance.  Rollouts
        # mirror within the batch: paths (i, i + K/2) form the pairs.
        if antithetic and K % 2:
            raise ValueError("antithetic training needs even K")
        self.antithetic = antithetic

        # -- ansatz ---------------------------------------------------------
        # rng_impl: 'threefry' (default; cross-backend reproducible,
        # checkpoint-stable key format) or 'rbg' (XLA RngBitGenerator for
        # the in-rollout normal draws: cheaper bit generation, its speed
        # on the GPU not measured yet; key DERIVATION stays threefry, so
        # fold_in/split semantics are unchanged).  Param init always uses
        # threefry so parameters are identical across rng_impl settings.
        self.rng_impl = rng_impl
        key = jax.random.PRNGKey(seed)
        k_net, k_y0, self._train_key = jax.random.split(key, 3)
        if rng_impl != "threefry":
            self._train_key = jax.random.key(seed ^ 0x5eed, impl=rng_impl)
        params = {}
        if approx_method == "control":
            d_in = self.d if time_approx == "outer" else self.d + 1
            # params stay f32; a non-f32 dtype runs the net matmuls (and
            # the rollout state) in that dtype, accumulators stay f32
            cdt = None if dtype == jnp.float32 else dtype
            if control_net is None:
                control_net = (DenseNet(d_out=self.d, compute_dtype=cdt)
                               if time_approx == "outer"
                               else TanhMLP(d_out=self.d, compute_dtype=cdt))
            self.z_net = control_net
            sample = jnp.zeros((1, d_in), dtype=dtype)
            if time_approx == "outer":
                params["z"] = init_stacked(self.z_net, k_net, self.N, sample)
            else:
                params["z"] = self.z_net.init(k_net, sample)
            self.y0_net = ScalarParam(initial=0.0)
            if self.learn_Y_0:
                params["y0"] = self.y0_net.init(k_y0, sample[:, :1])
        elif approx_method == "value_function":
            d_in = self.d if time_approx == "outer" else self.d + 1
            if value_net is None:
                value_net = DenseNet(d_out=1)
            self.y_net = value_net
            sample = jnp.zeros((1, d_in), dtype=dtype)
            if time_approx == "outer":
                # solver.py:95: one net per step (N of them)
                params["y"] = init_stacked(self.y_net, k_net, self.N + 1,
                                           sample)
            else:
                params["y"] = self.y_net.init(k_net, sample)
        else:
            raise ValueError(approx_method)
        self.params = params

        # -- optimizer ------------------------------------------------------
        if "y0" in params and self.lr_y0 != self.lr:
            label = {k: ("y0" if k == "y0" else "main") for k in params}
            self.tx = optax.multi_transform(
                {"main": optax.adam(self.lr), "y0": optax.adam(self.lr_y0)},
                label)
        else:
            self.tx = optax.adam(self.lr)
        self.opt_state = self.tx.init(self.params)

        # -- reference control table ---------------------------------------
        self._u_ref = None
        if self.u_l2_error_flag:
            ts = np.arange(self.N) * self.delta_t
            if hasattr(problem, "u_ref_fn"):
                self._u_ref = problem.u_ref_fn(ts)
            else:  # time-independent closed form u_ref(x)
                self._u_ref = lambda x, n: problem.u_ref(x)

        self._v_ref_0 = None

        # -- logging (reference names, solver.py:112-119) -------------------
        self.Y_0_log = []
        self.loss_log = []
        self.u_L2_loss = []
        self.IS_rel_log = []
        self.times = []
        self.particles_close_to_target = []
        self.grads_rel_error_log = []
        self.gradient_log = []
        self.step = 0

        self._step_fns = {}

    # ---------------------------------------------------------------------
    def _control_fn(self):
        """(params, X, n, t) -> (Z, V_or_None), solver.py:334-362."""
        approx, time_approx = self.approx_method, self.time_approx
        N = self.N

        if approx == "control":
            net = self.z_net

            def fn(params, X, n, t):
                if time_approx == "outer":
                    p = select_step(params["z"], n, N)
                    return net.apply(p, X), None
                tX = jnp.concatenate(
                    [jnp.full((X.shape[0], 1), 0.0, X.dtype) + t, X], axis=1)
                return net.apply(params["z"], tX), None

            return fn

        net = self.y_net
        sig = self.problem.sigma_struct

        def fn(params, X, n, t):
            if time_approx == "outer":
                p = select_step(params["y"], n, N + 1)
                v_of_x = lambda x: net.apply(p, x)[:, 0]
            else:
                def v_of_x(x):
                    tx = jnp.concatenate(
                        [jnp.full((x.shape[0], 1), 0.0, x.dtype) + t, x],
                        axis=1)
                    return net.apply(params["y"], tx)[:, 0]
            V, pull = jax.vjp(v_of_x, X)
            (gradX,) = pull(jnp.ones_like(V))
            return sig.apply_T(gradX), V

        return fn

    def _y_init_fn(self):
        approx = self.approx_method
        control_fn = self._control_fn()

        def fn(params, X):
            if approx == "value_function":
                _, V = control_fn(params, X, jnp.int32(0), jnp.float32(0.0))
                return V
            if self.learn_Y_0:
                return self.y0_net.apply(params["y0"], X[:, :1])
            return jnp.zeros((X.shape[0],), dtype=X.dtype)

        return fn

    def _rollout_cfg(self, phase: int) -> HJBRolloutConfig:
        lm = self.loss_method
        return HJBRolloutConfig(
            N=self.N, delta_t=self.delta_t,
            adaptive_forward=self.adaptive_forward_process,
            detach_forward=self.detach_forward,
            accumulate_kl="relative_entropy" in lm,
            kl_ito_term=(lm == "relative_entropy_BSDE"),
            reparametrization=(lm == "reparametrization"),
            repa_phase=(phase if lm == "log-variance-repa" else None),
            burgers_drift=self.burgers_drift,
            value_mode=(self.approx_method == "value_function"),
            track_u_l2=self.u_l2_error_flag,
            remat=self.remat,
            antithetic=self.antithetic,
        )

    def _shard(self, x):
        if self.mesh is None:
            return x
        spec = P("dp") if x.ndim == 1 else P("dp", *([None] * (x.ndim - 1)))
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, spec))

    def _build_step(self, phase: int):
        control_fn = self._control_fn()
        y_init = self._y_init_fn()
        cfg = self._rollout_cfg(phase)
        problem = self.problem
        lm = self.loss_method
        K, d = self.K, self.d
        dtype = self.dtype
        u_ref = self._u_ref
        meta = self.metastability_logs
        if meta is not None:
            meta_target = jnp.asarray(meta[0], dtype=dtype)
            meta_eps = float(meta[1])

        def init_X(key):
            if self.random_X_0:
                X0 = jax.random.normal(key, (K, d), dtype=dtype)
            else:
                X0 = jnp.broadcast_to(
                    problem.X_0.astype(dtype), (K, d))
            return self._shard(X0)

        path_grad_ok = (
            cfg.detach_forward and not cfg.value_mode
            and cfg.repa_phase is None and not cfg.burgers_drift
            and getattr(problem, "h_is_y_free", False))
        use_batched_grad = self.rollout_mode == "batched_grad" and path_grad_ok
        rollout = (hjb_rollout_batched_grad if use_batched_grad
                   else hjb_rollout)

        # transposed (d, K) scan layout: layout='auto' (default) resolves
        # to dk at K >= DK_MIN_PATHS (see its note); explicit 'kd'/'dk'
        # force.
        want_dk = (self.layout == "dk"
                   or (self.layout == "auto" and self.K >= DK_MIN_PATHS))
        use_dk = (
            want_dk and self.rollout_mode == "scan"
            and self.approx_method == "control"
            and not cfg.value_mode and not cfg.burgers_drift
            and getattr(problem, "supports_transposed", False)
            and (not self.u_l2_error_flag
                 or hasattr(problem, "u_ref_table")))
        if use_dk:
            from ..ansatz.transposed import transposed_apply
            z_net_dk = self.z_net
            N_dk = self.N
            try:  # probe net support once at trace-build time
                d_in = d if self.time_approx == "outer" else d + 1
                sample_p = (select_step(self.params["z"], 0, N_dk)
                            if self.time_approx == "outer"
                            else self.params["z"])
                jax.eval_shape(lambda p: transposed_apply(
                    z_net_dk, p, jnp.zeros((d_in, 4), dtype)), sample_p)
            except NotImplementedError:
                use_dk = False

        # -- surface the resolved engine: opt-in perf modes gate on many
        # conditions, so record what actually runs and warn once on a
        # downgrade (a benchmark of 'batched_grad' must not silently time
        # the scan).
        self.resolved_rollout_mode = ("batched_grad" if use_batched_grad
                                      else "scan")
        self.resolved_layout = "dk" if use_dk else "kd"
        if not getattr(self, "_fallback_warned", False):
            import warnings
            msgs = []
            if self.resolved_rollout_mode != self.rollout_mode:
                msgs.append(
                    "rollout_mode=%r fell back to %r (a gate failed: see "
                    "the rollout_mode docstring in HJBSolver.__init__ for "
                    "the requirements)"
                    % (self.rollout_mode, self.resolved_rollout_mode))
            if self.layout == "dk" and self.resolved_layout != "dk":
                msgs.append(
                    "layout='dk' fell back to 'kd' (needs rollout_mode="
                    "'scan', control mode, the problem's transposed-"
                    "coefficient protocol and a transposed-apply net)")
            if msgs:
                self._fallback_warned = True
                warnings.warn("; ".join(msgs), stacklevel=2)

        if use_dk:
            if self.time_approx == "outer":
                def control_T_fn(params, XT, n, t):
                    p = select_step(params["z"], n, N_dk)
                    return transposed_apply(z_net_dk, p, XT)
            else:
                def control_T_fn(params, XT, n, t):
                    tX = jnp.concatenate(
                        [jnp.zeros((1, XT.shape[1]), XT.dtype) + t, XT],
                        axis=0)
                    return transposed_apply(z_net_dk, params["z"], tX)
            u_tab_dk = (problem.u_ref_table(np.arange(self.N)
                                            * self.delta_t)
                        if self.u_l2_error_flag else None)

            def init_XT(key):
                if self.random_X_0:
                    X0T = jax.random.normal(key, (d, K), dtype=dtype)
                else:
                    X0T = jnp.broadcast_to(
                        problem.X_0.astype(dtype)[:, None], (d, K))
                if self.mesh is not None:
                    X0T = jax.lax.with_sharding_constraint(
                        X0T, NamedSharding(self.mesh, P(None, "dp")))
                return X0T

        def rollout_outputs(params, key):
            kx, kr = jax.random.split(key)
            if use_dk:
                X0T = init_XT(kx)
                Y0 = self._shard(y_init(params, X0T[:1, :].T))
                return hjb_rollout_dk(cfg, problem, control_T_fn, params,
                                      X0T, Y0, kr, u_tab=u_tab_dk)
            X0 = init_X(kx)
            Y0 = self._shard(y_init(params, X0))
            return rollout(cfg, problem, control_fn, params, X0, Y0, kr,
                           u_ref=u_ref)

        def loss_fn(params, key):
            out = rollout_outputs(params, key)
            gX = problem.g(out.X)
            loss = hjb_loss(lm, out.Y, gX, out.Z_sum,
                            adaptive=self.adaptive_forward_process,
                            phase=phase)
            loss = loss + jnp.mean(out.add_loss)
            aux = {"u_l2": jnp.mean(out.u_l2), "X": out.X, "Y": out.Y}
            return loss, aux

        def _extra_metrics(params, X_final):
            m = {}
            if self.learn_Y_0 and self.approx_method == "control":
                m["Y_0"] = self.y0_net.apply(params["y0"],
                                             jnp.zeros((1, 1), dtype))[0]
            if meta is not None:
                dist = jnp.sqrt(jnp.sum((X_final - meta_target) ** 2,
                                        axis=-1))
                m["meta_frac"] = jnp.mean((dist < meta_eps).astype(dtype))
            return m

        def split_y0_step(params, opt_state, key):
            """'log-variance-y_0' (solver.py:205-218): variance part updates
            the control net, squared-mean part updates y_0 — one forward,
            two pullbacks."""
            def roll(p):
                out = rollout_outputs(p, key)
                return (out.Y, problem.g(out.X)), out

            (Y, gX), vjp, out = jax.vjp(roll, params, has_aux=True)
            var_part, meansq_part = log_variance_y0_losses(Y, gX)
            gY1 = jax.grad(lambda y: log_variance_y0_losses(y, gX)[0])(Y)
            gY2 = jax.grad(lambda y: log_variance_y0_losses(y, gX)[1])(Y)
            (g1,) = vjp((gY1, jnp.zeros_like(gX)))
            (g2,) = vjp((gY2, jnp.zeros_like(gX)))
            grads = {k: (g2[k] if k == "y0" else g1[k]) for k in params}
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            metrics = {"loss": var_part + meansq_part,
                       "u_l2": jnp.mean(out.u_l2)}
            metrics.update(_extra_metrics(params, out.X))
            return params, opt_state, metrics

        def step(params, opt_state, key):
            if lm == "log-variance-y_0":
                return split_y0_step(params, opt_state, key)
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, key)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            metrics = {"loss": loss, "u_l2": aux["u_l2"]}
            if self.log_gradient:
                gz = grads.get("z", grads.get("y"))
                metrics["grad_flat"] = jnp.concatenate(
                    [jnp.reshape(l, (-1,)) for l in jax.tree.leaves(gz)])
            metrics.update(_extra_metrics(params, aux["X"]))
            return params, opt_state, metrics

        step.loss_fn = loss_fn  # (params, key) -> (loss, aux), for checks
        return step

    def _get_step(self, phase: int):
        if phase not in self._step_fns:
            self._step_fns[phase] = jax.jit(self._build_step(phase),
                                            donate_argnums=(0, 1))
        return self._step_fns[phase]

    def _phase(self, l: int) -> int:
        if self.loss_method == "log-variance-repa":
            return l % 2
        if self.loss_method == "relative_entropy_log-variance":
            return 0 if l < 1000 else 1
        return 0

    def _record(self, m):
        self.loss_log.append(float(m["loss"]))
        self.u_L2_loss.append(float(m["u_l2"]))
        if "Y_0" in m:
            self.Y_0_log.append(float(m["Y_0"]))
        if "meta_frac" in m:
            self.particles_close_to_target.append(float(m["meta_frac"]))
        if self.log_gradient and "grad_flat" in m:
            self.gradient_log.append(np.asarray(m["grad_flat"]))

    def _maybe_print(self, done, n):
        first = done - n
        if self.verbose and (first == 0 or first // self.print_every
                             != done // self.print_every):
            s = ("%d - loss: %.4e - u L2: %.4e - time/iter: %.2fs"
                 % (done - 1, self.loss_log[-1], self.u_L2_loss[-1],
                    np.mean(self.times[-self.print_every:])))
            if self.Y_0_log:
                s += " - Y_0: %.4e" % self.Y_0_log[-1]
            print(s)

    def _early_stop(self, done):
        """u-L2 plateau early stopping (solver.py:550-554); in chunked
        mode checked at chunk boundaries."""
        est = self.early_stopping_time
        if est is None or done <= est:
            return False
        return (np.std(self.u_L2_loss[-est:])
                / (self.u_L2_loss[-1] + 1e-30) < 0.02)

    # ---------------------------------------------------------------------
    def train(self):
        if self.verbose:
            lr_s = ("%.2e" % self.lr if isinstance(self.lr, (int, float))
                    else "schedule")  # optax schedules are callables
            print("d = %d, L = %d, K = %d, delta_t = %.2e, lr = %s, "
                  "%s, %s, %s, %s"
                  % (self.d, self.L, self.K, self.delta_t, lr_s,
                     self.approx_method, self.time_approx, self.loss_method,
                     "adaptive" if self.adaptive_forward_process else ""))
        # Scan-chunked fast path: valid when the step is phase-static and
        # no per-iteration host-side diagnostics are interleaved
        # (steps_per_call='auto', the default, chunks exactly when this
        # gate passes — _chunk.resolve_steps_per_call).
        chunkable = (self.loss_method not in (
                         "log-variance-repa", "relative_entropy_log-variance")
                     and self.compute_gradient_variance == 0
                     and self.IS_variance_K == 0)
        if resolve_steps_per_call(self, chunkable) > 1 and chunkable:
            run_training(self, self._build_step(0),
                         stop_check=self._early_stop)
            self._finish_train()
            return
        self.resolved_steps_per_call = 1
        key = self._train_key
        rel_IS = None
        for l in range(self.step, self.L):
            t0 = time.time()
            key, sub = jax.random.split(key)
            step = self._get_step(self._phase(l))
            self.params, self.opt_state, metrics = step(
                self.params, self.opt_state, sub)
            metrics = jax.device_get(metrics)
            self.loss_log.append(float(metrics["loss"]))
            self.u_L2_loss.append(float(metrics["u_l2"]))
            if "Y_0" in metrics:
                self.Y_0_log.append(float(metrics["Y_0"]))
            if "meta_frac" in metrics:
                self.particles_close_to_target.append(
                    float(metrics["meta_frac"]))
            if self.log_gradient and "grad_flat" in metrics:
                self.gradient_log.append(np.asarray(metrics["grad_flat"]))

            if (self.compute_gradient_variance > 0
                    and l % self.compute_gradient_variance == 0):
                from ..eval.gradient_variance import gradient_variances
                rel = gradient_variances(self, jax.random.fold_in(sub, 3))
                self.grads_rel_error_log.append(
                    float(jnp.mean(jnp.abs(rel))))

            if self.IS_variance_K > 0 and l % self.IS_variance_iter == 0:
                if not hasattr(self, "_is_runner"):
                    from ..eval.importance_sampling import make_is_runner
                    self._is_runner = make_is_runner(
                        self.problem, self, self.IS_variance_K)
                _, _, rel_IS = jax.device_get(
                    self._is_runner(self.params, jax.random.fold_in(key, 1)))
                self.IS_rel_log.append(float(rel_IS))

            self.times.append(time.time() - t0)
            self.step = l + 1
            self._train_key = key

            if self.verbose and l % self.print_every == 0:
                s = ("%d - loss: %.4e - u L2: %.4e - time/iter: %.2fs"
                     % (l, self.loss_log[-1], self.u_L2_loss[-1],
                        np.mean(self.times[-self.print_every:])))
                if self.Y_0_log:
                    s += " - Y_0: %.4e" % self.Y_0_log[-1]
                if rel_IS is not None:
                    s += " - rel IS: %.3e" % rel_IS
                print(s)

            # solver.py:550-554
            if self.early_stopping_time is not None:
                if (l > self.early_stopping_time
                        and np.std(self.u_L2_loss[-self.early_stopping_time:])
                        / (self.u_L2_loss[-1] + 1e-30) < 0.02):
                    break

        self._finish_train()

    def _finish_train(self):
        if self.save_results:
            self.save_logs()
        if self.plot_trajectories:
            # solver.py:75 + utilities.py:277-282: plot a learned-control
            # path ensemble after training (the reference stores the kwarg
            # and forwards it to do_importance_sampling's trajectory plot)
            from ..eval.plotting import plot_path_ensemble
            self.trajectory_fig, _ = plot_path_ensemble(
                self.problem, self, int(self.plot_trajectories),
                control="approx", delta_t=self.delta_t)

    # -- evaluation API (used by eval/, mirrors Z_n semantics) -------------
    def Z_n(self, X, t: float):
        """Control evaluation at continuous time t (solver.py:360-362)."""
        n = int(np.ceil(t / self.delta_t))
        fn = self._control_fn()
        Z, _ = fn(self.params, X, jnp.int32(n),
                  jnp.float32(n * self.delta_t))
        return Z

    def u(self, X, t: float):
        return -self.Z_n(X, t)

    def Y_n(self, X, t: float):
        """Value-function evaluation at time t (value mode only;
        solver.py:341-347 with the consistent t = n*dt indexing)."""
        assert self.approx_method == "value_function"
        n = int(np.ceil(t / self.delta_t))
        fn = self._control_fn()
        _, V = fn(self.params, X, jnp.int32(min(n, self.N)),
                  jnp.float32(t))
        return V

    def train_LSE_with_reference(self, xb=2.0, n_grid=200):
        """Supervised least-squares fit of the control against u_true on a
        1-d grid (solver.py:384-418)."""
        assert self.approx_method == "control" and self.u_l2_error_flag
        X = jnp.linspace(-xb, xb, n_grid)[:, None].astype(self.dtype)
        control_fn = self._control_fn()
        u_ref = self._u_ref
        dt = self.delta_t
        N = self.N

        def loss_fn(params):
            def body(acc, n):
                Z, _ = control_fn(params, X, n, n.astype(jnp.float32) * dt)
                err = (-Z - u_ref(X, n)) ** 2
                return acc + jnp.sum(err) * dt, None
            loss, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(N))
            return loss

        @jax.jit
        def step(params, opt_state):
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        for l in range(self.L):
            t0 = time.time()
            self.params, self.opt_state, loss = step(self.params,
                                                     self.opt_state)
            self.loss_log.append(float(loss))
            self.times.append(time.time() - t0)
            if self.verbose and l % self.print_every == 0:
                print("%d - loss: %.3e - time/iter: %.2fs"
                      % (l, self.loss_log[-1],
                         np.mean(self.times[-self.print_every:])))

    _LOG_ATTRS = ("loss_log", "u_L2_loss", "Y_0_log", "IS_rel_log",
                  "times", "particles_close_to_target",
                  "grads_rel_error_log")

    # -- persistence (solver.py:283-332) -----------------------------------
    def save_logs(self, model_name="model", log_dir="logs"):
        os.makedirs(log_dir, exist_ok=True)
        logs = {
            "name": self.name, "date": self.date, "d": self.d, "T": self.T,
            "seed": self.seed, "delta_t": self.delta_t, "N": self.N,
            "lr": self.lr, "K": self.K, "loss_method": self.loss_method,
            "learn_Y_0": self.learn_Y_0,
            "adaptive_forward_process": self.adaptive_forward_process,
            "Y_0_log": self.Y_0_log, "loss_log": self.loss_log,
            "u_L2_loss": self.u_L2_loss,
            "params": jax.tree.map(lambda a: np.asarray(a).tolist(),
                                   self.params),
        }
        path = os.path.join(log_dir, "%s_%s_%s.json"
                            % (model_name, self.name, self.date))
        i = 1
        while os.path.isfile(path):
            i += 1
            path = os.path.join(log_dir, "%s_%s_%s_%d.json"
                                % (model_name, self.name, self.date, i))
        with open(path, "w") as f:
            json.dump(logs, f, indent=2)
        return path

    def save_networks(self, out_dir="output"):
        from ..utils.checkpoint import save_params
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "%s_%s" % (self.name, self.date))
        save_params(path, self.params, self.opt_state)
        if self.verbose:
            print("\nnetworks data has been stored to: %s" % path)
        return path

    def load_networks(self, path):
        from ..utils.checkpoint import load_params
        self.params, self.opt_state = load_params(
            path, self.params, self.opt_state)

    def save_training_state(self, out_dir="output"):
        """Full resume checkpoint: params, opt state, RNG key, step, logs."""
        import os
        from ..utils.checkpoint import save_training_state
        os.makedirs(out_dir, exist_ok=True)
        return save_training_state(
            os.path.join(out_dir, "%s_%s_state" % (self.name, self.date)),
            self)

    def load_training_state(self, path):
        from ..utils.checkpoint import load_training_state
        load_training_state(path, self)
