"""General space-time parabolic solver (JAX rebuild of ``GeneralSolver``,
solver.py:934-1323).

Like EllipticSolver but the value net takes (x, t) (solver.py:980), start
points are sampled uniformly in space AND t ~ U(0, T) (solver.py:1078),
paths stop on spatial exit OR time-horizon exhaustion (solver.py:1131),
and the loss adds a terminal condition (V(x, T) - f(x))^2 plus spatial
boundary (Dirichlet/Neumann) penalties (solver.py:1062-1074).
"""

from __future__ import annotations

from datetime import date

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ansatz import DenseNet
from ..losses.pinn import parabolic_pinn_residual
from ..parallel.mesh import constrain_batch
from ..rollout.sampling import inside_fn, sample_boundary, sample_domain
from ..rollout.sde import (StoppedRolloutConfig, stopped_rollout,
                           stopped_rollout_dk)
from ._chunk import run_training
from .elliptic import STOPPED_ROLLOUT_MODES, masked_mean
from .hjb import check_rollout_mode


class GeneralSolver:
    """Constructor kwargs mirror solver.py:936-940."""

    _LOG_ATTRS = ("loss_log", "loss_log_domain", "loss_log_boundary",
                  "V_L2_log", "V_test_L2", "V_test_abs", "V_test_rel_abs",
                  "K_log", "times", "not_all_stopped_count")

    def __init__(self, problem, name, seed=42, delta_t=0.01, N=50, lr=0.001,
                 L=100000, K=200, K_boundary=50, alpha=(1.0, 1.0, 1.0),
                 adaptive_forward_process=False, detach_forward=True,
                 print_every=100, verbose=True, approx_method="Y",
                 sample_center=False, loss_method="diffusion",
                 loss_with_stopped=False, K_test_log=None,
                 PINN_log_variance=False, log_loss_parts=False,
                 boundary_loss=True, full_hessian=False,
                 uniform_square=False, solve_linear_L2_projection=False,
                 value_net=None, remat=None, mesh=None, steps_per_call="auto",
                 rng_impl="threefry", layout="auto", rollout_mode="scan"):
        self.problem = problem
        self.name = name
        self.date = date.today().strftime("%Y-%m-%d")
        self.d = problem.d
        self.T = problem.T
        self.seed = seed
        self.delta_t = float(delta_t)
        self.N = N
        self.lr = lr
        self.L = L
        self.K = K
        self.K_boundary = K_boundary
        self.alpha = tuple(alpha)

        self.adaptive_forward_process = adaptive_forward_process
        self.detach_forward = detach_forward
        self.approx_method = approx_method
        self.sample_center = sample_center
        self.loss_method = loss_method
        self.loss_with_stopped = loss_with_stopped
        self.boundary_loss = boundary_loss
        self.PINN_log_variance = PINN_log_variance
        self.full_hessian = full_hessian
        self.uniform_square = uniform_square
        self.solve_linear_L2_projection = solve_linear_L2_projection
        self.print_every = print_every
        self.verbose = verbose
        self.log_loss_parts = log_loss_parts
        # With a mesh, the K-path ensemble axis is sharded over 'dp'
        # (constraints on the rollout start state; GSPMD turns the loss
        # means into all-reduces); params stay replicated.
        self.mesh = mesh
        self.steps_per_call = steps_per_call
        self.remat = (N > 512) if remat is None else remat

        # rng_impl / layout: see EllipticSolver (same semantics; layout
        # ='dk' runs the transposed stopped rollout with the (x, t) net
        # input assembled as columns + a t row)
        self.rng_impl = rng_impl
        self.layout = layout
        self.rollout_mode = check_rollout_mode(rollout_mode,
                                               STOPPED_ROLLOUT_MODES)
        self.resolved_rollout_mode = "scan"
        key = jax.random.PRNGKey(seed)
        k_net, self._train_key = jax.random.split(key)
        if rng_impl != "threefry":
            self._train_key = jax.random.key(seed ^ 0x5eed, impl=rng_impl)
        self.V_net = value_net if value_net is not None else DenseNet(d_out=1)
        self.params = self.V_net.init(k_net, jnp.zeros((1, self.d + 1)))
        self.tx = optax.adam(lr)
        self.opt_state = self.tx.init(self.params)

        self.K_test_log = K_test_log
        self.loss_log = []
        self.loss_log_domain = []
        self.loss_log_boundary = []
        self.V_L2_log = []
        self.V_test_L2 = []
        self.V_test_abs = []
        self.V_test_rel_abs = []
        self.K_log = []
        self.times = []
        self.not_all_stopped_count = 0
        self.step = 0

        # Coverage guard: with an unbounded geometry the terminal loss only
        # pins V(. , T) on the sampled ball; if the diffusion spread
        # sqrt(tr(sigma sigma^T) T) exceeds the sampling radius, paths end
        # OUTSIDE the pinned region and the diffusion/BSDE losses admit
        # spurious (time-flat) minimizers.  The reference's Allen-Cahn
        # notebook handles this by overriding boundary_distance to 7.0
        # (cell 1); warn users who would silently hit the failure mode.
        geom = problem.geometry
        if geom is not None and not geom.bounded and verbose:
            import numpy as _np
            mat = _np.asarray(problem.sigma_struct.mat)
            spread = float(_np.sqrt(_np.trace(mat @ mat.T) * self.T))
            radius = (geom.boundary_distance if "square" not in geom.kind
                      else abs(geom.X_r - geom.X_l) / 2)
            if spread > 1.5 * radius:
                print(f"WARNING: diffusion spread ~{spread:.1f} exceeds the "
                      f"sampling radius {radius:.1f}; terminal pinning will "
                      "not cover path endpoints — increase "
                      "geometry.boundary_distance (cf. Allen-Cahn nb "
                      "cell 1: boundary_distance = 7.0).")

    # ------------------------------------------------------------------
    def _v_xt(self, params):
        """V evaluated on concatenated (x, t) input rows."""
        return lambda XT: self.V_net.apply(params, XT)[:, 0]

    def _v_fn(self, params):
        def fn(X, t):
            XT = jnp.concatenate([X, t[:, None]], axis=-1)
            return self.V_net.apply(params, XT)[:, 0]
        return fn

    def _value_grad_fn(self):
        sig = self.problem.sigma_struct
        net = self.V_net

        def fn(params, X, t):
            def v_of_x(x):
                xt = jnp.concatenate([x, t[:, None]], axis=-1)
                return net.apply(params, xt)[:, 0]
            V, pull = jax.vjp(v_of_x, X)
            (gradX,) = pull(jnp.ones_like(V))
            return V, sig.apply_T(gradX)

        if self.solve_linear_L2_projection:
            def fn_noz(params, X, t):
                xt = jnp.concatenate([X, t[:, None]], axis=-1)
                return net.apply(params, xt)[:, 0], jnp.zeros_like(X)
            return fn_noz
        return fn

    def _value_grad_fn_T(self):
        """Column-layout variant of :meth:`_value_grad_fn` (layout='dk',
        rollout/sde.py: stopped_rollout_dk): the (x, t) net input is
        assembled as (d+1, K) columns with t as the last row and the vjp
        runs through ansatz/transposed.py, keeping the path axis as the
        minor (column) dimension."""
        from ..ansatz.transposed import transposed_apply
        sig = self.problem.sigma_struct
        net = self.V_net

        def fn(params, XT, t):
            def v_of_xT(xT):
                xtT = jnp.concatenate([xT, t[None, :]], axis=0)
                return transposed_apply(net, params, xtT)[0, :]
            V, pull = jax.vjp(v_of_xT, XT)
            (gradXT,) = pull(jnp.ones_like(V))
            return V, sig.apply_T_cols(gradXT)

        if self.solve_linear_L2_projection:
            def fn_noz(params, XT, t):
                xtT = jnp.concatenate([XT, t[None, :]], axis=0)
                return (transposed_apply(net, params, xtT)[0, :],
                        jnp.zeros_like(XT))
            return fn_noz
        return fn

    # layout='dk' resolution: same gates and fallback warning as
    # EllipticSolver (the value net here takes a d+1 input)
    from .elliptic import EllipticSolver as _Ell
    _resolve_dk = _Ell._resolve_dk
    _shard_T = _Ell._shard_T
    del _Ell

    def _rollout_cfg(self):
        lm = self.loss_method
        return StoppedRolloutConfig(
            N=self.N, delta_t=self.delta_t,
            adaptive_forward=self.adaptive_forward_process,
            detach_forward=self.detach_forward,
            recursive_y_in_h=lm in ("BSDE-2", "BSDE-4"),
            step_loss=lm if lm in ("BSDE-2", "BSDE-3") else None,
            time_stopping=True,
            no_y_update=self.solve_linear_L2_projection,
            remat=self.remat, alpha0=self.alpha[0],
        )

    def _spatial_boundary_loss(self, params, Xb, tb):
        """Dirichlet (solver.py:1067) or Neumann (solver.py:1068-1074)."""
        problem = self.problem
        v_fn = self._v_fn(params)
        if self.problem.boundary_type == "Dirichlet":
            return jnp.mean((v_fn(Xb, tb) - problem.g(Xb, tb)) ** 2)
        d = self.d
        v_of_x = lambda x: v_fn(x, tb)
        V, pull = jax.vjp(v_of_x, Xb)
        (grad_V,) = pull(jnp.ones_like(V))
        lhs = jnp.sum(grad_V * Xb, axis=-1)
        rhs = jnp.sum(problem.g(Xb, tb) * Xb, axis=-1)
        return jnp.mean((lhs - rhs) ** 2)

    def _build_step(self):
        problem = self.problem
        geom = problem.geometry
        lm = self.loss_method
        cfg = self._rollout_cfg()
        vg_fn = self._value_grad_fn()
        ins = inside_fn(geom)
        K, Kb, d = self.K, self.K_boundary, self.d
        a0, a1, a2 = self.alpha
        T = self.T
        dt = self.delta_t
        use_dk = self._resolve_dk(needs_xt=True)
        if use_dk:
            from ..rollout.sampling import inside_fn_cols
            vg_fn_T = self._value_grad_fn_T()
            ins_T = inside_fn_cols(geom)

        def loss_fn(params, key):
            kb, kbt, kd, kt, kr = jax.random.split(key, 5)
            v_fn = self._v_fn(params)
            loss = jnp.float32(0.0)
            aux = {}

            X0 = constrain_batch(
                sample_domain(kd, geom, K, d,
                              uniform_square=self.uniform_square), self.mesh)
            t0 = constrain_batch(jax.random.uniform(kt, (K,)) * T, self.mesh)

            bound_l = jnp.float32(0.0)
            if lm not in ("BSDE-4", "BSDE") and self.boundary_loss:
                # terminal condition on the first K_boundary domain points
                # (solver.py:1062-1064)
                XT_x = X0[:Kb]
                tT = jnp.full((Kb,), T)
                loss = loss + a1 * jnp.mean(
                    (v_fn(XT_x, tT) - problem.f_terminal(XT_x)) ** 2)
                if geom.bounded:
                    Xb = sample_boundary(kb, geom, Kb, d)
                    tb = jax.random.uniform(kbt, (Kb,)) * T
                    bound_l = self._spatial_boundary_loss(params, Xb, tb)
                    loss = loss + a2 * bound_l
            aux["boundary"] = bound_l

            if lm in ("BSDE-2", "BSDE-4", "BSDE", "diffusion"):
                Y0 = v_fn(X0, t0)
            else:
                Y0 = jnp.zeros((K,))
            Y0 = constrain_batch(Y0, self.mesh)

            if use_dk:
                X0T = self._shard_T(X0.T)
                out = stopped_rollout_dk(cfg, problem, vg_fn_T, params,
                                         X0T, Y0, t0, kr, ins_T)
            else:
                out = stopped_rollout(cfg, problem, vg_fn, params, X0, Y0,
                                      t0, kr, ins)
            loss = loss + out.step_loss

            if lm == "diffusion":
                loss = loss + a0 * jnp.mean((v_fn(out.X, out.t) - out.Y) ** 2)
            if lm in ("BSDE-4", "BSDE"):
                # terminal/boundary data at the stopping state
                # (solver.py:1170-1183)
                if not geom.bounded:
                    loss = loss + jnp.mean(
                        (out.Y - problem.f_terminal(out.X)) ** 2)
                elif problem.boundary_type == "Dirichlet":
                    loss = loss + jnp.mean(
                        (out.Y - problem.g(out.X, out.t)) ** 2)
                else:  # Neumann: split time-exhausted vs spatial exits
                    at_T = out.t > (T - dt)
                    loss = loss + masked_mean(
                        (out.Y - problem.f_terminal(out.X)) ** 2, at_T)
                    # raw grad_x V (NOT sigma^T grad) as in solver.py:1183
                    def v_of_x(x):
                        xt = jnp.concatenate([x, out.t[:, None]], axis=-1)
                        return self.V_net.apply(params, xt)[:, 0]
                    Ve, pull = jax.vjp(v_of_x, out.X)
                    (grad_end,) = pull(jnp.ones_like(Ve))
                    lhs = jnp.sum(grad_end * out.X, axis=-1)
                    rhs = jnp.sum(problem.g(out.X, out.t) * out.X, axis=-1)
                    loss = loss + masked_mean((lhs - rhs) ** 2, ~at_T)
            if self.loss_with_stopped:
                loss = loss + masked_mean(
                    (out.Y - problem.f_terminal(out.X)) ** 2, out.stopped)

            aux["V_L2"] = jnp.mean(out.v_l2)
            aux["K_count"] = out.active_count
            aux["all_stopped"] = jnp.all(out.stopped)
            aux["domain"] = loss - a2 * bound_l
            return loss, aux

        def step(params, opt_state, key):
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, key)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            aux["loss"] = loss
            self._add_test_metrics(params, key, aux)
            return params, opt_state, aux

        return step

    def _build_pinn_step(self):
        problem = self.problem
        geom = problem.geometry
        K, Kb, d = self.K, self.K_boundary, self.d
        a0, a1, a2 = self.alpha
        T = self.T

        def loss_fn(params, key):
            kb, kbt, kd, kt = jax.random.split(key, 4)
            v_xt = self._v_xt(params)
            v_fn = self._v_fn(params)
            X = sample_domain(kd, geom, K, d,
                              uniform_square=self.uniform_square)
            t = jax.random.uniform(kt, (K,)) * T
            resid = parabolic_pinn_residual(problem, v_xt, X, t,
                                            self.full_hessian)
            if self.PINN_log_variance:
                n = resid.shape[0]
                dom = jnp.var(resid) * n / max(n - 1, 1)
            else:
                dom = jnp.mean(resid ** 2)
            loss = a0 * dom
            bound_l = jnp.float32(0.0)
            if self.boundary_loss:
                tT = jnp.full((Kb,), T)
                loss = loss + a1 * jnp.mean(
                    (v_fn(X[:Kb], tT) - problem.f_terminal(X[:Kb])) ** 2)
                if geom.bounded:
                    Xb = sample_boundary(kb, geom, Kb, d)
                    tb = jax.random.uniform(kbt, (Kb,)) * T
                    bound_l = self._spatial_boundary_loss(params, Xb, tb)
                    loss = loss + a2 * bound_l
            aux = {"boundary": bound_l, "domain": dom,
                   "V_L2": jnp.float32(0.0), "K_count": jnp.float32(K),
                   "all_stopped": jnp.bool_(True)}
            return loss, aux

        def step(params, opt_state, key):
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, key)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            aux["loss"] = loss
            self._add_test_metrics(params, key, aux)
            return params, opt_state, aux

        return step

    def _add_test_metrics(self, params, key, aux):
        """Fresh-sample test error, computed inside the jitted step (one
        dispatch per iteration instead of two)."""
        if self.K_test_log is None:
            return
        from ..eval.test_error import compute_test_error
        net = self.V_net
        v_fn = lambda XT: net.apply(params, XT)[:, 0]
        L2, mae, mre = compute_test_error(
            v_fn, self.problem, self.K_test_log,
            jax.random.fold_in(key, 7), modus="parabolic")
        aux["test_L2"], aux["test_abs"], aux["test_rel_abs"] = L2, mae, mre

    # ------------------------------------------------------------------

    # -- persistence (mirrors solver.py:313-332) --------------------------
    def save_networks(self, out_dir="output"):
        import os
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

    def _record(self, aux):
        """Append one iteration's metrics to the reference-name logs."""
        self.loss_log.append(float(aux["loss"]))
        self.V_L2_log.append(float(aux["V_L2"]))
        self.K_log.append(float(aux["K_count"]))
        if not bool(aux["all_stopped"]) and self.loss_method in (
                "BSDE", "BSDE-4"):
            self.not_all_stopped_count += 1
        if self.log_loss_parts:
            self.loss_log_domain.append(float(aux["domain"]))
            self.loss_log_boundary.append(float(aux["boundary"]))
        if self.K_test_log is not None:
            self.V_test_L2.append(float(aux["test_L2"]))
            self.V_test_abs.append(float(aux["test_abs"]))
            self.V_test_rel_abs.append(float(aux["test_rel_abs"]))

    def _maybe_print(self, done, n):
        first = done - n
        if self.verbose and (first == 0 or first // self.print_every
                             != done // self.print_every):
            print("%d - loss = %.4e, v L2 error = %.4e, %.2f"
                  % (done - 1, self.loss_log[-1], self.V_L2_log[-1],
                     np.mean(self.times[-self.print_every:])))

    def train(self):
        run_training(self, self._build_pinn_step()
                     if self.loss_method == "PINN" else self._build_step())
