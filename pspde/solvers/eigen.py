"""Eigenvalue solver: elliptic-diffusion loop with a learnable eigenvalue.

First-class rebuild of the inline training loops of
"Eigenvalue - Fokker-Planck.ipynb" (cell 4) and
"Eigenvalue - nonlinear Schroedinger equation, d = 5/10.ipynb" (cell 7):

  * the Y recursion carries an extra ``- lambda * V`` term (the learnable
    eigenvalue, a ScalarParam like the notebooks' ``SingleParam``),
  * periodic boundary conditions on [X_l, X_r]^d are enforced by value AND
    gradient matching between opposite faces,
  * the domain loss is ``mean((V(X_end) - V(X_0) - Y)^2)``,
  * degenerate solutions are excluded either by center pinning against the
    known normalization (FP mode) or by an L2-normalization penalty
    ``(E[V^2] - 1)^2`` plus a "hat function" barrier around V = 0
    (Schroedinger mode, notebook cells 2 and 7).
"""

from __future__ import annotations

from datetime import date

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ansatz import DenseNet, ScalarParam
from ..parallel.mesh import constrain_batch
from ..rollout.sampling import (inside_fn, sample_boundary_reflected,
                                sample_domain)
from ..rollout.sde import StoppedRolloutConfig, stopped_rollout
from ._chunk import run_training
from .elliptic import STOPPED_ROLLOUT_MODES
from .hjb import DK_MIN_PATHS, check_rollout_mode


def hat_function(x):
    """exp(-200 x^2) on (-0.2, 0.2) — barrier pushing E[V^2] away from 0
    (Schroedinger notebook cell 2)."""
    return jnp.exp(-200.0 * x ** 2) * ((x > -0.2) & (x < 0.2))


class _LambdaShiftedProblem:
    """Problem shim adding the eigenvalue term: h_eff = h + lambda * y, so
    the rollout's -h_eff matches the notebooks' (-h - lambda V)."""

    def __init__(self, problem, lam):
        self._p = problem
        self._lam = lam
        self.T = None  # elliptic h signature
        self.sigma_struct = problem.sigma_struct
        # forward the transposed-coefficient protocol (base.py) so the
        # dk stopped rollout can run the eigen domain leg in (d, K) layout
        if getattr(problem, "supports_transposed", False):
            self.b_T = problem.b_T
            self.h_T = lambda xT, y, zT: problem.h_T(xT, y, zT) + lam * y

    @property
    def supports_transposed(self):
        return getattr(self._p, "supports_transposed", False)

    def b(self, x):
        return self._p.b(x)

    def h(self, x, y, z):
        return self._p.h(x, y, z) + self._lam * y


class EigenSolver:
    """normalization: 'center' (FP notebook: pin V at X_0 to the known
    eigenfunction value) or 'l2_penalty' (Schroedinger notebooks:
    (E[V^2]-1)^2 penalty + hat barrier)."""

    _LOG_ATTRS = ("loss_log", "loss_log_boundary",
                  "loss_log_derivative_boundary", "loss_log_domain",
                  "loss_log_center", "V_L2_log", "lambda_log", "times")

    def __init__(self, problem, name, seed=42, delta_t=1e-3, N=20, lr=0.001,
                 lr_lambda=None, lambda_init=0.5, L=100000, K=500,
                 K_boundary=50, alpha=(50.0, 1.0),
                 normalization="center", norm_penalty_weight=0.01,
                 hat_weight=1.0, adaptive_forward_process=False,
                 detach_forward=True, print_every=100, verbose=True,
                 value_net=None, remat=None, mesh=None, steps_per_call="auto",
                 rng_impl="threefry", layout="auto", rollout_mode="scan"):
        self.problem = problem
        self.name = name
        self.date = date.today().strftime("%Y-%m-%d")
        self.d = problem.d
        self.seed = seed
        self.delta_t = float(delta_t)
        self.N = N
        self.lr = lr
        self.lr_lambda = lr if lr_lambda is None else lr_lambda
        self.L = L
        self.K = K
        self.K_boundary = K_boundary
        self.alpha = tuple(alpha)
        self.normalization = normalization
        self.norm_penalty_weight = norm_penalty_weight
        self.hat_weight = hat_weight
        self.adaptive_forward_process = adaptive_forward_process
        self.detach_forward = detach_forward
        self.print_every = print_every
        self.verbose = verbose
        # With a mesh, the K-path ensemble axis is sharded over 'dp'.
        self.mesh = mesh
        self.steps_per_call = steps_per_call
        self.remat = (N > 512) if remat is None else remat

        # rng_impl='rbg' / layout='dk': the same stopped-rollout perf
        # levers as EllipticSolver (cf. elliptic.py; resolved_layout
        # records the engine, explicit dk warns on fallback)
        self.rng_impl = rng_impl
        self.layout = layout
        self.rollout_mode = check_rollout_mode(rollout_mode,
                                               STOPPED_ROLLOUT_MODES)
        self.resolved_rollout_mode = "scan"
        key = jax.random.PRNGKey(seed)
        k_net, k_lam, self._train_key = jax.random.split(key, 3)
        if rng_impl != "threefry":
            self._train_key = jax.random.key(seed ^ 0x5eed, impl=rng_impl)
        if value_net is None:
            # FP notebook cell 1: DenseNet with relu output clamp
            value_net = DenseNet(d_out=1, arch=(10, 10, 10, 10),
                                 bias_init_value=0.8, output_relu=True)
        self.V_net = value_net
        self.lam_net = ScalarParam(initial=float(lambda_init))
        self.params = {
            "V": self.V_net.init(k_net, jnp.zeros((1, self.d))),
            "lam": self.lam_net.init(k_lam, jnp.zeros((1, 1))),
        }
        if self.lr_lambda != self.lr:
            self.tx = optax.multi_transform(
                {"V": optax.adam(self.lr), "lam": optax.adam(self.lr_lambda)},
                {"V": "V", "lam": "lam"})
        else:
            self.tx = optax.adam(self.lr)
        self.opt_state = self.tx.init(self.params)

        self.loss_log = []
        self.loss_log_boundary = []
        self.loss_log_derivative_boundary = []
        self.loss_log_domain = []
        self.loss_log_center = []
        self.V_L2_log = []
        self.lambda_log = []
        self.times = []
        self.step = 0

    # ------------------------------------------------------------------
    def _v_fn(self, params):
        return lambda X: self.V_net.apply(params["V"], X)[:, 0]

    from .elliptic import EllipticSolver as _Ell
    _shard_T = _Ell._shard_T
    del _Ell

    def lam(self, params=None):
        params = self.params if params is None else params
        return self.lam_net.apply(params["lam"], jnp.zeros((1, 1)))[0]

    def _build_step(self):
        problem = self.problem
        geom = problem.geometry
        K, Kb, d = self.K, self.K_boundary, self.d
        a0, a1 = self.alpha
        sig = problem.sigma_struct
        ins = inside_fn(geom)
        net = self.V_net
        cfg = StoppedRolloutConfig(
            N=self.N, delta_t=self.delta_t,
            adaptive_forward=self.adaptive_forward_process,
            detach_forward=self.detach_forward, remat=self.remat)
        # layout='auto' (default): dk at K >= DK_MIN_PATHS (cf.
        # EllipticSolver._resolve_dk)
        want_dk = (self.layout == "dk"
                   or (self.layout == "auto" and self.K >= DK_MIN_PATHS))
        use_dk = (want_dk
                  and getattr(problem, "supports_transposed", False))
        if use_dk:
            from ..ansatz.transposed import transposed_apply
            try:
                jax.eval_shape(lambda p: transposed_apply(
                    net, p, jnp.zeros((d, 4))), self.params["V"])
            except NotImplementedError:
                use_dk = False
        self.resolved_layout = "dk" if use_dk else "kd"
        if self.layout == "dk" and not use_dk:
            import warnings
            warnings.warn(
                "EigenSolver layout='dk' fell back to 'kd' (needs the "
                "problem's transposed protocol and a transposed-apply-"
                "capable value net)", stacklevel=2)
        if use_dk:
            from ..ansatz.transposed import transposed_apply
            from ..rollout.sampling import inside_fn_cols
            from ..rollout.sde import stopped_rollout_dk
            ins_T = inside_fn_cols(geom)

        def loss_fn(params, key):
            kb, kd, kr, kn = jax.random.split(key, 4)
            v_fn = self._v_fn(params)
            lam = self.lam(params)
            aux = {"lambda": lam}
            loss = jnp.float32(0.0)

            if self.normalization == "center":
                Xc = problem.X_0[None, :]
                center_l = jnp.mean((v_fn(Xc) - problem.v_ref(Xc)) ** 2)
                loss = loss + center_l
            else:
                X2 = constrain_batch(sample_domain(kn, geom, K, d),
                                     self.mesh)
                m2 = jnp.mean(v_fn(X2) ** 2)
                loss = loss + self.hat_weight * hat_function(m2)
                center_l = self.norm_penalty_weight * (m2 - 1.0) ** 2
                loss = loss + center_l
            aux["center"] = center_l

            # periodic BCs: value + gradient matching on opposite faces
            Xb, Xb_r = sample_boundary_reflected(kb, geom, Kb, d)
            bound_l = jnp.mean((v_fn(Xb) - v_fn(Xb_r)) ** 2)
            loss = loss + a1 * bound_l
            aux["boundary"] = bound_l
            gb, pull = jax.vjp(v_fn, Xb)
            (grad_b,) = pull(jnp.ones_like(gb))
            gr, pull_r = jax.vjp(v_fn, Xb_r)
            (grad_r,) = pull_r(jnp.ones_like(gr))
            dbound_l = jnp.mean((grad_b - grad_r) ** 2)
            loss = loss + a1 * dbound_l
            aux["dboundary"] = dbound_l

            X0 = constrain_batch(sample_domain(kd, geom, K, d), self.mesh)
            phi_0 = v_fn(X0)

            shifted = _LambdaShiftedProblem(problem, lam)

            def vg_fn(p, X, t):
                v_of_x = lambda x: net.apply(p["V"], x)[:, 0]
                V, pull = jax.vjp(v_of_x, X)
                (gradX,) = pull(jnp.ones_like(V))
                return V, sig.apply_T(gradX)

            if use_dk:
                def vg_fn_T(p, XT, t):
                    v_of_xT = lambda xT: transposed_apply(
                        net, p["V"], xT)[0, :]
                    V, pull = jax.vjp(v_of_xT, XT)
                    (gradXT,) = pull(jnp.ones_like(V))
                    return V, sig.apply_T_cols(gradXT)

                X0T = self._shard_T(X0.T)
                out = stopped_rollout_dk(
                    cfg, shifted, vg_fn_T, params, X0T,
                    jnp.zeros((K,)), jnp.zeros((K,)), kr, ins_T,
                    v_ref_T=getattr(problem, "v_ref_T", None))
            else:
                out = stopped_rollout(cfg, shifted, vg_fn, params, X0,
                                      jnp.zeros((K,)), jnp.zeros((K,)),
                                      kr, ins,
                                      v_ref=getattr(problem, "v_ref",
                                                    None))
            dom_l = jnp.mean((v_fn(out.X) - phi_0 - out.Y) ** 2)
            loss = loss + a0 * dom_l
            aux["domain"] = dom_l
            aux["V_L2"] = jnp.mean(out.v_l2)
            return loss, aux

        def step(params, opt_state, key):
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, key)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            aux["loss"] = loss
            return params, opt_state, aux

        return step

    # ------------------------------------------------------------------
    # -- eigenvalue readouts beyond the last iterate ------------------------
    # The notebooks read lambda off the final training iterate — the
    # noisiest possible readout of an oscillating trace (the FP notebook's
    # own lambda trace wanders in a ~+/-7e-3 band).  Two robust readouts:

    def lambda_tail_mean(self, window=None):
        """Tail-window average of ``lambda_log`` (default: last 10% of the
        trace).  Averages out the Adam-equilibrium oscillation of the
        per-iterate lambda."""
        if not self.lambda_log:
            return None
        w = int(window) if window else max(1, len(self.lambda_log) // 10)
        return float(np.mean(self.lambda_log[-w:]))

    def _rollout_pieces(self, delta_t=None):
        """(vg_fn, cfg, ins) for fresh-sample rollouts at the solver config.

        ``delta_t`` overrides the step size (N is rescaled to keep the
        horizon N * delta_t fixed) — used by the Richardson readout."""
        sig = self.problem.sigma_struct
        net = self.V_net
        if delta_t is None:
            N, dt = self.N, self.delta_t
        else:
            dt = float(delta_t)
            N = max(1, int(round(self.N * self.delta_t / dt)))
        cfg = StoppedRolloutConfig(
            N=N, delta_t=dt,
            adaptive_forward=self.adaptive_forward_process,
            detach_forward=self.detach_forward, remat=self.remat)

        def vg_fn(p, X, t):
            v_of_x = lambda x: net.apply(p["V"], x)[:, 0]
            V, pull = jax.vjp(v_of_x, X)
            (gradX,) = pull(jnp.ones_like(V))
            return V, sig.apply_T(gradX)

        return vg_fn, cfg, inside_fn(self.problem.geometry)

    def estimate_lambda(self, K=4096, n_batches=16, key=None,
                        delta_t=None):
        """Regression (Rayleigh-quotient-type) eigenvalue estimate at the
        FROZEN trained eigenfunction V.

        ``delta_t`` overrides the rollout step size (horizon preserved) —
        the readout carries a discretization bias dominated by the
        O(sqrt(delta_t)) boundary-stopping overshoot, which
        :meth:`estimate_lambda_richardson` cancels.

        The rollout's Y is affine in lambda at fixed V (the eigenvalue
        enters only through h_eff = h + lambda*V with V independent of
        lambda), so Y(lambda) = Y(0) - lambda*S with S = int V dt along
        the stopped path, obtained exactly as Y(0) - Y(1) from two
        same-noise rollouts.  The least-squares lambda minimizing
        E[(V(X_end) - V(X_0) - Y(lambda))^2] — the solver's own domain
        loss (notebook cell 2) — is then the 1-d regression

            lambda_hat = -sum(r*S) / sum(S*S),  r = V(X_end)-V(X_0)-Y(0),

        a readout decoupled from the joint (V, lambda) Adam equilibrium.
        Returns ``(lambda_hat, stderr)`` with a jackknife-free batch-split
        error bar.  Ref: Eigenvalue - Fokker-Planck.ipynb cell 2 (domain
        loss), VERDICT round-2 item 2."""
        problem = self.problem
        geom = problem.geometry
        d = self.d
        vg_fn, cfg, ins = self._rollout_pieces(delta_t=delta_t)
        v_net = self.V_net

        @jax.jit
        def batch_stats(params, bkey):
            kd, kr = jax.random.split(bkey)
            X0 = sample_domain(kd, geom, K, d)
            v_fn = lambda x: v_net.apply(params["V"], x)[:, 0]
            phi0 = v_fn(X0)
            Ys = []
            for lam_val in (0.0, 1.0):
                shifted = _LambdaShiftedProblem(problem,
                                                jnp.float32(lam_val))
                out = stopped_rollout(cfg, shifted, vg_fn, params, X0,
                                      jnp.zeros((K,)), jnp.zeros((K,)),
                                      kr, ins)
                Ys.append((out.X, out.Y))
            (X_end, Y0_), (_, Y1_) = Ys
            S = Y0_ - Y1_
            r = v_fn(X_end) - phi0 - Y0_
            return jnp.sum(r * S), jnp.sum(S * S)

        if key is None:
            key = jax.random.fold_in(self._train_key, 0x1a)
        rs_tot, ss_tot, per_batch = 0.0, 0.0, []
        for i in range(n_batches):
            rs, ss = jax.device_get(
                batch_stats(self.params, jax.random.fold_in(key, i)))
            rs_tot += float(rs)
            ss_tot += float(ss)
            per_batch.append(-float(rs) / max(float(ss), 1e-30))
        lam_hat = -rs_tot / max(ss_tot, 1e-30)
        stderr = float(np.std(per_batch) / np.sqrt(max(len(per_batch), 1)))
        return lam_hat, stderr

    def estimate_lambda_richardson(self, K=4096, n_batches=16, key=None,
                                   refine=4.0, order=0.5):
        """Richardson dt-extrapolated eigenvalue readout at frozen V.

        :meth:`estimate_lambda`'s discretization bias is dominated by
        the discrete boundary-stopping overshoot of the stopped rollout,
        which is O(sqrt(dt)) (Broadie-Glasserman-Kou), NOT the Euler
        weak order O(dt) — measured at frozen V = v_true on FP d=2 with
        the horizon held fixed: lambda(dt) falls 2.28e-3 -> 0.31e-3 over
        dt 1.6e-2 -> 1e-3, tracking sqrt(dt), i.e. the "dt floor" a
        single-dt readout cannot cross.  Two readouts at dt and
        dt/refine cancel the leading dt^order term (s = refine^order):

            lambda_R = (s * lambda(dt/refine) - lambda(dt)) / (s - 1)

        ``order=0.5`` (default) targets the stopping bias; use
        ``order=1.0`` for geometries where no path ever stops early.
        Returns ``(lambda_R, stderr)`` with the error bars of the two
        (independent-noise) readouts propagated through the
        extrapolation.  No reference counterpart — the notebooks read
        the last training iterate only.  Ref:
        Eigenvalue - Fokker-Planck.ipynb cell 4 readout semantics."""
        if key is None:
            key = jax.random.fold_in(self._train_key, 0x1b)
        k1, k2 = jax.random.split(key)
        s = float(refine) ** float(order)
        lam_c, se_c = self.estimate_lambda(K=K, n_batches=n_batches,
                                           key=k1)
        lam_f, se_f = self.estimate_lambda(
            K=K, n_batches=n_batches, key=k2,
            delta_t=self.delta_t / float(refine))
        lam_R = (s * lam_f - lam_c) / (s - 1.0)
        se_R = float(np.hypot(s * se_f, se_c) / (s - 1.0))
        return lam_R, se_R

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
        self.loss_log.append(float(aux["loss"]))
        self.loss_log_center.append(float(aux["center"]))
        self.loss_log_boundary.append(float(aux["boundary"]))
        self.loss_log_derivative_boundary.append(float(aux["dboundary"]))
        self.loss_log_domain.append(float(aux["domain"]))
        self.V_L2_log.append(float(aux["V_L2"]))
        self.lambda_log.append(float(aux["lambda"]))

    def _maybe_print(self, done, n):
        first = done - n
        if self.verbose and (first == 0 or first // self.print_every
                             != done // self.print_every):
            print("%d - loss = %.4e, v L2 error = %.4e, "
                  "lambda = %.4e, %.2f"
                  % (done - 1, self.loss_log[-1], self.V_L2_log[-1],
                     self.lambda_log[-1],
                     np.mean(self.times[-self.print_every:])))

    def train(self):
        run_training(self, self._build_step())
