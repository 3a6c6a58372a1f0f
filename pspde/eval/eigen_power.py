"""Feynman-Kac semigroup power iteration for generator eigenproblems.

The FP eigenvalue problem (Eigenvalue - Fokker-Planck.ipynb cell 2;
pspde.problems.FokkerPlanckEigen + EigenSolver) solves A V = -lambda V
for A = L + W, where L is the diffusion generator and the potential W
enters through the linear-in-y running term h(x, y, .) = y * W(x)
(tests/test_problems.py: L v + h(x, v) = -lambda v on v_ref).  The
semigroup of A has the Feynman-Kac representation

    (e^{T A} f)(x) = E[ f(X_T) * exp(+int_0^T W(X_s) ds) ],
    dX = b dt + sigma dW,

and the eigenpair (V, -lambda) with POSITIVE eigenfunction is dominant
(Perron-Frobenius), so the power iteration

    V  <-  normalize( e^{T A} V )

contracts every other eigencomponent by e^{-(lambda_0 - lambda_1) T}
per stage.  Joint-training Adam equilibria plateau with an O(1e-4)
eigenfunction error and an O(1e-2) induced lambda bias (the
round-2/3 FP numbers); a few semigroup stages push V to the MC/
regression floor and the frozen-V lambda regression
(EigenSolver.estimate_lambda) then reads the eigenvalue at that floor.

Periodicity: the FP problem's coefficients are 2*pi-periodic, so paths
are WRAPPED into the fundamental box each step — exact for the
dynamics, and it keeps net evaluations inside the training domain.

No reference counterpart: the notebook's only readout is the last
training iterate of its SingleParam lambda.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax


def fk_semigroup_targets(problem, v_fn, Xs, K_inner, T_horizon, delta_t,
                         key, W_of=None):
    """Per-anchor MC estimate of (e^{T A} V)(x_i).

    By default requires h linear in y (W(x) = problem.h(x, 1, None));
    ``W_of`` overrides the potential — e.g. the self-consistent-field
    linearization W_eff = h(x, V(x), .)/V(x) of a cubic nonlinearity
    (see eigen_power_refine's scf mode).  Geometry must be a 'square'
    periodic box (paths wrapped into [X_l, X_r]^d)."""
    M, d = Xs.shape
    geom = problem.geometry
    lo, hi = geom.X_l, geom.X_r
    width = hi - lo
    dt = jnp.float32(delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct
    N = int(np.round(T_horizon / delta_t))

    X0 = jnp.repeat(Xs, K_inner, axis=0)
    R = X0.shape[0]

    if W_of is None:
        def W_of(X):
            return problem.h(X, jnp.ones((X.shape[0],), X.dtype), None)

    def step(carry, n):
        X, logw = carry
        logw = logw + W_of(X) * dt
        xi = jax.random.normal(jax.random.fold_in(key, n), (R, d))
        X = X + problem.b(X) * dt + sig.apply(xi) * sq_dt
        X = lo + jnp.mod(X - lo, width)
        return (X, logw), None

    (X, logw), _ = lax.scan(step, (X0, jnp.zeros((R,))), jnp.arange(N))
    vals = v_fn(X) * jnp.exp(logw)
    return jnp.mean(vals.reshape(M, K_inner), axis=1)


def eigen_power_refine(
    problem,
    net,                       # ansatz module V(x); params as net.init(...)
    params,
    n_stages: int = 3,
    T_horizon: float = 1.0,
    M: int = 4096,
    K_inner: int = 128,
    delta_t: float = 2e-3,
    reg_steps: int = 4000,
    reg_lr: float = 1e-3,
    K_center: int = 65536,
    key: Optional[jax.Array] = None,
    verbose: bool = False,
    mode: str = "linear",          # 'linear' | 'scf'
    normalization: str = "center",  # 'center' | 'l2'
):
    """Run ``n_stages`` Feynman-Kac power-iteration stages on a trained
    eigenfunction net.

    Each stage: anchors uniform in the periodic box, semigroup targets
    with the CURRENT net, normalization by pinning the center value to
    ``problem.v_ref(X_0)`` (the solver's 'center' normalization), then a
    supervised refit.  Per-stage the growth factor at the center gives a
    crude lambda estimate log(ratio)/T; the definitive readout is
    ``EigenSolver.estimate_lambda`` on the refined params.

    ``mode='scf'`` handles h nonlinear in y by the self-consistent-field
    linearization: each stage freezes the effective potential
    W_eff(x) = h(x, V(x), .) / V(x) at the CURRENT model (Gross-
    Pitaevskii-style ground-state iteration; requires V > 0, clipped
    at 1e-3).  ``normalization='l2'`` rescales so the box-uniform
    E[V^2] = 1 (the Schroedinger notebooks' constraint) instead of
    pinning the center value.

    Returns ``(params_final, history)``; history rows carry
    (lambda_growth, reg_loss)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    d = problem.d
    geom = problem.geometry
    lo, hi = geom.X_l, geom.X_r
    center = problem.X_0[None, :]
    v_center_true = (float(problem.v_ref(center)[0])
                     if normalization == "center" else None)

    def v_of(p):
        return lambda X: net.apply(p, X)[:, 0]

    def W_for(p):
        if mode == "linear":
            return None
        v_fn = v_of(p)

        def W_of(X):
            v = jnp.maximum(v_fn(X), 1e-3)
            return problem.h(X, v, None) / v

        return W_of

    targets_jit = jax.jit(lambda p, Xs, k, KI: fk_semigroup_targets(
        problem, v_of(p), Xs, KI, T_horizon, delta_t, k, W_of=W_for(p)),
        static_argnums=(3,))

    @jax.jit
    def reg_fit(p, Xs, targets):
        def loss(p):
            pred = net.apply(p, Xs)[:, 0]
            return jnp.mean((pred - targets) ** 2)

        tx_opt = optax.adam(reg_lr)
        state = tx_opt.init(p)

        def body(carry, _):
            p, state = carry
            l, g = jax.value_and_grad(loss)(p)
            up, state = tx_opt.update(g, state, p)
            return (optax.apply_updates(p, up), state), l

        (p, _), ls = lax.scan(body, (p, state), None, length=reg_steps)
        return p, ls[-1]

    p = params
    history = []
    for stage in range(n_stages):
        key, ka, kr, kc = jax.random.split(key, 4)
        Xs = lo + (hi - lo) * jax.random.uniform(ka, (M, d))
        targets = targets_jit(p, Xs, kr, K_inner)
        if normalization == "center":
            t_norm = targets_jit(p, center, kc, K_center)[0]
            v_norm_now = v_of(p)(center)[0]
            scale = v_center_true / t_norm
        else:
            # box-uniform L2 normalization E[V^2] = 1 from the anchors
            t_norm = jnp.sqrt(jnp.mean(targets ** 2))
            v_norm_now = jnp.sqrt(jnp.mean(v_of(p)(Xs) ** 2))
            scale = 1.0 / t_norm
        # growth under e^{TA}: e^{-lambda T} to leading order once V is
        # near the eigenfunction
        lam_growth = float(-jnp.log(t_norm / v_norm_now) / T_horizon)
        p, reg_loss = reg_fit(p, Xs, targets * scale)
        rec = {"lambda_growth": lam_growth,
               "reg_loss": float(reg_loss)}
        history.append(rec)
        if verbose:
            print(f"  power stage {stage}: lambda_growth "
                  f"{lam_growth:+.2e}, reg_loss {rec['reg_loss']:.3e}")
    return p, history


def eigen_subspace_refine(
    problem,
    net,
    params_list,               # one params pytree per eigenfunction
    n_stages: int = 3,
    T_horizon: float = 0.5,
    M: int = 4096,
    K_inner: int = 64,
    delta_t: float = 2e-3,
    reg_steps: int = 2000,
    reg_lr: float = 1e-3,
    key: Optional[jax.Array] = None,
    verbose: bool = False,
):
    """Block (subspace) Feynman-Kac power iteration: top-n eigenpairs.

    Extends :func:`eigen_power_refine` from the dominant eigenpair to the
    leading ``n = len(params_list)`` eigenpairs of A = L + W — in
    particular the SPECTRAL GAP lambda_1 - lambda_0, the quantity that
    controls metastable relaxation rates.  Each stage applies the
    semigroup e^{T A} to every basis function by Feynman-Kac Monte Carlo,
    then performs a Rayleigh-Ritz extraction on the subspace: with
    S_ij = <v_i, v_j> and H_ij = <v_i, e^{TA} v_j> estimated over M
    uniform anchors (the box-uniform L2 inner product), the Ritz problem
    S^{-1} H c = theta c yields theta_k ~ e^{-lambda_k T} and rotated
    images U = [e^{TA}v_j] C that the nets are refit to.  Rayleigh-Ritz
    on a (near-)invariant subspace is exact regardless of self-adjointness,
    so no adjoint eigenfunction is needed for the deflation.

    Requirements: h linear in y (the potential is W(x) = h(x, 1, .)) and a
    periodic 'square' geometry (fk_semigroup_targets wraps paths).
    Near-degenerate eigenvalues (e.g. the sin/cos pair on the torus) are
    handled naturally — the Ritz VALUES converge at rate
    e^{-(lambda_n - lambda_{k}) T} even when individual eigenVECTORS inside
    a degenerate cluster cannot be separated.

    Validated against the dense FD oracle
    :func:`pspde.problems.fd_oracles.generator_spectrum_periodic_1d`
    (tests/test_eigen_solver.py).  No reference counterpart: the
    notebooks' eigensolvers read only the dominant eigenvalue from the
    trained SingleParam (Eigenvalue - Fokker-Planck.ipynb cell 4).

    Returns ``(params_list_final, history)``; each history row carries
    ``lambdas`` (Ritz readouts, ascending) and per-net ``reg_loss``.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n_pairs = len(params_list)
    d = problem.d
    geom = problem.geometry
    lo, hi = geom.X_l, geom.X_r

    def v_of(p):
        return lambda X: net.apply(p, X)[:, 0]

    targets_jit = jax.jit(lambda p, Xs, k: fk_semigroup_targets(
        problem, v_of(p), Xs, K_inner, T_horizon, delta_t, k))

    @jax.jit
    def reg_fit(p, Xs, targets):
        def loss(p):
            pred = net.apply(p, Xs)[:, 0]
            return jnp.mean((pred - targets) ** 2)

        tx_opt = optax.adam(reg_lr)
        state = tx_opt.init(p)

        def body(carry, _):
            p, state = carry
            l, g = jax.value_and_grad(loss)(p)
            up, state = tx_opt.update(g, state, p)
            return (optax.apply_updates(p, up), state), l

        (p, _), ls = lax.scan(body, (p, state), None, length=reg_steps)
        return p, ls[-1]

    ps = list(params_list)
    history = []
    for stage in range(n_stages):
        key, ka, *kts = jax.random.split(key, 2 + n_pairs)
        Xs = lo + (hi - lo) * jax.random.uniform(ka, (M, d))
        Vm = jnp.stack([v_of(p)(Xs) for p in ps], axis=1)          # (M, n)
        Tm = jnp.stack([targets_jit(p, Xs, kt)
                        for p, kt in zip(ps, kts)], axis=1)        # (M, n)
        S = np.asarray(Vm.T @ Vm, dtype=np.float64) / M
        H = np.asarray(Vm.T @ Tm, dtype=np.float64) / M
        theta, C = np.linalg.eig(np.linalg.solve(S, H))
        order = np.argsort(-theta.real)
        theta = theta.real[order]
        C = C[:, order].real
        lams = (-np.log(np.maximum(theta, 1e-12)) / T_horizon).tolist()
        # rotate the semigroup images onto the Ritz directions (this IS
        # the power step), normalize to unit anchor-RMS, keep signs
        # aligned with the current nets so the refit is a small move
        U = Tm @ jnp.asarray(C, Tm.dtype)
        U = U / jnp.sqrt(jnp.mean(U ** 2, axis=0, keepdims=True))
        sgn = jnp.sign(jnp.sum(U * Vm, axis=0))
        U = U * jnp.where(sgn == 0, 1.0, sgn)
        reg_losses = []
        new_ps = []
        for j in range(n_pairs):
            pj, rl = reg_fit(ps[j], Xs, U[:, j])
            new_ps.append(pj)
            reg_losses.append(float(rl))
        ps = new_ps
        history.append({"lambdas": lams, "reg_loss": reg_losses})
        if verbose:
            print(f"  subspace stage {stage}: lambdas "
                  + ", ".join(f"{l:+.4f}" for l in lams)
                  + f", reg_loss {max(reg_losses):.3e}")
    return ps, history
