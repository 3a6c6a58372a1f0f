"""Multi-stage Picard refinement of a learned parabolic value function.

Iterates the Feynman-Kac fixed point  v(t, x) = E[f(X_T) + int_t^T
h(s, X_s, v(s, X_s), .) ds]  (the GeneralSolver family's PDE,
solver.py:1062-1183 conventions) AROUND a trained model:

  stage:  targets_i = MC estimate of the right-hand side at anchor
          points (t_i, x_i) with the CURRENT model inside h;
          fit the model to the targets (supervised regression);

each stage contracts the model's systematic error by ~ (T - t) *
sup|dh/dy| (classical Picard iteration; ~0.3x per stage for Allen-Cahn
on [0, 0.3]), while the per-anchor MC noise (K_inner paths) is averaged
away by the regression over M anchors.  Two to three stages push a
~3%-accurate trained model to sub-1% pointwise accuracy; a stage costs
M * K_inner * N path-steps, vectorized as one flat ensemble with
per-anchor time gating.

No counterpart exists in the reference; this composes its diffusion-loss
training output with the framework's rollout engine as an a-posteriori
corrector.  See also eval/refine.py (the single-point, single-stage
variant).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax


def _mc_targets(problem, v_fn, ts, Xs, K_inner, delta_t, key):
    """MC estimate of E[f(X_T) + int h ds] from each anchor (ts_i, Xs_i).

    All anchors are integrated as one flat (M*K_inner, d) ensemble for a
    fixed N_max = ceil(T/dt) steps; a per-row gate freezes rows whose
    remaining horizon T - t_i is exhausted (same masking algebra as the
    general solver's time stopping, rollout/sde.py: stopped_rollout).

    Restriction (cf. refine.py's unbounded-geometry assert): ``problem.h``
    is called with a PER-ROW time vector t (K,) — not the scalar t of the
    solver protocol (base.py) — and with z = None, so h must broadcast
    over batched t and must not use z (true for the Heat/Allen-Cahn family
    this corrector targets; a |z|^2-nonlinear problem like
    QuadraticGradient is unsupported here)."""
    M, d = Xs.shape
    T = problem.T
    dt = jnp.float32(delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct
    N_max = int(np.ceil(T / delta_t))

    X0 = jnp.repeat(Xs, K_inner, axis=0)              # (M*K, d)
    t0 = jnp.repeat(ts, K_inner)                      # (M*K,)
    R = X0.shape[0]

    def step(carry, n):
        X, t, acc = carry
        active = (t + 0.5 * dt) < T
        h = problem.h(t, X, v_fn(X, t), None)
        acc = acc + jnp.where(active, h, 0.0) * dt
        xi = jax.random.normal(jax.random.fold_in(key, n), (R, d))
        drift = problem.b(X) * dt + sig.apply(xi) * sq_dt
        X = jnp.where(active[:, None], X + drift, X)
        t = jnp.where(active, t + dt, t)
        return (X, t, acc), None

    (X, t, acc), _ = lax.scan(
        step, (X0, t0, jnp.zeros((R,))), jnp.arange(N_max))
    vals = problem.f_terminal(X) + acc                # (M*K,)
    return jnp.mean(vals.reshape(M, K_inner), axis=1)


def picard_refine(
    problem,
    net,                       # ansatz module: (x, t) input as [x, t] concat
    params,                    # trained params for `net`
    x0: Optional[jnp.ndarray] = None,   # (d,) final evaluation point
    n_stages: int = 2,
    M: int = 4096,
    K_inner: int = 1024,
    delta_t: float = 1e-3,
    anchor_radius: Optional[float] = None,  # default: diffusion spread
    reg_steps: int = 3000,
    reg_lr: float = 1e-3,
    key: Optional[jax.Array] = None,
    readout_K: int = 1_000_000,
    verbose: bool = False,
    anchors: str = "tube",
):
    """Run `n_stages` Picard stages, then a high-K pointwise readout.

    With ``anchors='tube'`` (default) the anchors are drawn from the
    diffusion tube of x0: t ~ U(0, T), x ~ x0 + sqrt(tr(sigma sigma^T)/d
    * t) * z (z standard normal), matching the measure the final
    pointwise readout integrates over.  Returns
    (refined_value, stderr, params_final).

    With ``anchors='domain'`` the anchors are drawn from the solver's
    own fresh-sample test measure — x ~ sample_domain(problem.geometry),
    t ~ U(0, T) (eval/test_error.py modus='parabolic') — refining the
    value FUNCTION over the whole test region instead of one point's
    tube; ``x0`` may then be None, in which case the pointwise readout
    is skipped and (None, None, params_final) is returned."""
    from .refine import feynman_kac_refine

    if key is None:
        key = jax.random.PRNGKey(0)
    if anchors not in ("tube", "domain"):
        raise ValueError(f"anchors must be 'tube' or 'domain': {anchors!r}")
    if anchors == "tube" and x0 is None:
        raise ValueError("anchors='tube' needs an x0 to draw the tube from")
    d = problem.d
    T = problem.T
    sig_mat = np.asarray(problem.sigma_struct.mat)
    spread = float(np.sqrt(np.trace(sig_mat @ sig_mat.T) / d))

    def v_of(p):
        def v_fn(X, t):
            xt = jnp.concatenate([X, t[:, None]], axis=-1)
            return net.apply(p, xt)[:, 0]
        return v_fn

    @jax.jit
    def reg_fit(p, ts, Xs, targets):
        tx = jnp.concatenate([Xs, ts[:, None]], axis=-1)

        def loss(p):
            pred = net.apply(p, tx)[:, 0]
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
    for stage in range(n_stages):
        key, ka, kt, kr, ku = jax.random.split(key, 5)
        ts = jax.random.uniform(kt, (M,), minval=0.0, maxval=T)
        if anchors == "domain":
            from ..rollout.sampling import sample_domain
            Xs = sample_domain(ka, problem.geometry, M, d)
        else:
            z = jax.random.normal(ka, (M, d))
            r = anchor_radius
            scale = (jnp.sqrt(ts)[:, None] * spread if r is None
                     else r * jax.random.uniform(ku, (M, 1)))
            Xs = x0[None, :] + scale * z
        targets = _mc_targets(problem, v_of(p), ts, Xs, K_inner,
                              delta_t, kr)
        p, reg_loss = reg_fit(p, ts, Xs, targets)
        if verbose and x0 is not None:
            out = feynman_kac_refine(problem, v_of(p), x0, K=readout_K,
                                     delta_t=delta_t, key=key)
            print(f"  picard stage {stage}: reg_loss {float(reg_loss):.3e}"
                  f", refined v = {float(out.value):.6f}")
        elif verbose:
            print(f"  picard stage {stage}: reg_loss {float(reg_loss):.3e}")

    if x0 is None:
        return None, None, p
    out = feynman_kac_refine(problem, v_of(p), x0, K=readout_K,
                             delta_t=delta_t, key=key)
    return out.value, out.stderr, p


# ---------------------------------------------------------------------------
# Elliptic (stopped-domain) Picard refinement — VERDICT round-2 item 5.
# ---------------------------------------------------------------------------

def mc_targets_elliptic(problem, v_fn, Xs, K_inner, N_cap, delta_t, key):
    """Stopped Feynman-Kac MC targets at anchor points Xs (M, d):

        target_i = E[g(X_tau) + int_0^tau h(X_s, v(X_s), .) ds],  X_0 = x_i,

    along the uncontrolled dynamics, with the Broadie-Glasserman-Kou
    discrete-exit correction (refine.py: bgk_closures).  Returns
    ``(targets (M,), cap_frac)`` where cap_frac is the fraction of paths
    force-projected at N_cap (bias indicator, cf. ADVICE round 2).

    Restriction (as in _mc_targets): h is called as h(x, y, None) — the
    model enters through y only; |z|^2-nonlinear problems unsupported."""
    from .refine import bgk_closures

    M, d = Xs.shape
    dt = jnp.float32(delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct
    inside, project = bgk_closures(problem, delta_t)

    X0 = jnp.repeat(Xs, K_inner, axis=0)              # (M*K, d)
    R = X0.shape[0]

    def step(carry, n):
        X, acc, stopped = carry
        ins = inside(X)
        active = ~stopped & ins
        h = problem.h(X, v_fn(X), None)
        acc = acc + jnp.where(active, h, 0.0) * dt
        xi = jax.random.normal(jax.random.fold_in(key, n), (R, d))
        Xp = X + problem.b(X) * dt + sig.apply(xi) * sq_dt
        X = jnp.where(active[:, None], Xp, X)
        stopped = stopped | ~ins
        return (X, acc, stopped), None

    (X, acc, stopped), _ = lax.scan(
        step, (X0, jnp.zeros((R,)), jnp.zeros((R,), bool)),
        jnp.arange(N_cap))
    vals = problem.g(project(X)) + acc                # (M*K,)
    cap_frac = jnp.mean((~stopped & inside(X)).astype(jnp.float32))
    return jnp.mean(vals.reshape(M, K_inner), axis=1), cap_frac


def picard_refine_elliptic(
    problem,
    net,                       # ansatz module: V(x), input (K, d)
    params,                    # trained params for `net`
    n_stages: int = 2,
    M: int = 4096,
    K_inner: int = 512,
    N_cap: int = 4096,
    delta_t: float = 1e-3,
    reg_steps: int = 3000,
    reg_lr: float = 1e-3,
    damping: float = 1.0,
    uniform_square: bool = False,
    key: Optional[jax.Array] = None,
    verbose: bool = False,
    max_paths_per_call: int = 1_048_576,
):
    """Multi-stage Picard refinement of a trained ELLIPTIC value net.

    Each stage: draw M anchors uniformly in the domain
    (rollout/sampling.py: sample_domain), estimate the stopped
    Feynman-Kac right-hand side at each anchor with the CURRENT model in
    h (BGK-corrected exits), and fit the net to the targets.  The model's
    systematic error contracts by ~ E[tau] * sup|dh/dy| per stage
    (refine.py's elliptic contraction caveat applies: stiff manufactured
    h may amplify; for the committor h = 0 one stage reaches the MC/
    regression floor).  ``damping`` < 1 Krasnoselskij-averages the
    targets with the current model, stabilizing weakly-expansive maps.

    Returns ``(params_final, history)`` with per-stage dicts
    (reg_loss, cap_frac).  Counterpart of :func:`picard_refine` for the
    EllipticSolver family (solver.py:733-801 semantics); no reference
    equivalent exists.
    """
    from ..rollout.sampling import sample_domain

    if key is None:
        key = jax.random.PRNGKey(0)
    d = problem.d

    def v_of(p):
        return lambda X: net.apply(p, X)[:, 0]

    targets_jit = jax.jit(
        lambda p, Xs, k: mc_targets_elliptic(
            problem, v_of(p), Xs, K_inner, N_cap, delta_t, k))

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

    # The flat (M * K_inner, d) ensemble can exceed device memory at
    # large d / deep N_cap (d=50, M=8192, K_inner=512 did); process
    # anchors in slices bounded by max_paths_per_call.
    per_slice = max(1, min(M, max_paths_per_call // max(K_inner, 1)))
    n_slices = -(-M // per_slice)

    def targets_chunked(p, Xs, kr):
        ts, cf = [], 0.0
        for j in range(n_slices):
            sl = Xs[j * per_slice:(j + 1) * per_slice]
            t, c = targets_jit(p, sl, jax.random.fold_in(kr, j))
            ts.append(t)
            cf += float(c) * sl.shape[0]
        return jnp.concatenate(ts), cf / M

    p = params
    history = []
    for stage in range(n_stages):
        key, ka, kr = jax.random.split(key, 3)
        Xs = sample_domain(ka, problem.geometry, M, d,
                           uniform_square=uniform_square)
        targets, cap_frac = targets_chunked(p, Xs, kr)
        if damping < 1.0:
            targets = (1.0 - damping) * v_of(p)(Xs) + damping * targets
        p, reg_loss = reg_fit(p, Xs, targets)
        rec = {"reg_loss": float(reg_loss), "cap_frac": float(cap_frac)}
        history.append(rec)
        if verbose:
            print(f"  elliptic picard stage {stage}: "
                  f"reg_loss {rec['reg_loss']:.3e}, "
                  f"cap_frac {rec['cap_frac']:.2e}")
        if rec["cap_frac"] > 1e-3:
            import warnings
            warnings.warn(
                "picard_refine_elliptic: %.2f%% of target paths hit "
                "N_cap=%d - targets are biased; raise N_cap"
                % (100 * rec["cap_frac"], N_cap), stacklevel=2)
    return p, history
