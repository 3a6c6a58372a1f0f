"""Rollout statistics, loss-zoo values, and gradient-estimator identities."""

import jax
import jax.numpy as jnp
import numpy as np

from pspde.losses import pathspace as lp
from pspde.problems import LLGC, HeatEquation
from pspde.rollout.sde import HJBRolloutConfig, hjb_rollout


def _zero_control(params, X, n, t):
    return jnp.zeros_like(X), None


def test_uncontrolled_ou_moments(key):
    """With zero control the rollout is plain Euler-Maruyama on the OU
    process: X_T ~ N(e^{AT} x0, Sigma) up to O(dt) bias."""
    d, T, dt = 2, 1.0, 0.01
    p = LLGC(d=d, T=T)
    K = 200_000
    cfg = HJBRolloutConfig(N=int(T / dt), delta_t=dt, adaptive_forward=False,
                           track_u_l2=False)
    X0 = jnp.zeros((K, d))
    Y0 = jnp.zeros((K,))
    out = jax.jit(lambda k: hjb_rollout(cfg, p, _zero_control, {}, X0, Y0, k)
                  )(key)
    X = np.asarray(out.X)
    # stationary-ish variance of OU with A=-I, B=I: var = (1 - e^{-2T})/2
    expected_var = (1 - np.exp(-2 * T)) / 2
    np.testing.assert_allclose(X.mean(axis=0), 0.0, atol=0.01)
    np.testing.assert_allclose(X.var(axis=0), expected_var, rtol=0.03)


def test_y_accumulates_girsanov_integral(key):
    """For h = 0 (heat equation) and constant control Z, the Y recursion
    reduces to Y_T = sum Z.(c dt + xi sqrt(dt)) which we can replicate."""
    d, T, dt = 3, 0.5, 0.05
    p = HeatEquation(d=d, T=T)
    K = 4096
    N = int(T / dt)
    zconst = jnp.ones((d,)) * 0.3

    def control(params, X, n, t):
        return jnp.broadcast_to(zconst, X.shape), None

    cfg = HJBRolloutConfig(N=N, delta_t=dt, adaptive_forward=True,
                           detach_forward=False, track_u_l2=False)
    X0 = jnp.zeros((K, d))
    out = hjb_rollout(cfg, p, control, {}, X0, jnp.zeros((K,)), key)
    # E[Y_T] = N * <Z, c> dt = -N |Z|^2 dt (c = -Z)
    expected = -N * float(jnp.sum(zconst ** 2)) * dt
    np.testing.assert_allclose(float(jnp.mean(out.Y)), expected, atol=0.02)


def test_loss_values_on_frozen_inputs():
    Y = jnp.array([1.0, 2.0, 3.0, 4.0])
    g = jnp.array([0.5, 1.5, 2.5, 3.0])
    Z_sum = jnp.array([0.1, 0.2, 0.3, 0.4])
    r = np.asarray(Y - g)
    np.testing.assert_allclose(float(lp.moment_loss(Y, g)), (r ** 2).mean(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(lp.log_variance_loss(Y, g)),
                               (r ** 2).mean() - r.mean() ** 2, rtol=1e-5)
    np.testing.assert_allclose(float(lp.variance_loss(Y, g)),
                               np.var(np.exp(-np.asarray(g - Y)), ddof=1),
                               rtol=1e-5)
    np.testing.assert_allclose(float(lp.relative_entropy_loss(Z_sum, g)),
                               np.asarray(Z_sum + g).mean(), rtol=1e-6)
    np.testing.assert_allclose(
        float(lp.cross_entropy_loss(Y, g, adaptive=False)),
        (np.asarray(Y) * np.exp(-np.asarray(g))).mean(), rtol=1e-6)


def test_log_variance_gradient_identity():
    """The gradient of the log-variance loss equals the detached
    centered-residual estimator 2 E[(r - rbar) dY/dtheta] (SURVEY.md
    section 7 'hard parts')."""
    key = jax.random.PRNGKey(3)
    K = 64
    g = jax.random.normal(key, (K,))
    xi = jax.random.normal(jax.random.fold_in(key, 1), (K,))

    def Y_of_theta(theta):
        return theta[0] * xi + theta[1]

    theta = jnp.array([0.7, -0.2])
    grad_loss = jax.grad(
        lambda th: lp.log_variance_loss(Y_of_theta(th), g))(theta)
    r = Y_of_theta(theta) - g
    centered = r - jnp.mean(r)
    dY = jax.jacobian(Y_of_theta)(theta)  # (K, 2)
    estimator = 2.0 * jnp.mean(centered[:, None] * dY, axis=0)
    np.testing.assert_allclose(np.asarray(grad_loss), np.asarray(estimator),
                               rtol=1e-4, atol=1e-6)


def test_cross_entropy_detached_weight_gradient():
    """Adaptive cross-entropy: gradient treats exp(Y) weight as constant."""
    key = jax.random.PRNGKey(4)
    K = 32
    g = 0.1 * jax.random.normal(key, (K,))
    xi = jax.random.normal(jax.random.fold_in(key, 1), (K,))

    def Y_of_theta(th):
        return th * xi

    th = jnp.float32(0.3)
    got = jax.grad(lambda t: lp.cross_entropy_loss(Y_of_theta(t), g,
                                                   adaptive=True))(th)
    w = jnp.exp(-g + Y_of_theta(th))
    expected = jnp.mean(w * xi)
    np.testing.assert_allclose(float(got), float(expected), rtol=1e-5)


def test_remat_matches_no_remat(key):
    p = LLGC(d=2, T=0.5)
    K, dt = 128, 0.05

    def control(params, X, n, t):
        return params["w"] * X, None

    params = {"w": jnp.float32(0.3)}
    X0 = jnp.zeros((K, 2))
    Y0 = jnp.zeros((K,))

    def loss(params, remat):
        cfg = HJBRolloutConfig(N=10, delta_t=dt, remat=remat,
                               track_u_l2=False)
        out = hjb_rollout(cfg, p, control, params, X0, Y0, key)
        return lp.log_variance_loss(out.Y, p.g(out.X))

    l1, g1 = jax.value_and_grad(lambda p_: loss(p_, False))(params)
    l2, g2 = jax.value_and_grad(lambda p_: loss(p_, True))(params)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(float(g1["w"]), float(g2["w"]), rtol=1e-5)


def test_batched_grad_fast_path_matches_scan(key):
    """hjb_rollout_batched_grad == hjb_rollout (values AND gradients) for
    detached-forward, y-free-h configs."""
    from pspde.rollout.sde import hjb_rollout_batched_grad
    from pspde.solvers import HJBSolver
    p = LLGC(d=3, T=0.5)
    s = HJBSolver("x", p, L=1, K=64, delta_t=0.05, time_approx="inner",
                  detach_forward=True, learn_Y_0=True, verbose=False,
                  loss_method="relative_entropy_BSDE",
                  early_stopping_time=None)
    s.detach_forward = True   # relative_entropy forces adaptive, keep detach
    cfg = s._rollout_cfg(0)
    cf, yi = s._control_fn(), s._y_init_fn()
    X0 = jnp.zeros((64, 3))

    def loss(params, roll):
        out = roll(cfg, p, cf, params, X0, yi(params, X0), key,
                   u_ref=s._u_ref)
        return jnp.mean(out.Z_sum + p.g(out.X)), out

    (l1, o1), g1 = jax.value_and_grad(
        lambda prm: loss(prm, hjb_rollout), has_aux=True)(s.params)
    (l2, o2), g2 = jax.value_and_grad(
        lambda prm: loss(prm, hjb_rollout_batched_grad),
        has_aux=True)(s.params)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(o1.Y), np.asarray(o2.Y),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(o1.Z_sum), np.asarray(o2.Z_sum),
                               atol=1e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-6)


def test_batched_grad_outer_time_approx(key):
    """Fast path with per-step ('outer') parameter stacks."""
    from pspde.rollout.sde import hjb_rollout_batched_grad
    from pspde.solvers import HJBSolver
    p = LLGC(d=2, T=0.5)
    s = HJBSolver("x", p, L=1, K=32, delta_t=0.1, time_approx="outer",
                  detach_forward=True, verbose=False,
                  early_stopping_time=None)
    cfg = s._rollout_cfg(0)
    cf, yi = s._control_fn(), s._y_init_fn()
    X0 = jnp.zeros((32, 2))

    def loss(params, roll):
        out = roll(cfg, p, cf, params, X0, yi(params, X0), key,
                   u_ref=s._u_ref)
        r = out.Y - p.g(out.X)
        return jnp.mean(r ** 2) - jnp.mean(r) ** 2

    l1 = jax.grad(lambda prm: loss(prm, hjb_rollout))(s.params)
    l2 = jax.grad(
        lambda prm: loss(prm, hjb_rollout_batched_grad))(s.params)
    for a, b in zip(jax.tree.leaves(l1), jax.tree.leaves(l2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-6)


def test_antithetic_training_rollout():
    """antithetic=True: (1) mirrored pairs are EXACT — with linear drift
    and non-adaptive forward the pairwise sums X_i + X_{i+K/2} all equal
    the same deterministic flow; (2) the relative-entropy loss variance
    across keys collapses (the KL Ito term is odd in the noise); (3) the
    even-K and rollout-mode guards raise."""
    import dataclasses

    import numpy as np
    import pytest

    from pspde.losses.pathspace import hjb_loss
    from pspde.problems import LLGC
    from pspde.rollout.sde import hjb_rollout
    from pspde.solvers import HJBSolver

    p = LLGC(d=4, T=0.5)
    s = HJBSolver("anti", p, L=20, K=256, delta_t=0.05,
                  time_approx="inner", loss_method="relative_entropy",
                  detach_forward=False, verbose=False,
                  early_stopping_time=None, antithetic=True)
    s.train()  # end-to-end smoke with the flag on
    control_fn = s._control_fn()
    y_init = s._y_init_fn()
    cfg = s._rollout_cfg(0)
    assert cfg.antithetic

    # (1) exact mirroring around the deterministic flow (c = 0, b linear)
    cfg_na = dataclasses.replace(cfg, adaptive_forward=False)
    X0 = jnp.broadcast_to(p.X_0, (256, 4)).astype(jnp.float32)
    out = hjb_rollout(cfg_na, p, control_fn, s.params, X0,
                      jnp.zeros((256,)), jax.random.PRNGKey(3))
    pair_sum = np.asarray(out.X[:128] + out.X[128:])
    np.testing.assert_allclose(pair_sum, pair_sum[:1].repeat(128, 0),
                               atol=1e-4)

    # (2) relative-entropy loss variance across keys: >=10x smaller with
    # mirrored pairs at the same total K (measured ~180x at d=10)
    def loss_with(cfg_i, key):
        Y0 = y_init(s.params, X0)
        o = hjb_rollout(cfg_i, p, control_fn, s.params, X0, Y0, key)
        return float(hjb_loss("relative_entropy", o.Y, p.g(o.X), o.Z_sum))

    cfg_plain = dataclasses.replace(cfg, antithetic=False)
    keys = [jax.random.PRNGKey(100 + i) for i in range(10)]
    std_plain = np.std([loss_with(cfg_plain, k) for k in keys])
    std_anti = np.std([loss_with(cfg, k) for k in keys])
    assert std_anti < 0.1 * std_plain, (std_anti, std_plain)

    # (3) guards
    with pytest.raises(ValueError, match="even K"):
        HJBSolver("bad", p, L=1, K=255, delta_t=0.05, verbose=False,
                  early_stopping_time=None, antithetic=True)
    # the removed 'fused' mode raises, naming the valid modes
    with pytest.raises(ValueError, match="'scan', 'batched_grad'"):
        HJBSolver("bad", p, L=1, K=256, delta_t=0.05, verbose=False,
                  early_stopping_time=None, antithetic=True,
                  rollout_mode="fused")


def test_relative_entropy_detach_warns():
    """relative_entropy + detach_forward=True silently stalls (the
    on-policy measure term is cut; measured round 5: LLGC d=10 u_L2
    flat at 4.18 for 200 iters) — the constructor must warn.  The
    reference has the same latent failure and does not."""
    import pytest

    from pspde.problems import LLGC
    from pspde.solvers import HJBSolver
    p = LLGC(d=2, T=0.5)
    with pytest.warns(UserWarning, match="degenerate gradient"):
        HJBSolver("warn", p, L=1, K=32, delta_t=0.1, verbose=False,
                  early_stopping_time=None,
                  loss_method="relative_entropy", detach_forward=True)
    import warnings
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        HJBSolver("ok", p, L=1, K=32, delta_t=0.1, verbose=False,
                  early_stopping_time=None,
                  loss_method="relative_entropy", detach_forward=False)
        HJBSolver("ok2", p, L=1, K=32, delta_t=0.1, verbose=False,
                  early_stopping_time=None, learn_Y_0=True,
                  loss_method="moment", detach_forward=True)
    assert not any("degenerate" in str(w.message) for w in rec)
