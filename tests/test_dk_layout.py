"""Transposed (d, K) scan rollout == row-major rollout.

``hjb_rollout_dk`` (rollout/sde.py) carries the path state as (d, K)
columns; with ``noise_layout='kd'`` it consumes the exact fold_in noise
stream of ``hjb_rollout``, so outputs and loss gradients must agree to
f32 tolerance.  The fast 'dk' noise layout is statistically equivalent
only (different draw shape).
"""

import jax
import jax.numpy as jnp
import numpy as np

from pspde.ansatz.transposed import transposed_apply
from pspde.losses.pathspace import log_variance_loss
from pspde.problems import LLGC
from pspde.rollout.sde import hjb_rollout, hjb_rollout_dk
from pspde.solvers import HJBSolver

K, D, N, DT = 48, 6, 10, 0.1


def _setup(**kw):
    p = LLGC(d=D, T=1.0)
    s = HJBSolver("dk-test", p, lr=1e-2, L=1, K=K, delta_t=DT,
                  time_approx="inner", verbose=False,
                  early_stopping_time=None, **kw)
    cfg = s._rollout_cfg(0)
    control_fn = s._control_fn()

    def control_T_fn(params, XT, n, t):
        tX = jnp.concatenate(
            [jnp.zeros((1, XT.shape[1]), XT.dtype) + t, XT], axis=0)
        return transposed_apply(s.z_net, params["z"], tX)

    key = jax.random.PRNGKey(11)
    X0 = jnp.broadcast_to(p.X_0, (K, D)).astype(jnp.float32)
    Y0 = jnp.zeros((K,), jnp.float32)
    u_tab = p.u_ref_table(np.arange(cfg.N) * DT)
    return p, s, cfg, control_fn, control_T_fn, key, X0, Y0, u_tab


def test_dk_matches_kd_outputs_and_grads():
    p, s, cfg, control_fn, control_T_fn, key, X0, Y0, u_tab = _setup(
        loss_method="log-variance", detach_forward=True, learn_Y_0=True)
    ref = hjb_rollout(cfg, p, control_fn, s.params, X0, Y0, key,
                      u_ref=s._u_ref)
    out = hjb_rollout_dk(cfg, p, control_T_fn, s.params, X0.T, Y0, key,
                         u_tab=u_tab, noise_layout="kd")
    np.testing.assert_allclose(out.X, ref.X, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.Y, ref.Y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.u_l2, ref.u_l2, rtol=2e-4, atol=2e-4)

    def loss_kd(params):
        o = hjb_rollout(cfg, p, control_fn, params, X0, Y0, key)
        return log_variance_loss(o.Y, p.g(o.X))

    def loss_dk(params):
        o = hjb_rollout_dk(cfg, p, control_T_fn, params, X0.T, Y0, key,
                           noise_layout="kd")
        return log_variance_loss(o.Y, p.g(o.X))

    g_kd = jax.grad(loss_kd)(s.params)
    g_dk = jax.grad(loss_dk)(s.params)
    for a, b in zip(jax.tree.leaves(g_kd), jax.tree.leaves(g_dk)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-6)


def test_dk_matches_kd_kl_nondetached():
    """Non-detached forward (gradient through the X chain) + KL
    accumulator (relative-entropy loss config)."""
    p, s, cfg, control_fn, control_T_fn, key, X0, Y0, u_tab = _setup(
        loss_method="relative_entropy", detach_forward=False)
    assert cfg.accumulate_kl and not cfg.detach_forward
    ref = hjb_rollout(cfg, p, control_fn, s.params, X0, Y0, key)
    out = hjb_rollout_dk(cfg, p, control_T_fn, s.params, X0.T, Y0, key,
                         noise_layout="kd")
    np.testing.assert_allclose(out.Z_sum, ref.Z_sum, rtol=2e-4, atol=2e-4)

    def loss_kd(params):
        o = hjb_rollout(cfg, p, control_fn, params, X0, Y0, key)
        return jnp.mean(o.Z_sum + p.g(o.X))

    def loss_dk(params):
        o = hjb_rollout_dk(cfg, p, control_T_fn, params, X0.T, Y0, key,
                           noise_layout="kd")
        return jnp.mean(o.Z_sum + p.g(o.X))

    g_kd = jax.grad(loss_kd)(s.params)
    g_dk = jax.grad(loss_dk)(s.params)
    for a, b in zip(jax.tree.leaves(g_kd), jax.tree.leaves(g_dk)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-6)


def test_solver_layout_dk_trains():
    """layout='dk' end-to-end: converges like the kd default."""
    p = LLGC(d=2, T=1.0)
    s = HJBSolver("dk-train", p, lr=1e-2, L=150, K=256, delta_t=0.05,
                  time_approx="inner", loss_method="log-variance",
                  learn_Y_0=True, verbose=False, early_stopping_time=None,
                  layout="dk", rng_impl="rbg")
    s.train()
    assert s.u_L2_loss[-1] < 0.05
    assert s.loss_log[-1] < 0.1 * s.loss_log[0]


def test_solver_layout_dk_falls_back_without_protocol():
    """A problem without the transposed protocol silently uses kd."""
    from pspde.problems import LLGC_general_f
    p = LLGC_general_f(d=3, T=0.5)
    assert not p.supports_transposed
    s = HJBSolver("dk-fb", p, lr=1e-2, L=3, K=16, delta_t=0.1,
                  time_approx="inner", verbose=False,
                  early_stopping_time=None, layout="dk",
                  u_l2_error_flag=False)
    s.train()
    assert np.isfinite(s.loss_log).all()


def test_dk_lqgc_kl_running_cost():
    """LQGC (quadratic running cost f in the KL accumulator) through the
    transposed rollout == row-major, u-L2 off (LQGC's reference control
    is state-dependent, so no u_tab)."""
    from pspde.problems import LQGC

    p = LQGC(d=4, T=1.0, delta_t=0.1)
    s = HJBSolver("dk-lqgc", p, lr=1e-2, L=1, K=32, delta_t=0.1,
                  time_approx="inner", loss_method="relative_entropy",
                  verbose=False, early_stopping_time=None,
                  u_l2_error_flag=False)
    cfg = s._rollout_cfg(0)
    control_fn = s._control_fn()

    def control_T_fn(params, XT, n, t):
        from pspde.ansatz.transposed import transposed_apply
        tX = jnp.concatenate(
            [jnp.zeros((1, XT.shape[1]), XT.dtype) + t, XT], axis=0)
        return transposed_apply(s.z_net, params["z"], tX)

    key = jax.random.PRNGKey(3)
    X0 = jnp.broadcast_to(p.X_0, (32, 4)).astype(jnp.float32)
    Y0 = jnp.zeros((32,), jnp.float32)
    ref = hjb_rollout(cfg, p, control_fn, s.params, X0, Y0, key)
    out = hjb_rollout_dk(cfg, p, control_T_fn, s.params, X0.T, Y0, key,
                         noise_layout="kd")
    np.testing.assert_allclose(out.Y, ref.Y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.Z_sum, ref.Z_sum, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Transposed STOPPED rollout (elliptic/general solvers, VERDICT r3 item 6)

def test_stopped_dk_matches_kd_outputs_and_grads():
    """stopped_rollout_dk(noise_layout='kd') consumes the exact fold_in
    noise stream of stopped_rollout: outputs (incl. masks/counters) and
    diffusion-loss parameter gradients agree to f32 tolerance."""
    from pspde.problems import ExponentialOnBallNonlinearSin
    from pspde.rollout.sampling import inside_fn, inside_fn_cols
    from pspde.rollout.sde import (StoppedRolloutConfig, stopped_rollout,
                                   stopped_rollout_dk)
    from pspde.solvers import EllipticSolver

    d, Ke, Ne = 5, 64, 12
    p = ExponentialOnBallNonlinearSin(d=d, alpha=0.5)
    s = EllipticSolver(p, "dk-stop", loss_method="diffusion", K=Ke, N=Ne,
                       delta_t=0.02, verbose=False)
    cfg = StoppedRolloutConfig(N=Ne, delta_t=0.02)
    vg = s._value_grad_fn()
    vg_T = s._value_grad_fn_T()
    key = jax.random.PRNGKey(5)
    kx, kr = jax.random.split(key)
    from pspde.rollout.sampling import sample_domain
    X0 = sample_domain(kx, p.geometry, Ke, d)
    Y0 = s._v_fn(s.params)(X0)
    t0 = jnp.zeros((Ke,))

    ref = stopped_rollout(cfg, p, vg, s.params, X0, Y0, t0, kr,
                          inside_fn(p.geometry), v_ref=p.v_ref)
    out = stopped_rollout_dk(cfg, p, vg_T, s.params, X0.T, Y0, t0, kr,
                             inside_fn_cols(p.geometry),
                             v_ref_T=p.v_ref_T, noise_layout="kd")
    np.testing.assert_allclose(out.X, ref.X, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.Y, ref.Y, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(out.stopped, ref.stopped)
    np.testing.assert_allclose(out.hitting, ref.hitting)
    np.testing.assert_allclose(out.v_l2, ref.v_l2, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.active_count, ref.active_count)

    v_fn = s._v_fn  # diffusion loss: (V(X_tau) - Y)^2 mean

    def loss_kd(params):
        o = stopped_rollout(cfg, p, vg, params, X0, Y0, t0, kr,
                            inside_fn(p.geometry))
        return jnp.mean((v_fn(params)(o.X) - o.Y) ** 2)

    def loss_dk(params):
        o = stopped_rollout_dk(cfg, p, vg_T, params, X0.T, Y0, t0, kr,
                               inside_fn_cols(p.geometry),
                               noise_layout="kd")
        return jnp.mean((v_fn(params)(o.X) - o.Y) ** 2)

    g1 = jax.grad(loss_kd)(s.params)
    g2 = jax.grad(loss_dk)(s.params)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)


def test_elliptic_solver_layout_dk_trains():
    """EllipticSolver(layout='dk', rng_impl='rbg') resolves 'dk' and the
    in-path v-L2 error falls on the d=5 manufactured problem."""
    from pspde.problems import ExponentialOnBallNonlinearSin
    from pspde.solvers import EllipticSolver
    p = ExponentialOnBallNonlinearSin(d=5, alpha=0.5)
    s = EllipticSolver(p, "dk-ell", loss_method="diffusion", K=128, N=12,
                       delta_t=0.02, lr=3e-3, L=200, verbose=False,
                       layout="dk", rng_impl="rbg")
    s.train()
    assert s.resolved_layout == "dk"
    assert s.V_L2_log[-1] < 0.5 * s.V_L2_log[0]


def test_general_solver_layout_dk_trains():
    """GeneralSolver(layout='dk') on the parabolic sin problem: resolves
    'dk' (time-stopping path) and trains."""
    from pspde.problems import ExponentialOnSphereNonlinearParabolic
    from pspde.solvers import GeneralSolver
    p = ExponentialOnSphereNonlinearParabolic(d=4, T=0.2, alpha=0.5)
    s = GeneralSolver(p, "dk-gen", loss_method="diffusion", K=128, N=10,
                      delta_t=0.02, lr=3e-3, L=200, verbose=False,
                      layout="dk")
    s.train()
    assert s.resolved_layout == "dk"
    assert np.isfinite(s.loss_log).all()
    assert s.loss_log[-1] < 0.5 * s.loss_log[0]


def test_elliptic_layout_dk_falls_back_without_protocol():
    """A problem without the transposed protocol falls back to 'kd' with
    a warning (never silently)."""
    import warnings
    from pspde.problems import Helmholtz
    from pspde.solvers import EllipticSolver
    p = Helmholtz()
    s = EllipticSolver(p, "dk-fb", loss_method="diffusion", K=32, N=4,
                       delta_t=0.02, L=2, verbose=False, layout="dk")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s._build_step()
    assert s.resolved_layout == "kd"
    assert any("fell back" in str(x.message) for x in w), w


def test_eigen_dk_matches_kd_and_trains():
    """The eigen domain rollout (lambda-shifted h) in dk layout matches
    the row-major rollout on the shared fold_in noise stream, and
    EigenSolver(layout='dk') trains with resolved_layout='dk'
    (round 4: the last solver family to get the stopped-rollout
    layout/RNG levers)."""
    from pspde.problems import FokkerPlanckEigen
    from pspde.rollout.sampling import (inside_fn, inside_fn_cols,
                                        sample_domain)
    from pspde.rollout.sde import (StoppedRolloutConfig, stopped_rollout,
                                   stopped_rollout_dk)
    from pspde.solvers import EigenSolver
    from pspde.solvers.eigen import _LambdaShiftedProblem
    from pspde.ansatz.transposed import transposed_apply

    d, Ke, Ne = 3, 32, 8
    p = FokkerPlanckEigen(d=d)
    s = EigenSolver(p, "eig-dk", L=1, K=Ke, N=Ne, delta_t=1e-2,
                    verbose=False, layout="dk")
    shifted = _LambdaShiftedProblem(p, jnp.float32(0.03))
    assert shifted.supports_transposed
    cfg = StoppedRolloutConfig(N=Ne, delta_t=1e-2)
    sig = p.sigma_struct
    net = s.V_net

    def vg(prm, X, t):
        v_of_x = lambda x: net.apply(prm["V"], x)[:, 0]
        V, pull = jax.vjp(v_of_x, X)
        (gX,) = pull(jnp.ones_like(V))
        return V, sig.apply_T(gX)

    def vg_T(prm, XT, t):
        v_of_xT = lambda xT: transposed_apply(net, prm["V"], xT)[0, :]
        V, pull = jax.vjp(v_of_xT, XT)
        (gXT,) = pull(jnp.ones_like(V))
        return V, sig.apply_T_cols(gXT)

    key = jax.random.PRNGKey(11)
    X0 = sample_domain(key, p.geometry, Ke, d)
    z = jnp.zeros((Ke,))
    ref = stopped_rollout(cfg, shifted, vg, s.params, X0, z, z, key,
                          inside_fn(p.geometry), v_ref=p.v_ref)
    out = stopped_rollout_dk(cfg, shifted, vg_T, s.params, X0.T, z, z,
                             key, inside_fn_cols(p.geometry),
                             v_ref_T=p.v_ref_T, noise_layout="kd")
    np.testing.assert_allclose(out.X, ref.X, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.Y, ref.Y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.v_l2, ref.v_l2, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(out.stopped, ref.stopped)

    # end-to-end: a few training steps in dk resolve + stay finite
    s.train()
    assert s.resolved_layout == "dk"
    assert np.isfinite(s.loss_log).all()
