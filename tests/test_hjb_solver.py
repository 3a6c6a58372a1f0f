"""End-to-end HJB solver tests: convergence on closed-form problems,
loss-zoo coverage, value-function mode, multi-device equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pspde.parallel import make_mesh
from pspde.problems import LLGC, LQGC
from pspde.solvers import HJBSolver


def _solver(loss_method="log-variance", **kw):
    defaults = dict(lr=1e-2, L=150, K=256, delta_t=0.05,
                    time_approx="inner", learn_Y_0=True, print_every=1000,
                    early_stopping_time=None, verbose=False)
    defaults.update(kw)
    p = defaults.pop("problem", None) or LLGC(d=1, T=1.0)
    return HJBSolver("t", p, loss_method=loss_method, **defaults)


def test_log_variance_converges():
    s = _solver("log-variance")
    s.train()
    assert s.u_L2_loss[-1] < 0.05
    assert s.loss_log[-1] < 0.1 * s.loss_log[0]


def test_moment_loss_learns_y0():
    # the moment loss has a nonzero y0 gradient and drives Y_0 -> v(x0, 0)
    # (log-variance is invariant to constant shifts of Y, hence the
    # reference's separate 'log-variance-y_0' mode, solver.py:205-218)
    s = _solver("moment", L=400)
    s.train()
    v0 = float(s.problem.v_ref(jnp.zeros((1, 1)), 0.0)[0])
    assert abs(s.Y_0_log[-1] - v0) < 0.15


@pytest.mark.parametrize("method,detach", [
    # detach flags follow the reference notebook configs (OU linear costs
    # nb cell 1: detach_forward=True for all losses except relative entropy)
    ("moment", True), ("variance", True), ("relative_entropy", False),
    ("cross_entropy", True), ("relative_entropy_BSDE", False),
])
def test_loss_zoo_converges(method, detach):
    s = _solver(method, L=200, detach_forward=detach)
    s.train()
    assert s.u_L2_loss[-1] < 0.1, method


@pytest.mark.parametrize("method", [
    "log-variance-repa", "relative_entropy_log-variance",
    "reparametrization", "log-variance-y_0",
])
def test_special_losses_run_and_improve(method):
    s = _solver(method, L=120)
    s.train()
    assert np.isfinite(s.loss_log[-1])
    assert s.u_L2_loss[-1] < s.u_L2_loss[0]


def test_outer_time_approx():
    s = _solver("log-variance", time_approx="outer", delta_t=0.1, L=150)
    s.train()
    assert s.u_L2_loss[-1] < 0.1


def test_value_function_mode():
    s = _solver("moment", approx_method="value_function", learn_Y_0=False,
                delta_t=0.1, L=150, lr=3e-3)
    s.train()
    assert np.isfinite(s.loss_log[-1])
    assert s.loss_log[-1] < s.loss_log[0]


def test_detach_forward_and_random_x0():
    s = _solver("log-variance", detach_forward=True, random_X_0=True, L=80)
    s.train()
    assert np.isfinite(s.loss_log[-1])


def test_lqgc_linear_ansatz_converges():
    from pspde.ansatz import LinearLQ
    p = LQGC(d=2, T=0.5, delta_t=0.05)
    net = LinearLQ(B=p.B, Q=p.Q)
    s = HJBSolver("lq", p, lr=1e-2, L=400, K=512, delta_t=0.05,
                  time_approx="outer", loss_method="log-variance",
                  control_net=net, learn_Y_0=False, verbose=False,
                  detach_forward=True, early_stopping_time=None)
    s.train()
    assert s.u_L2_loss[-1] < 0.3 * s.u_L2_loss[0]


def test_sharded_matches_single_device():
    """dp-sharded training step produces the same loss trajectory as the
    unsharded one (global-mean losses need collectives; SURVEY.md 5.8)."""
    mesh = make_mesh(n_dp=8)
    kw = dict(lr=1e-2, L=12, K=256, delta_t=0.05, time_approx="inner",
              learn_Y_0=True, print_every=1000, verbose=False,
              early_stopping_time=None)
    s1 = HJBSolver("a", LLGC(d=2, T=0.5), loss_method="log-variance", **kw)
    s2 = HJBSolver("b", LLGC(d=2, T=0.5), loss_method="log-variance",
                   mesh=mesh, **kw)
    s1.train()
    s2.train()
    np.testing.assert_allclose(s1.loss_log, s2.loss_log, rtol=1e-3,
                               atol=1e-5)


def test_early_stopping_triggers():
    # lr = 0: u_L2 is statistically flat, so the plateau criterion
    # (solver.py:550-554) must fire right after the warm-up window
    s = _solver("log-variance", L=400, early_stopping_time=20, lr=0.0,
                K=4096)
    s.train()
    assert len(s.loss_log) < 400


def test_save_load_roundtrip(tmp_path):
    s = _solver("log-variance", L=5)
    s.train()
    path = s.save_networks(out_dir=str(tmp_path / "ckpt"))
    before = jax.tree.map(np.asarray, s.params)
    s2 = _solver("log-variance", L=5)
    s2.load_networks(path)
    after = jax.tree.map(np.asarray, s2.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b),
                 before, after)


def test_save_logs_json(tmp_path):
    s = _solver("log-variance", L=3)
    s.train()
    path = s.save_logs(log_dir=str(tmp_path))
    import json
    with open(path) as f:
        logs = json.load(f)
    assert len(logs["loss_log"]) == 3
    assert logs["loss_method"] == "log-variance"


def test_rng_impl_rbg_converges():
    """rng_impl='rbg' (fast XLA RngBitGenerator draws) trains to the same
    tolerance as the default threefry stream — statistically equivalent
    noise, identical parameter init."""
    s = _solver("log-variance", rng_impl="rbg")
    s.train()
    assert s.u_L2_loss[-1] < 0.05
    assert s.loss_log[-1] < 0.1 * s.loss_log[0]


def test_perf_mode_fallback_is_surfaced():
    """Perf modes must not downgrade silently: a removed rollout_mode
    raises and names the valid modes, the solver records the resolved
    engine, and it warns once when an explicit rollout_mode / layout
    opt-in falls back."""
    import warnings

    with pytest.raises(ValueError, match="'scan', 'batched_grad'"):
        _solver("log-variance", L=1, rollout_mode="fused_train",
                detach_forward=True, problem=LLGC(d=2, T=0.5))

    # batched_grad needs detach_forward -> falls back to the scan
    s = _solver("log-variance", L=1, rollout_mode="batched_grad",
                detach_forward=False, problem=LLGC(d=2, T=0.5))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s._build_step(0)
    assert s.resolved_rollout_mode == "scan"
    assert any("fell back" in str(x.message) for x in w), w
    # ... and only once
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        s._build_step(0)
    assert not any("fell back" in str(x.message) for x in w2)

    # layout='dk' on a value_function solver cannot transpose -> warn
    s2 = _solver("moment", L=1, layout="dk",
                 approx_method="value_function", learn_Y_0=False)
    with warnings.catch_warnings(record=True) as w3:
        warnings.simplefilter("always")
        s2._build_step(0)
    assert s2.resolved_layout == "kd"
    assert any("fell back" in str(x.message) for x in w3), w3

    # a SUCCESSFUL dk resolution records 'dk' and stays quiet
    s3 = _solver("log-variance", L=1, layout="dk",
                 problem=LLGC(d=2, T=0.5))
    with warnings.catch_warnings(record=True) as w4:
        warnings.simplefilter("always")
        s3._build_step(0)
    assert s3.resolved_layout == "dk"
    assert s3.resolved_rollout_mode == "scan"
    assert not any("fell back" in str(x.message) for x in w4)
