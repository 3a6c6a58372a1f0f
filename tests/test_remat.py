"""Long-horizon rematerialization (rollout/sde.py: _remat_scan).

The sqrt-schedule scan-of-scans must reproduce the plain scan's outputs
and gradients exactly, and it must engage from the device's memory limit
(``memory_stats()['bytes_limit']``) or, on a device that reports none,
from the host constant.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pspde.rollout.sde as sde
from pspde.losses.pathspace import log_variance_loss
from pspde.problems import LLGC
from pspde.rollout.sde import hjb_rollout
from pspde.solvers import HJBSolver


def test_nested_remat_long_n_matches_plain_scan():
    """stopped_rollout's sqrt-schedule scan-of-scans (cfg.remat, N > 2048)
    must produce identical outputs AND loss gradients to the plain scan
    (remat changes memory scheduling, not math); padding steps beyond N
    are masked to no-ops."""
    from pspde.problems import ExponentialOnBallNonlinearSin
    from pspde.rollout.sampling import inside_fn, sample_domain
    from pspde.rollout.sde import StoppedRolloutConfig, stopped_rollout
    from pspde.ansatz import DenseNet

    p = ExponentialOnBallNonlinearSin(d=4, alpha=1.0)
    net = DenseNet(d_out=1, arch=(8, 8))
    key = jax.random.PRNGKey(3)
    params = net.init(key, jnp.zeros((1, 4)))
    X0 = sample_domain(key, p.geometry, 16, 4)
    ins = inside_fn(p.geometry)

    def vg(prm, X, t):
        v_of_x = lambda x: net.apply(prm, x)[:, 0]
        V, pull = jax.vjp(v_of_x, X)
        (g,) = pull(jnp.ones_like(V))
        return V, p.sigma_struct.apply_T(g)

    def loss(prm, remat):
        # N=2500 > 2048 triggers the nested path only when remat=True
        cfg = StoppedRolloutConfig(N=2500, delta_t=1e-3, remat=remat)
        out = stopped_rollout(cfg, p, vg, prm, X0,
                              net.apply(prm, X0)[:, 0], jnp.zeros((16,)),
                              key, ins)
        return jnp.mean((p.g(out.X) - out.Y) ** 2), out

    (l_plain, o_plain), g_plain = jax.value_and_grad(
        lambda prm: loss(prm, False), has_aux=True)(params)
    (l_remat, o_remat), g_remat = jax.value_and_grad(
        lambda prm: loss(prm, True), has_aux=True)(params)
    np.testing.assert_allclose(l_plain, l_remat, rtol=1e-6)
    np.testing.assert_allclose(o_plain.Y, o_remat.Y, rtol=1e-5, atol=1e-6)
    assert bool(jnp.all(o_plain.stopped == o_remat.stopped))
    np.testing.assert_allclose(o_plain.hitting, o_remat.hitting)
    for a, b in zip(jax.tree.leaves(g_plain), jax.tree.leaves(g_remat)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_hjb_nested_remat_matches_plain_scan():
    """hjb_rollout with remat at N > 2048 (sqrt scan-of-scans via
    _remat_scan) == plain scan, outputs and gradients."""
    p = LLGC(d=3, T=1.0)
    s = HJBSolver("hjb-longN", p, lr=1e-2, L=1, K=16, delta_t=1.0 / 2500,
                  time_approx="inner", loss_method="log-variance",
                  detach_forward=True, learn_Y_0=True, verbose=False,
                  early_stopping_time=None)
    assert s.N == 2500
    cfg = s._rollout_cfg(0)
    control_fn = s._control_fn()
    key = jax.random.PRNGKey(5)
    X0 = jnp.broadcast_to(p.X_0, (16, 3)).astype(jnp.float32)
    Y0 = jnp.zeros((16,), jnp.float32)

    def loss(prm, remat):
        out = hjb_rollout(dataclasses.replace(cfg, remat=remat), p,
                          control_fn, prm, X0, Y0, key, u_ref=s._u_ref)
        return log_variance_loss(out.Y, p.g(out.X))

    l_plain, g_plain = jax.value_and_grad(lambda q: loss(q, False))(s.params)
    l_remat, g_remat = jax.value_and_grad(lambda q: loss(q, True))(s.params)
    np.testing.assert_allclose(l_plain, l_remat, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(g_plain), jax.tree.leaves(g_remat)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _n_scans(limit_stats, monkeypatch, N=8):
    """Count the scans _remat_scan emits for a (N, 1000-float) carry
    under a stubbed device: 1 = plain scan, 2 = sqrt schedule."""
    monkeypatch.setattr(sde.jax, "local_devices",
                        lambda: [_Dev(limit_stats)])
    carry0 = (jnp.zeros((1000,), jnp.float32),)

    def step(c, n):
        return (c[0] + 1.0,), None

    jaxpr = jax.make_jaxpr(lambda c: sde._remat_scan(
        step, c, N, True))(carry0)
    return str(jaxpr).count("scan[")


@pytest.mark.parametrize("limit,expect_scans", [
    (10 ** 9, 1),          # 8 steps x 4000 B << half of 1 GB: plain scan
    (40_000, 2),           # 32 kB of carries > 20 kB budget: sqrt schedule
])
def test_remat_budget_from_memory_stats(limit, expect_scans, monkeypatch):
    assert _n_scans({"bytes_limit": limit}, monkeypatch) == expect_scans
    monkeypatch.setattr(sde.jax, "local_devices",
                        lambda: [_Dev({"bytes_limit": limit})])
    assert sde.carry_budget_bytes() == limit // 2


def test_remat_budget_host_constant(monkeypatch):
    """A device without memory statistics (the host CPU reports none)
    gets the host constant."""
    monkeypatch.setattr(sde.jax, "local_devices", lambda: [_Dev(None)])
    assert sde.carry_budget_bytes() == sde.HOST_CARRY_BUDGET_BYTES
    assert _n_scans(None, monkeypatch) == 1
