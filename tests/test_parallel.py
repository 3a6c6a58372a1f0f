"""Mesh/sharding tests on the 8-device virtual CPU platform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pspde.parallel import (batch_sharding, make_mesh, shard_batch,
                            shard_params_tp)
from pspde.problems import LLGC
from pspde.solvers import HJBSolver


def test_make_mesh_shapes():
    mesh = make_mesh(n_dp=4, n_tp=2)
    assert mesh.shape == {"dp": 4, "tp": 2}
    mesh2 = make_mesh(n_tp=2)   # auto dp
    assert mesh2.shape["dp"] * 2 <= 8 + 1


def test_shard_batch_places_on_dp():
    mesh = make_mesh(n_dp=8)
    x = jnp.zeros((64, 3))
    y = shard_batch(x, mesh)
    assert y.sharding.is_equivalent_to(batch_sharding(mesh, 2), 2)


def test_shard_params_tp_column_shards_kernels():
    mesh = make_mesh(n_dp=4, n_tp=2)
    p = LLGC(d=4, T=0.5)
    s = HJBSolver("tp", p, L=1, K=32, delta_t=0.1, time_approx="inner",
                  verbose=False, early_stopping_time=None)
    sharded = shard_params_tp(s.params, mesh)
    flat = jax.tree.flatten_with_path(sharded)[0]
    kernels = [(k, v) for k, v in flat if "kernel" in str(k)]
    # hidden-width-30 kernels divide tp=2 -> sharded on last axis
    assert any("tp" in str(v.sharding.spec) for _, v in kernels)


def test_tp_sharded_step_matches_replicated():
    """Full training step with tp-sharded kernels == replicated params."""
    mesh = make_mesh(n_dp=4, n_tp=2)
    kw = dict(lr=1e-2, L=8, K=64, delta_t=0.1, time_approx="inner",
              learn_Y_0=True, verbose=False, early_stopping_time=None)
    s1 = HJBSolver("a", LLGC(d=4, T=0.5), **kw)
    s1.train()

    s2 = HJBSolver("b", LLGC(d=4, T=0.5), mesh=mesh, **kw)
    s2.params = shard_params_tp(s2.params, mesh)
    s2.opt_state = s2.tx.init(s2.params)
    s2.train()
    np.testing.assert_allclose(s1.loss_log, s2.loss_log, rtol=1e-3,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# HLO collective guard (VERDICT r3 item 5): the algorithm's only cross-chip
# communication is scalar/param-sized reductions (SURVEY.md section 5.8).
# Value-equivalence tests cannot catch GSPMD silently materializing the
# gathered (K, d) path state (the step would still be CORRECT, just
# communication-bound on real hardware), so this guard inspects the
# compiled post-partitioning HLO and fails if ANY collective moves an
# operand anywhere near the path-block size.

import re

_HLO_SHAPE = re.compile(r"\b[a-z]+\d+\[([\d,]*)\]")
_HLO_COLL = re.compile(
    r"=\s*(.*?)\s+(all-gather|all-to-all|all-reduce|collective-permute|"
    r"reduce-scatter)\(")


def _max_collective_numel(hlo_text):
    """(op, result numel, line) of the largest collective in the HLO."""
    worst = ("none", 0, "")
    for line in hlo_text.splitlines():
        m = _HLO_COLL.search(line)
        if not m:
            continue
        numel = max((int(np.prod([int(x) for x in dims.split(",") if x]
                                 or [1]))
                     for dims in _HLO_SHAPE.findall(m.group(1))),
                    default=1)
        if numel > worst[1]:
            worst = (m.group(2), numel, line.strip()[:160])
    return worst


def _assert_param_sized_collectives_only(hlo_text, K, d, n_dp, params):
    path_block = K * d // n_dp          # one device's path-state shard
    param_numel = max(int(np.prod(p.shape))
                      for p in jax.tree.leaves(params))
    # every collective must be far below the per-device path block (and
    # at most a small multiple of the largest parameter leaf)
    bound = min(path_block // 2, 4 * max(param_numel, 128))
    assert bound < path_block, "test config too small to discriminate"
    op, numel, line = _max_collective_numel(hlo_text)
    assert numel <= bound, (
        f"pathological collective: {op} moves {numel} elements "
        f"(bound {bound}, per-device path block {path_block}): {line}")


def test_hlo_no_path_sized_collectives_hjb_scan():
    """dp-sharded HJB train step (kd and dk layouts): compiled HLO keeps
    every collective param-sized — GSPMD must never gather the path
    state."""
    mesh = make_mesh(n_dp=8)
    K, d = 8192, 8
    for layout in ("kd", "dk"):
        s = HJBSolver("hlo-guard", LLGC(d=d, T=0.5), lr=1e-2, L=1, K=K,
                      delta_t=0.125, time_approx="inner",
                      loss_method="log-variance", learn_Y_0=True,
                      detach_forward=True, verbose=False,
                      early_stopping_time=None, mesh=mesh, layout=layout)
        step = jax.jit(s._build_step(0))
        if layout == "dk":
            assert s.resolved_layout == "dk"
        hlo = step.lower(s.params, s.opt_state,
                         jax.random.PRNGKey(0)).compile().as_text()
        _assert_param_sized_collectives_only(hlo, K, d, 8, s.params)


def test_hlo_no_path_sized_collectives_elliptic():
    """dp-sharded elliptic (stopped-rollout, diffusion loss) step."""
    from pspde.problems import ExponentialOnBallNonlinearSin
    from pspde.solvers import EllipticSolver
    mesh = make_mesh(n_dp=8)
    K, d = 4096, 8
    s = EllipticSolver(ExponentialOnBallNonlinearSin(d=d), "hlo-ell",
                       loss_method="diffusion", lr=1e-3, L=1, K=K,
                       K_boundary=64, delta_t=0.01, N=16, verbose=False,
                       mesh=mesh)
    step = jax.jit(s._build_step())
    hlo = step.lower(s.params, s.opt_state,
                     jax.random.PRNGKey(0)).compile().as_text()
    _assert_param_sized_collectives_only(hlo, K, d, 8, s.params)


def test_is_scan_mesh_matches_unsharded():
    """importance_sampling(mesh=...): dp sharding is placement only —
    the same key gives bitwise-equal statistics."""
    from pspde.eval import importance_sampling
    p = LLGC(d=5, T=1.0)
    s = HJBSolver("is-mesh", p, lr=1e-2, L=1, K=16, delta_t=0.125,
                  time_approx="inner", loss_method="log-variance",
                  detach_forward=True, learn_Y_0=True, verbose=False,
                  early_stopping_time=None)
    mesh = make_mesh(n_dp=8)
    key = jax.random.PRNGKey(11)
    a = importance_sampling(p, s, K=64, simulate_naive=True,
                            delta_t=0.05, key=key)
    b = importance_sampling(p, s, K=64, simulate_naive=True,
                            delta_t=0.05, key=key, mesh=mesh)
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_hlo_no_path_sized_collectives_eigen_dk():
    """dp-sharded eigen step in the transposed (dk) layout: the X0.T
    sharding constraint (ADVICE r4) must keep GSPMD from gathering or
    re-sharding the transposed path state."""
    from pspde.problems import FokkerPlanckEigen
    from pspde.solvers import EigenSolver
    mesh = make_mesh(n_dp=8)
    K, d = 4096, 5
    s = EigenSolver(FokkerPlanckEigen(d=d), "hlo-eig", lr=1e-3, L=1, K=K,
                    K_boundary=64, delta_t=1e-3, N=8, verbose=False,
                    mesh=mesh, layout="dk")
    step = jax.jit(s._build_step())
    assert s.resolved_layout == "dk"
    hlo = step.lower(s.params, s.opt_state,
                     jax.random.PRNGKey(0)).compile().as_text()
    _assert_param_sized_collectives_only(hlo, K, d, 8, s.params)
