"""Auto-resolved perf levers: the defaults ``layout='auto'`` and
``steps_per_call='auto'`` pick a lever from what the solver can observe;
explicit values always force.

layout='auto' switches to dk at K >= DK_MIN_PATHS (a threshold set on
another accelerator, not measured on the GPU); chunked dispatch is valid
exactly when the step is phase-static and free of per-iteration host
diagnostics.
"""

import warnings

import numpy as np
import pytest

from pspde.problems import (ExponentialOnBallNonlinearSin, LLGC)
from pspde.solvers import EllipticSolver, HJBSolver
from pspde.solvers._chunk import resolve_steps_per_call


def _ell(K, layout="auto", **kw):
    kw.setdefault("loss_method", "diffusion")
    kw.setdefault("L", 2)
    return EllipticSolver(ExponentialOnBallNonlinearSin(d=3, alpha=0.1),
                          "auto-ell", K=K, N=4, delta_t=0.01,
                          K_boundary=8, verbose=False, layout=layout, **kw)


def test_auto_layout_elliptic_crossover():
    lo = _ell(K=200)
    lo._resolve_dk()
    assert lo.resolved_layout == "kd"      # below DK_MIN_PATHS
    hi = _ell(K=2048)
    hi._resolve_dk()
    assert hi.resolved_layout == "dk"      # transposed protocol + K >= 1024


def test_explicit_layout_still_forces():
    forced_kd = _ell(K=4096, layout="kd")
    forced_kd._resolve_dk()
    assert forced_kd.resolved_layout == "kd"
    forced_dk = _ell(K=64, layout="dk")
    forced_dk._resolve_dk()
    assert forced_dk.resolved_layout == "dk"


def test_auto_layout_falls_back_silently():
    """auto on a gate-failing config (PINN) resolves kd with NO warning
    (only an explicit 'dk' warns on fallback)."""
    s = _ell(K=4096, loss_method="PINN")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s._resolve_dk()
    assert s.resolved_layout == "kd"
    assert not any("fell back" in str(x.message) for x in w)


def test_auto_layout_hjb_crossover():
    p = LLGC(d=2, T=0.5)
    lo = HJBSolver("auto-hjb", p, L=1, K=64, delta_t=0.1, verbose=False,
                   learn_Y_0=True, detach_forward=True,
                   early_stopping_time=None)
    lo._build_step(0)
    assert lo.resolved_layout == "kd"
    hi = HJBSolver("auto-hjb2", p, L=1, K=2048, delta_t=0.1, verbose=False,
                   learn_Y_0=True, detach_forward=True,
                   early_stopping_time=None)
    hi._build_step(0)
    assert hi.resolved_layout == "dk"


def test_auto_spc_resolution():
    s = _ell(K=200)
    assert resolve_steps_per_call(s, chunkable=True) == 50
    assert s.resolved_steps_per_call == 50
    assert resolve_steps_per_call(s, chunkable=False) == 1
    s.print_every = 7
    assert resolve_steps_per_call(s, chunkable=True) == 7
    s.steps_per_call = 13                   # explicit forces
    assert resolve_steps_per_call(s, chunkable=False) == 13


def test_auto_spc_training_trajectory_matches_spc1():
    """Default auto chunking must reproduce the spc=1 iterate/metric
    trajectory exactly (same key-split recursion)."""
    a = _ell(K=64, steps_per_call=1, L=6)
    a.train()
    b = _ell(K=64, L=6)                     # steps_per_call='auto'
    b.train()
    assert b.resolved_steps_per_call > 1
    np.testing.assert_allclose(np.asarray(a.loss_log),
                               np.asarray(b.loss_log), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a.V_L2_log),
                               np.asarray(b.V_L2_log), rtol=1e-4, atol=1e-7)


def test_hjb_auto_spc_respects_diagnostic_gate():
    """Per-iteration host diagnostics (IS_variance_K) force the eager
    loop: auto must resolve to 1, and training still runs."""
    p = LLGC(d=2, T=0.5)
    s = HJBSolver("auto-gate", p, L=2, K=32, delta_t=0.1, verbose=False,
                  learn_Y_0=True, early_stopping_time=None,
                  IS_variance_K=64, IS_variance_iter=1)
    s.train()
    assert s.resolved_steps_per_call == 1
    assert len(s.loss_log) == 2
    s2 = HJBSolver("auto-chunk", p, L=4, K=32, delta_t=0.1, verbose=False,
                   learn_Y_0=True, early_stopping_time=None)
    s2.train()
    assert s2.resolved_steps_per_call > 1
    assert len(s2.loss_log) == 4


def test_resolved_spc_records_effective_chunk():
    """resolved_steps_per_call must record the EFFECTIVE (post-cap) chunk:
    at L=6 with print_every=100, auto resolves to 50 but chunk_sizes caps
    the chunk at L=6 — the recorded lever must say 6, not 50 (code
    review r5)."""
    s = _ell(K=64, L=6)                     # steps_per_call='auto'
    s.print_every = 100
    s.train()
    assert s.resolved_steps_per_call == 6
    assert len(s.loss_log) == 6


def _make_solver(family, mode):
    from pspde.problems import FokkerPlanckEigen, HeatEquation
    from pspde.solvers import EigenSolver, GeneralSolver
    kw = dict(L=1, K=16, verbose=False, rollout_mode=mode)
    if family == "hjb":
        return HJBSolver("m", LLGC(d=2, T=0.5), delta_t=0.1,
                         early_stopping_time=None, **kw)
    if family == "elliptic":
        return _ell(K=16, L=1, rollout_mode=mode)
    if family == "general":
        return GeneralSolver(HeatEquation(d=2), "m", N=4, **kw)
    return EigenSolver(FokkerPlanckEigen(d=2), "m", N=4, **kw)


@pytest.mark.parametrize("family", ["hjb", "elliptic", "general", "eigen"])
def test_removed_rollout_mode_raises(family):
    """The removed 'fused'/'fused_train' modes raise ValueError naming the
    valid modes on every solver; the default 'scan' still constructs."""
    for mode in ("fused", "fused_train"):
        with pytest.raises(ValueError, match="valid modes: 'scan'"):
            _make_solver(family, mode)
    assert _make_solver(family, "scan").rollout_mode == "scan"
