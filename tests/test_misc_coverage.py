"""Coverage for the remaining reference surfaces: LSE supervised fit,
Burgers drift, DoubleWellGeneral linear modus, Committor_DoubleWell,
path-ensemble simulation, double-well control plots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pspde.problems import (LLGC, Committor_DoubleWell, DoubleWell,
                            DoubleWellGeneral)
from pspde.solvers import GeneralSolver, HJBSolver


def test_train_lse_with_reference():
    """Supervised least-squares fit against u_true (solver.py:384-418)."""
    p = LLGC(d=1, T=0.5)
    s = HJBSolver("lse", p, L=300, lr=1e-2, K=32, delta_t=0.05,
                  time_approx="inner", verbose=False,
                  early_stopping_time=None)
    s.train_LSE_with_reference(xb=2.0, n_grid=100)
    assert s.loss_log[-1] < 0.05 * s.loss_log[0]
    # fitted control close to the truth on the grid
    X = jnp.linspace(-1.0, 1.0, 21)[:, None]
    u_fit = np.asarray(-s.Z_n(X, 0.1))
    u_true = np.asarray(s._u_ref(X, 3))
    np.testing.assert_allclose(u_fit, u_true, atol=0.15)


def test_burgers_drift_runs():
    """burgers_drift uses c = 1 (Y - (2+d)/(2d)) (solver.py:453-454)."""
    p = LLGC(d=2, T=0.5)
    s = HJBSolver("bg", p, L=10, lr=1e-3, K=64, delta_t=0.05,
                  time_approx="inner", burgers_drift=True,
                  adaptive_forward_process=True, verbose=False,
                  early_stopping_time=None)
    s.train()
    assert np.isfinite(s.loss_log[-1])


def test_double_well_general_linear_modus():
    """modus='linear' solves for psi directly: h = 0, terminal exp(-g)
    (problems.py:517-534), reference is the product of 1-d psi tables."""
    p = DoubleWellGeneral(d=2, d_1=1, d_2=1, T=0.5, eta=1.0, kappa=1.0,
                          modus="linear")
    p.compute_reference_solution(delta_t=0.01, nx=300)
    v_fn = p.v_ref_fn(np.array([0.5]))
    x = jnp.zeros((3, 2))
    v = np.asarray(v_fn(x, 0))
    # at t = T, psi = exp(-g); product over dims
    expected = np.exp(-1.0 * (0.0 - 1) ** 2) * np.exp(-(0.0 - 1) ** 2)
    np.testing.assert_allclose(v, expected, atol=0.05)

    s = GeneralSolver(p, "lin", loss_method="diffusion", L=30, N=10,
                      delta_t=0.01, K=64, K_boundary=16, verbose=False)
    s.train()
    assert np.isfinite(s.loss_log[-1])


def test_committor_double_well_general_solver():
    p = Committor_DoubleWell(d=1, beta=1.0, eta=2.0, T=0.5)
    s = GeneralSolver(p, "cdw", loss_method="diffusion", L=30, N=10,
                      delta_t=0.01, K=64, K_boundary=16, verbose=False)
    s.train()
    assert np.isfinite(s.loss_log[-1])


def test_plot_path_ensemble_and_dw_plots(tmp_path, key):
    from pspde.eval import plot_control_for_DoubleWell1d, plot_path_ensemble
    dw = DoubleWell(d=1, T=0.5, eta=1.0, kappa=1.0)
    dw.compute_reference_solution(delta_t=0.01, nx=200)
    fig, crossed = plot_path_ensemble(dw, None, K=50, control="zero",
                                      delta_t=0.02, key=key)
    assert 0 <= crossed <= 50
    s = HJBSolver("dw", dw, L=1, K=16, delta_t=0.05, time_approx="inner",
                  verbose=False, early_stopping_time=None)
    import os
    prefix = str(tmp_path / "ctrl")
    f1, f2 = plot_control_for_DoubleWell1d(s, prefix)
    assert os.path.exists(prefix + "-2d.eps")
    assert os.path.exists(prefix + "-1d.eps")


def test_plot_trajectories_kwarg_wired():
    """The ``plot_trajectories`` kwarg (solver.py:75) produces a
    post-training path-ensemble figure instead of being silently stored."""
    import matplotlib
    matplotlib.use("Agg")
    p = LLGC(d=1, T=0.2)
    s = HJBSolver("ptraj", p, L=3, lr=1e-2, K=16, delta_t=0.05,
                  time_approx="inner", verbose=False,
                  early_stopping_time=None, plot_trajectories=8)
    s.train()
    assert s.trajectory_fig is not None


def test_enable_compilation_cache(tmp_path):
    """Persistent-compile-cache helper points JAX at the dir, creates it,
    and jitted computation is unaffected (utils/compile_cache.py)."""
    from pspde.utils import enable_compilation_cache
    import os
    prev = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        prev_size = jax.config.jax_persistent_cache_min_entry_size_bytes
    except AttributeError:
        prev_size = None
    d = enable_compilation_cache(str(tmp_path / "cc"),
                                 min_compile_seconds=0.0)
    try:
        assert os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
        f = jax.jit(lambda x: (x * 2.0).sum())
        np.testing.assert_allclose(float(f(jnp.ones((4, 3)))), 24.0)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          prev_min)
        if prev_size is not None:
            jax.config.update("jax_persistent_cache_min_entry_size_bytes",
                              prev_size)


@pytest.fixture
def restore_cache_config():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    prev = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in prev.items():
        jax.config.update(n, v)


def test_compile_cache_env_var_wins(tmp_path, monkeypatch,
                                    restore_cache_config):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory:
    an explicit path is ignored and not created."""
    import os
    from pspde.utils import enable_compilation_cache
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    d = enable_compilation_cache(str(tmp_path / "from_arg"))
    assert d == env_dir and os.path.isdir(env_dir)
    assert jax.config.jax_compilation_cache_dir == env_dir
    assert not os.path.exists(tmp_path / "from_arg")


def test_compile_cache_default_is_repo_dir(monkeypatch,
                                           restore_cache_config):
    """Without the variable the cache goes to <repo>/.jax_cache."""
    import os
    from pspde.utils import enable_compilation_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = enable_compilation_cache()
    assert d == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
