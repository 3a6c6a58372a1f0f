"""Single-pass loss-estimator statistics.

Rebuilds the "Compare relative errors of losses" study (notebook cell 2):
roll out the forward process once (no gradients), then compare the
statistical relative errors of the cross-entropy-type estimators
(which blow up ~ c^d in dimension) against the log-variance estimator
(dimension-independent ~ c); cf. BASELINE.md last row.

Memory scaling: the ensemble is processed in ``n_chunks`` sequential
rollouts; each chunk reduces to 13 raw-moment sums (float64 on host), so
K = 5e7+ fits at any dimension (a monolithic (K, d) ensemble at
K = 5e7 and d = 15 alone is 3 GB of float32 per array, times the
rollout's many live arrays).
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..rollout.sde import HJBRolloutConfig, hjb_rollout


def loss_estimator_statistics(problem, control_fn: Callable, params,
                              K: int, delta_t: float, key,
                              outlier_cutoff: float = 100.0,
                              adaptive: bool = False,
                              detach: bool = False,
                              n_chunks: int = 1) -> Dict[str, float]:
    """Returns mean/variance pairs for: the plain weight exp(-g), the
    naive cross-entropy estimator Y exp(-g), the detached-reweighting
    variant Y exp(-g + Y), its outlier-filtered version, and the
    log-variance loss-value estimator (with its 4th-moment variance).

    Note: the notebook accumulates Y with +h (not -h) — it studies the
    estimator statistics of the integrand, not the trained solver; we
    reproduce that by negating h through a problem shim.
    """
    N = int(np.floor(problem.T / delta_t))
    Kc = -(-K // n_chunks)

    class _NegH:
        T = problem.T
        sigma_struct = problem.sigma_struct
        b = staticmethod(problem.b)
        f = staticmethod(problem.f)
        g = staticmethod(problem.g)

        @staticmethod
        def h(t, x, y, z):
            return -problem.h(t, x, y, z)

    cfg = HJBRolloutConfig(N=N, delta_t=delta_t, adaptive_forward=adaptive,
                           detach_forward=detach, track_u_l2=False)

    @jax.jit
    def chunk_sums(key):
        X0 = jnp.broadcast_to(problem.X_0, (Kc, problem.d))
        out = hjb_rollout(cfg, _NegH(), control_fn, params, X0,
                          jnp.zeros((Kc,)), key)
        Y, gX = out.Y, problem.g(out.X)
        w = jnp.exp(-gX)
        ce = Y * w
        ced = Y * jnp.exp(-gX + Y)
        mask = (jnp.abs(ced) < outlier_cutoff).astype(jnp.float32)
        r = Y - gX
        cols = jnp.stack([w, w * w, ce, ce * ce, ced, ced * ced,
                          ced * mask, mask, ced * ced * mask,
                          r, r * r, r ** 3, r ** 4], axis=-1)
        return jnp.sum(cols, axis=0)

    sums = np.zeros(13, dtype=np.float64)
    for c in range(n_chunks):
        sums += np.asarray(jax.device_get(
            chunk_sums(jax.random.fold_in(key, c))), dtype=np.float64)
    n = float(n_chunks * Kc)

    def mean_var(s1, s2, count=n):
        mu = s1 / count
        var = (s2 / count - mu * mu) * count / max(count - 1.0, 1.0)
        return mu, var

    m_w, v_w = mean_var(sums[0], sums[1])
    m_ce, v_ce = mean_var(sums[2], sums[3])
    m_ced, v_ced = mean_var(sums[4], sums[5])
    n_sel = max(sums[7], 1.0)
    m_sel, v_sel = mean_var(sums[6], sums[8], n_sel)
    m_r = sums[9] / n
    # central moments of r from raw moments
    c2 = sums[10] / n - m_r ** 2
    c4 = (sums[12] / n - 4 * m_r * sums[11] / n
          + 6 * m_r ** 2 * sums[10] / n - 3 * m_r ** 4)
    var_r = c2 * n / max(n - 1.0, 1.0)
    return {
        "mean_g": m_w, "var_g": v_w,
        "mean_CE": m_ce, "var_CE": v_ce,
        "mean_CE_detach": m_ced, "var_CE_detach": v_ced,
        "mean_CE_detach_selection": abs(m_sel),
        "std_CE_detach_selection": float(np.sqrt(max(v_sel, 0.0))),
        "mean_var": var_r,
        "var_var": c4 - var_r ** 2,
    }


def relative_error(stats: Dict[str, float], which: str) -> float:
    return float(np.sqrt(max(stats[f"var_{which}"], 0.0))
                 / abs(stats[f"mean_{which}"]))
