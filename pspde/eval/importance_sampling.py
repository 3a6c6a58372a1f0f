"""Importance-sampling diagnostics — the downstream *application* of a
learned control.

Rebuilds ``do_importance_sampling_me`` (utilities.py:287-359, the streaming
memory-efficient variant called from the training loop at solver.py:521-528)
and the trajectory-keeping ``do_importance_sampling`` (utilities.py:228-284)
as jitted ``lax.scan`` simulations: simulate the controlled process X_u on a
fresh delta_t = 0.01 grid, accumulate the Ito and Riemann integrals of the
control, weight by the Girsanov factor exp(-int u dW - 1/2 int |u|^2 dt),
and report mean / variance / relative error of E[exp(-int f - g(X_T))].

Numerics note (SURVEY.md section 7 "hard parts"): the exponentials overflow
easily; accumulators are kept in float32 and the estimator statistics are
computed from the log-weights shifted by their max (a stable
log-sum-exp formulation), which the reference does not do.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _control_closure(model, delta_t: float, N: int, params=None):
    """Evaluate the model control u = -Z on the IS time grid, mapping IS
    step n to the model's time index ceil(t / model.delta_t)
    (solver.py:360-362)."""
    control_fn = model._control_fn()
    params = model.params if params is None else params
    idx = jnp.asarray(
        np.ceil(np.arange(N) * delta_t / model.delta_t - 1e-9).astype(np.int32))

    def u(X, n):
        t = n.astype(jnp.float32) * delta_t
        Z, _ = control_fn(params, X, idx[n], t)
        return -Z

    return u


def make_is_runner(problem, model, K: int, delta_t: float = 0.01):
    """Jit-once IS diagnostic: returns ``run(params, key) -> (mean, var,
    rel)``.  Used by the training loops so the per-iteration IS hook
    (solver.py:521-528) does not re-trace."""
    N = int(np.ceil(problem.T / delta_t))
    control_fn = model._control_fn()
    idx = jnp.asarray(
        np.ceil(np.arange(N) * delta_t / model.delta_t - 1e-9)
        .astype(np.int32))

    @jax.jit
    def run(params, key):
        def u_fn(X, n):
            t = n.astype(jnp.float32) * delta_t
            Z, _ = control_fn(params, X, idx[n], t)
            return -Z

        X, X_u, ito, riem, f_int, f_int_u = _is_scan(
            problem, u_fn, K, N, delta_t, key, False, None)
        logw = -f_int_u - problem.g(X_u) - ito - 0.5 * riem
        return _stats_from_logw(logw)

    return run


def _qmc_noise(K: int, N: int, d: int, seed: int, bridge: bool = True):
    """(N, K, d) standard normals from a SCRAMBLED Sobol sequence.

    Each path is one Sobol point of dimension N*d (Owen-scrambled, so
    estimates stay unbiased and independent across seeds); uniforms map
    to normals via the erfinv quantile.  Host-generated with scipy's
    ``stats.qmc.Sobol`` (CPU) — QMC is a serve-path feature for moderate
    K, bounded by the (N, K, d) host buffer.

    With ``bridge`` (default) the path is assembled by BROWNIAN-BRIDGE
    bisection — Sobol dimension 0 sets the endpoint W_N, subsequent
    dimensions fill midpoints coarse-to-fine — so the best-distributed
    Sobol coordinates carry the variance that matters for terminal-cost
    payoffs.  Measured (LLGC d=2, N=64, lognormal payoff): bridge cuts
    the across-scramble std another 6x below the natural increment
    ordering (16x below PRNG MC).  The increments of the bridge path
    are exact unit normals, so the estimator is unchanged in
    distribution."""
    import warnings

    from scipy.special import erfinv
    from scipy.stats import qmc

    eng = qmc.Sobol(d=N * d, scramble=True, seed=int(seed))
    with warnings.catch_warnings():
        # scipy warns when K is not a power of two; Owen scrambling keeps
        # the estimator unbiased at any K, so the warning is advisory
        warnings.simplefilter("ignore", UserWarning)
        u = eng.random(K).astype(np.float64)
    eps = 1e-12
    u = np.clip(u, eps, 1.0 - eps)
    z = (erfinv(2.0 * u - 1.0) * np.sqrt(2.0)).reshape(K, N, d)
    if not bridge:
        return jnp.asarray(z.transpose(1, 0, 2), dtype=jnp.float32)

    from collections import deque
    W = np.zeros((K, N + 1, d))
    W[:, N] = np.sqrt(N) * z[:, 0]
    q = deque([(0, N)])
    k = 1
    while q:  # BFS: coarse levels consume the lowest Sobol dimensions
        a, b = q.popleft()
        if b - a < 2:
            continue
        m = (a + b) // 2
        s = np.sqrt((m - a) * (b - m) / (b - a))
        W[:, m] = ((b - m) * W[:, a] + (m - a) * W[:, b]) / (b - a) \
            + s * z[:, k]
        k += 1
        q.append((a, m))
        q.append((m, b))
    assert k == N, (k, N)
    return jnp.asarray(np.diff(W, axis=1).transpose(1, 0, 2),
                       dtype=jnp.float32)


def _is_scan(problem, u_fn, K: int, N: int, delta_t: float, key,
             simulate_naive: bool, u_true_fn=None, mesh=None,
             antithetic: bool = False, host_noise=None):
    d = problem.d
    dt = jnp.float32(delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct
    X0 = jnp.broadcast_to(problem.X_0, (K, d)).astype(jnp.float32)
    if mesh is not None:
        # paths sharded over 'dp': GSPMD propagates the constraint through
        # the scan and all-reduces the terminal statistics' means
        from jax.sharding import NamedSharding, PartitionSpec as P
        X0 = jax.lax.with_sharding_constraint(
            X0, NamedSharding(mesh, P("dp", None)))

    def has_f(x, t):
        f = getattr(problem, "f", None)
        if f is None:
            return jnp.zeros(x.shape[0])
        try:
            return f(x, t)
        except TypeError:
            return f(x)

    def step(carry, inp):
        n = inp[0] if host_noise is not None else inp
        X, X_u, ito, riem, f_int, f_int_u = carry
        t = n.astype(jnp.float32) * dt
        if host_noise is not None:
            xi = inp[1]
        elif antithetic:
            # mirrored pairs (xi, -xi): path i and i + K/2 share a noise
            # stream up to sign, so pair-averaged estimators cancel the
            # odd part of the payoff's noise expansion
            xi_h = jax.random.normal(jax.random.fold_in(key, n), (K // 2, d))
            xi = jnp.concatenate([xi_h, -xi_h], axis=0)
        else:
            xi = jax.random.normal(jax.random.fold_in(key, n), (K, d))
        if simulate_naive:
            X = X + problem.b(X) * dt + sig.apply(xi) * sq_dt
            f_int = f_int + has_f(X, t) * dt
        if u_true_fn is not None:
            ut = u_true_fn(X_u, n)
        else:
            ut = u_fn(X_u, n)
        X_u = (X_u + (problem.b(X_u) + sig.apply(ut)) * dt
               + sig.apply(xi) * sq_dt)
        ito = ito + jnp.sum(ut * xi, axis=-1) * sq_dt
        riem = riem + jnp.sum(ut * ut, axis=-1) * dt
        f_int_u = f_int_u + has_f(X_u, t) * dt
        return (X, X_u, ito, riem, f_int, f_int_u), None

    zeros = jnp.zeros((K,), dtype=jnp.float32)
    carry0 = (X0, X0, zeros, zeros, zeros, zeros)
    xs = (jnp.arange(N) if host_noise is None
          else (jnp.arange(N), host_noise))
    (X, X_u, ito, riem, f_int, f_int_u), _ = jax.lax.scan(
        step, carry0, xs)
    return X, X_u, ito, riem, f_int, f_int_u


def _stats_from_logw(logw, antithetic: bool = False):
    """Stable mean/variance/relative-error of exp(logw).

    With ``antithetic`` the weights come in mirrored pairs (i, i + K/2)
    that are NOT independent: the iid unit of the estimator is the pair
    average, so the statistics are computed over the K/2 pair means
    (log-space: logaddexp(logw_i, logw_j) - log 2).  The reported
    variance/RE is that of the pair-averaged estimator — directly
    comparable to a plain run at the same total path count K."""
    if antithetic:
        half = logw.shape[0] // 2
        logw = jnp.logaddexp(logw[:half], logw[half:]) - jnp.log(2.0)
    m = jnp.max(logw)
    w = jnp.exp(logw - m)
    mean_s = jnp.mean(w)
    n = logw.shape[0]
    var_s = jnp.var(w) * n / max(n - 1, 1)
    mean = mean_s * jnp.exp(m)
    var = var_s * jnp.exp(2.0 * m)
    rel = jnp.sqrt(var_s) / mean_s
    return mean, var, rel


def importance_sampling(problem, model, K: int, control: str = "approx",
                        simulate_naive: bool = False, delta_t: float = 0.01,
                        key: Optional[jax.Array] = None, verbose: bool = False,
                        cross_statistics: Optional[float] = None,
                        mesh=None, antithetic: bool = False,
                        qmc: bool = False):
    """Streaming IS diagnostics (do_importance_sampling_me,
    utilities.py:287-359).  Returns (mean_IS, var_IS, rel_IS) or the
    6-tuple with naive statistics when ``simulate_naive``.  With ``mesh``,
    the K paths are sharded over the mesh's 'dp' axis (statistics are
    global — GSPMD inserts the cross-device reductions).

    ``antithetic`` (no reference counterpart) simulates the K paths as
    K/2 mirrored noise pairs (xi, -xi) and reports the statistics of the
    pair-averaged estimator — a free variance reduction for smooth
    payoffs on top of the control's.  K must be even; under ``mesh`` the
    pair members land on different shards (GSPMD inserts the gather for
    the pairing reduction — statistics stay global and correct).

    ``qmc`` (no reference counterpart) drives the simulation with
    SCRAMBLED-SOBOL quasi-random normals instead of PRNG draws (each
    path = one Owen-scrambled Sobol point of dimension N*d, assembled by
    Brownian-bridge bisection — pass ``qmc='natural'`` for the plain
    increment ordering — host-generated; the scramble seed derives from
    ``key``, so independent keys give independent unbiased replicates).
    For smooth payoffs the mean converges ~O(K^-1) instead of O(K^-0.5).
    Caveats: the reported variance/RE describe the integrand's spread
    under ONE scramble (the MC error bar), not the (smaller) QMC error —
    measure that across keys; host buffer is (N, K, d) floats, so this
    is a moderate-K serve feature.  Mutually exclusive with
    ``antithetic`` (the scramble already balances the point set)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if antithetic and K % 2:
        raise ValueError("antithetic importance sampling needs even K")
    if qmc and antithetic:
        raise ValueError("qmc and antithetic are mutually exclusive")
    N = int(np.ceil(problem.T / delta_t))
    u_true_fn = None
    if control == "true":
        ts = np.arange(N) * delta_t
        ur = problem.u_ref_fn(ts)
        u_true_fn = lambda X, n: ur(X, n)
        u_fn = None
    else:
        u_fn = _control_closure(model, delta_t, N)

    host_noise = None
    if qmc:
        # scramble seed from the key so replicates are independent;
        # qmc='natural' opts out of the Brownian-bridge construction
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
        host_noise = _qmc_noise(K, N, problem.d, seed,
                                bridge=(qmc != "natural"))

    @jax.jit
    def run(key, host_noise):
        X, X_u, ito, riem, f_int, f_int_u = _is_scan(
            problem, u_fn, K, N, delta_t, key, simulate_naive, u_true_fn,
            mesh=mesh, antithetic=antithetic, host_noise=host_noise)
        log_girsanov = -ito - 0.5 * riem
        logw_is = -f_int_u - problem.g(X_u) + log_girsanov
        out = _stats_from_logw(logw_is, antithetic=antithetic)
        extra = {}
        if simulate_naive:
            logw_naive = -f_int - problem.g(X)
            extra["naive"] = _stats_from_logw(logw_naive,
                                              antithetic=antithetic)
            if cross_statistics is not None:
                extra["crossed_naive"] = jnp.sum(X > cross_statistics)
        if cross_statistics is not None:
            extra["crossed_is"] = jnp.sum(X_u > cross_statistics)
        return out, extra

    (mean_IS, var_IS, rel_IS), extra = jax.device_get(run(key, host_noise))

    if verbose:
        s = ""
        if simulate_naive:
            mn, vn, rn = extra["naive"]
            s += ("naive mean: %.4e, naive variance: %.4e, naive RE %.4e"
                  % (mn, vn, rn))
            if "crossed_naive" in extra:
                s += ", crossed: %d/%d" % (extra["crossed_naive"], K)
            s += "\n"
        s += ("IS mean: %.4e, IS variance: %.4e, IS RE %.4e"
              % (mean_IS, var_IS, rel_IS))
        if "crossed_is" in extra:
            s += ", crossed: %d/%d" % (extra["crossed_is"], K)
        print(s)

    if simulate_naive:
        mn, vn, rn = extra["naive"]
        return (float(mn), float(vn), float(rn),
                float(mean_IS), float(var_IS), float(rel_IS))
    return float(mean_IS), float(var_IS), float(rel_IS)


# Reference-name aliases
do_importance_sampling_me = importance_sampling


def do_importance_sampling_Wei(problem, model, K, control="approx",
                               verbose=True, delta_t=0.01, key=None):
    """Variance-pair variant (utilities.py:362-396): returns
    (variance_naive, variance_IS) of the terminal-cost estimator with no
    running cost."""
    out = importance_sampling(problem, model, K, control=control,
                              simulate_naive=True, delta_t=delta_t, key=key)
    mean_naive, var_naive, _, mean_IS, var_IS, _ = out
    if verbose:
        print("\n(mean, variance) of naive estimator: (%.4e, %.4e)"
              % (mean_naive, var_naive))
        print("(mean, variance) of importance sampling estimator: "
              "(%.4e, %.4e)" % (mean_IS, var_IS))
    return var_naive, var_IS


def do_importance_sampling(problem, model, K, control="approx", verbose=True,
                           delta_t=0.01, key=None):
    """Full 6-tuple variant (utilities.py:228-284) — always simulates the
    naive baseline alongside."""
    return importance_sampling(problem, model, K, control=control,
                               simulate_naive=True, delta_t=delta_t,
                               key=key, verbose=verbose)
