"""Test-error computation on fresh in-domain samples
(rebuilds compute_test_error, utilities.py:440-472) plus a SAME-STATE
control-error metric the reference lacks (see control_test_error)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..rollout.sampling import sample_domain


def compute_test_error(v_fn, problem, K: int, key, modus: str = "elliptic"):
    """Returns (L2_error, mean_absolute_error, mean_relative_error) of the
    value approximation against problem.v_ref on a fresh uniform sample.

    ``modus='parabolic'`` appends t ~ U(0, T) to the net input and
    evaluates the reference at (x, t) (utilities.py:456-464).
    """
    kx, kt = jax.random.split(key)
    X = sample_domain(kx, problem.geometry, K, problem.d)
    if modus == "parabolic":
        t = jax.random.uniform(kt, (K,)) * problem.T
        v_true = problem.v_ref(X, t)
        v_est = v_fn(jnp.concatenate([X, t[:, None]], axis=-1))
    else:
        v_true = problem.v_ref(X)
        v_est = v_fn(X)
    diff = v_true - v_est
    L2 = jnp.mean(diff ** 2)
    mae = jnp.mean(jnp.abs(diff))
    mre = jnp.mean(jnp.abs(diff) / v_true)
    return L2, mae, mre


def control_test_error(problem, model, K: int = 4096, key=None,
                       params=None):
    """Unbiased relative control L2 error: rel = sqrt(
    E int |u_hat(t_n, X_n) - u*(t_n, X_n)|^2 dt / E int |u*|^2 dt ),
    both factors evaluated at the SAME state X_n along paths driven by
    the learned control.

    Why this exists: the training-loop u_L2 diagnostic matches the
    reference's semantics (solver.py:491-494) — the ansatz is evaluated
    at X_n but u_true at the post-step X_{n+1} — which for a
    state-dependent u* injects an O(sqrt(dt)) noise floor:
    u*(X_{n+1}) - u*(X_n) ~ (grad u*) sigma xi sqrt(dt).  Measured
    round 4 on LQGC: the EXACT Riccati control reads rel
    0.165 at dt=0.01 under that metric (0.083 at dt=0.0025 — the
    sqrt(dt) signature), so the reference-semantics number cannot
    distinguish a converged control from a 16%-wrong one.  This metric
    can; no reference counterpart.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    control_fn = model._control_fn()
    params = model.params if params is None else params
    N, dt = model.N, model.delta_t
    sq_dt = float(np.sqrt(dt))
    sig = problem.sigma_struct
    ts = np.arange(N) * dt
    u_ref = problem.u_ref_fn(ts)
    X0 = jnp.broadcast_to(problem.X_0.astype(jnp.float32),
                          (K, problem.d))

    def step(carry, n):
        X, num, den = carry
        t = n.astype(jnp.float32) * dt
        Z, _ = control_fn(params, X, n, t)
        u_hat = -Z
        u_star = u_ref(X, n)
        num = num + jnp.sum((u_hat - u_star) ** 2, axis=-1) * dt
        den = den + jnp.sum(u_star ** 2, axis=-1) * dt
        xi = jax.random.normal(jax.random.fold_in(key, n), X.shape,
                               X.dtype)
        X = (X + (problem.b(X) + sig.apply(u_hat)) * dt
             + sig.apply(xi) * sq_dt)
        return (X, num, den), None

    z = jnp.zeros((K,), jnp.float32)
    (X, num, den), _ = jax.lax.scan(
        step, (X0, z, z), jnp.arange(N, dtype=jnp.int32))
    return float(jnp.sqrt(jnp.mean(num) / jnp.mean(den)))
