"""Per-timestep gradient-variance diagnostics.

Rebuilds ``Solver.get_gradient_variances`` (solver.py:234-281) and the
machinery behind the "Relative errors of gradients" notebook: for the
per-step ('outer') control ansatz, compute per-sample gradients of the
terminal value process Y_k w.r.t. each step's network parameters, form
per-sample loss-gradient estimates for the moment / log-variance losses,
and report the componentwise relative statistical error
sqrt(Var) / |Mean|.

One ``jax.jacrev`` of the whole rollout gives all (K, N, p)
per-sample per-step gradients in a single batched computation, replacing
the reference's O(K * N) Python loop of ``backward(retain_graph=True)``
calls (solver.py:238-251).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _flatten_per_step(tree, K, N):
    """Pytree of jacobian leaves (K, N, *param_shape) -> (K, N, p)."""
    leaves = [jnp.reshape(l, (K, N, -1)) for l in jax.tree.leaves(tree)]
    return jnp.concatenate(leaves, axis=-1)


def gradient_variances(solver, key, loss_method=None):
    """Returns the (N, p) matrix of relative gradient errors for an
    'outer' time-approx HJBSolver, NaNs zeroed (solver.py:279-281)."""
    assert solver.time_approx == "outer", \
        "per-step gradient variances require time_approx='outer'"
    loss_method = loss_method or solver.loss_method
    control_fn = solver._control_fn()
    y_init = solver._y_init_fn()
    cfg = solver._rollout_cfg(0)
    problem = solver.problem
    K, d = solver.K, solver.d
    N = solver.N

    from ..rollout.sde import hjb_rollout

    other = {k: v for k, v in solver.params.items() if k != "z"}

    def outputs(z_params):
        params = {"z": z_params, **other}
        X0 = jnp.broadcast_to(problem.X_0, (K, d))
        Y0 = y_init(params, X0)
        out = hjb_rollout(cfg, problem, control_fn, params, X0, Y0, key)
        return out.Y, problem.g(out.X)

    (Y, gX) = outputs(solver.params["z"])
    jac_Y, jac_g = jax.jacrev(outputs)(solver.params["z"])
    gY = _flatten_per_step(jac_Y, K, N)          # (K, N, p)
    gG = _flatten_per_step(jac_g, K, N) if solver.adaptive_forward_process \
        else jnp.zeros_like(gY)

    r = (Y - gX)[:, None, None]
    if loss_method == "moment":
        grads = 2.0 * r * (gY - gG)              # solver.py:268-269
    elif loss_method == "log-variance":
        diff = gY - gG
        grads = 2.0 * ((r - jnp.mean(r, axis=0, keepdims=True))
                       * (diff - jnp.mean(diff, axis=0, keepdims=True)))
    else:
        raise ValueError(loss_method)

    mean = jnp.mean(grads, axis=0)               # (N, p)
    n = grads.shape[0]
    var = jnp.var(grads, axis=0) * n / max(n - 1, 1)
    rel = jnp.sqrt(var) / mean
    return jnp.nan_to_num(rel, nan=0.0, posinf=0.0, neginf=0.0)
