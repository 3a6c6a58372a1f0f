"""Column-major (transposed) ansatz evaluation: x as (d_in, K).

Layout note: the solvers' hot rollouts evaluate narrow nets on huge
path batches.  In the row-major layout the output of every matmul is
(K, width) with width 30-100, so the narrow width is the minor-most
dimension.  The transposed form

    out (d_out, K) = dot_general(W (d_in, d_out), x (d_in, K),
                                 contract d_in with d_in)

puts K in the minor-most dimension without ever materializing a
transpose.  Used by the dk-layout rollouts (rollout/sde.py:
hjb_rollout_dk, stopped_rollout_dk), which carry the path state as (d, K)
columns.  The layout was chosen for another accelerator's 128-wide
vector lanes; whether it pays on the GPU is measured per configuration
(PERF.md).

Supports the modules whose hot-loop use matters: TanhMLP (the default
'inner' control net, solver.py:91) and the DenseNet concat-skip family
(function_space.py:116-158).  Equivalence with row-major ``.apply`` is
tested in tests/test_ansatz.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .nets import DenseNet, DenseNetTanh, DenseNetTanh2, TanhMLP


def _dense_T(prm, xT, compute_dtype=None):
    """nn.Dense in column layout: (W (in, out), b (out,)) applied to
    xT (in, K) -> (out, K), contracting over the input dim.

    With a low-precision ``compute_dtype`` the matmul inputs are cast but
    the accumulator stays f32 (``preferred_element_type``)."""
    W, b = prm["kernel"], prm["bias"]
    if compute_dtype is not None:
        W, xT = W.astype(compute_dtype), xT.astype(compute_dtype)
    out = lax.dot_general(W, xT, (((0,), (0,)), ((), ())),
                          preferred_element_type=jnp.float32)
    return out + b.astype(jnp.float32)[:, None]


def transposed_apply(module, params, xT):
    """module.apply(params, x).T computed natively in (d_in, K) layout."""
    p = params["params"]
    n_layers = len(p)

    if isinstance(module, TanhMLP):
        h = xT
        for i in range(n_layers):
            h = _dense_T(p[f"Dense_{i}"], h,
                         getattr(module, "compute_dtype", None))
            if i < n_layers - 1:
                h = jnp.tanh(h)
        return h.astype(xT.dtype)

    if isinstance(module, (DenseNet, DenseNetTanh, DenseNetTanh2)):
        feats = xT
        cdt = getattr(module, "compute_dtype", None)
        for i in range(n_layers - 1):
            h = _dense_T(p[f"Dense_{i}"], feats, cdt)
            if isinstance(module, DenseNet):
                act = (jax.nn.relu(h) ** 2).astype(xT.dtype)
            elif isinstance(module, DenseNetTanh):
                act = jnp.tanh(h)
            else:
                act = jnp.tanh(h) ** 2
            feats = jnp.concatenate([feats, act], axis=0)
        out = _dense_T(p[f"Dense_{n_layers - 1}"], feats, cdt)
        if getattr(module, "output_relu", False):
            out = jax.nn.relu(out)
        return out.astype(xT.dtype)

    raise NotImplementedError(
        f"transposed_apply: unsupported module {type(module).__name__}")
