"""Device-mesh and sharding helpers.

The reference is single-GPU (``pt.device('cuda')`` hardcoded at
solver.py:36,573,947); the only parallel axis its algorithms have is the
trajectory-ensemble ('paths') batch dim K.  Here that axis is sharded
across devices as the 'dp' mesh axis; parameters are replicated
(optionally sharded over a 'tp' axis for very wide ansatz layers).  All
cross-device communication is inserted by XLA from sharding constraints:
loss means become all-reduces (NCCL over NVLink on GPUs), parameter
gradients are psummed by GSPMD — no hand-written collectives needed at
these payload sizes (scalars and parameter-sized tensors; latency-, not
bandwidth-bound).  The cards of one host are joined all to all, so the
mesh is a plain (dp, tp) grid that follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Multi-process initialization (jax.distributed).

    After this, ``jax.devices()`` spans all processes and the same
    ``make_mesh`` + sharding-constraint path scales across them.  Pass
    ``coordinator_address`` ('host:port'), ``num_processes`` and
    ``process_id`` explicitly where no cluster environment provides
    them.  Benign no-op ONLY when JAX distributed was already
    initialized; any other failure — bad coordinator address, port
    clash, inconsistent process counts — re-raises so a
    half-initialized run cannot masquerade as success."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        # jax raises 'distributed.initialize should only be called once.'
        msg = str(e).lower()
        if "only be called once" in msg or "already initialized" in msg:
            return
        raise


def make_mesh(n_dp: Optional[int] = None, n_tp: int = 1,
              devices=None) -> Mesh:
    """Create a ('dp', 'tp') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_dp is None:
        n_dp = n // n_tp
    assert n_dp * n_tp <= n, f"need {n_dp * n_tp} devices, have {n}"
    dev = np.array(devices[: n_dp * n_tp]).reshape(n_dp, n_tp)
    return Mesh(dev, ("dp", "tp"))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (path-ensemble) axis over 'dp'."""
    return NamedSharding(mesh, P("dp", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x, mesh: Optional[Mesh]):
    if mesh is None:
        return x
    return jax.device_put(x, batch_sharding(mesh, x.ndim))


def constrain_batch(x, mesh: Optional[Mesh]):
    """In-graph sharding constraint on the path axis."""
    if mesh is None:
        return x
    return jax.lax.with_sharding_constraint(x, batch_sharding(mesh, x.ndim))


def shard_params_tp(params, mesh: Mesh):
    """Column-shard dense kernels over the 'tp' mesh axis.

    The ansatz nets are small (10^3-10^4 params; SURVEY.md 2.6: TP
    unnecessary at reference scale), but for very wide custom nets or very
    large d this shards every 2-d kernel whose output dim divides the tp
    axis size; all other leaves (biases, scalars, opt state) replicate.
    GSPMD then partitions the matmuls and inserts the collectives.
    """
    n_tp = mesh.shape["tp"]

    def put(path_leaf):
        leaf = path_leaf
        if (hasattr(leaf, "ndim") and leaf.ndim >= 2
                and leaf.shape[-1] % n_tp == 0 and leaf.shape[-1] >= n_tp):
            spec = P(*([None] * (leaf.ndim - 1) + ["tp"]))
        else:
            spec = P()
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(put, params)
