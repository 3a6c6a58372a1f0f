"""Checkpoint / resume (params + optimizer state) as numpy ``.npz`` files.

Upgrades the reference's ``save_networks`` / ``load_networks``
(solver.py:313-332), which stored only network weights (optimizer state
was lost and Adam restarted on resume); here the optax state is saved
alongside the parameters.

A checkpoint stores the flattened leaves of one PyTree plus the string
form of its tree structure.  Loading needs a target tree of the same
structure (the solver's own params / optimizer state); a structure,
shape or dtype mismatch raises instead of silently mis-assigning leaves.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np


def _unwrap_key(key):
    """(raw_uint32_data, impl_name_or_None): typed PRNG keys (e.g. the
    solvers' rng_impl='rbg' mode) are stored as their raw key data plus
    the impl name, since .npz holds only plain numeric arrays."""
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        return jax.random.key_data(key), str(jax.random.key_impl(key))
    return key, None


def _save_tree(path: str, tree) -> str:
    leaves, treedef = jax.tree.flatten(tree)
    arrays = {"treedef": np.array(str(treedef))}
    for i, leaf in enumerate(leaves):
        data, impl = _unwrap_key(leaf)
        arrays[f"leaf_{i}"] = np.asarray(jax.device_get(data))
        if impl is not None:
            arrays[f"impl_{i}"] = np.array(impl)
    path = os.path.abspath(path)
    with open(path, "wb") as f:   # a file object keeps np.savez's name
        np.savez(f, **arrays)
    return path


def _load_tree(path: str, like):
    leaves_like, treedef = jax.tree.flatten(like)
    with np.load(os.path.abspath(path)) as z:
        saved = str(z["treedef"])
        if saved != str(treedef):
            raise ValueError(
                "checkpoint tree structure does not match the target:\n"
                f"  saved:  {saved}\n  target: {treedef}")
        leaves = []
        for i, ref in enumerate(leaves_like):
            arr = z[f"leaf_{i}"]
            ref_data, ref_impl = _unwrap_key(ref)
            if (arr.shape != tuple(ref_data.shape)
                    or arr.dtype != ref_data.dtype):
                raise ValueError(
                    f"checkpoint leaf {i}: saved {arr.dtype}{arr.shape}, "
                    f"target {ref_data.dtype}{tuple(ref_data.shape)}")
            leaf = jnp.asarray(arr)
            if f"impl_{i}" in z.files:
                leaf = jax.random.wrap_key_data(leaf,
                                                impl=str(z[f"impl_{i}"]))
            elif ref_impl is not None:
                raise ValueError(f"checkpoint leaf {i}: target is a typed "
                                 "PRNG key, saved leaf is raw data")
            leaves.append(leaf)
    return jax.tree.unflatten(treedef, leaves)


def save_params(path: str, params, opt_state=None):
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    return _save_tree(path, payload)


def load_params(path: str, params_like, opt_state_like=None):
    target = {"params": params_like}
    if opt_state_like is not None:
        target["opt_state"] = opt_state_like
    restored = _load_tree(path, target)
    return restored["params"], restored.get("opt_state", opt_state_like)


def save_training_state(path: str, solver):
    """Full failure-recovery checkpoint (SURVEY.md section 5.3/5.4):
    params + optimizer state + the training PRNG key (.npz) and the step
    counter + metric logs (JSON sidecar).  ``load_training_state`` then
    resumes ``train()`` mid-run with the identical trajectory the
    uninterrupted run would have produced (same noise stream, same Adam
    moments, contiguous logs)."""
    path = _save_tree(path, {"params": solver.params,
                             "opt_state": solver.opt_state,
                             "train_key": solver._train_key})
    logs = {name: getattr(solver, name) for name in solver._LOG_ATTRS}
    with open(path + ".logs.json", "w") as f:
        json.dump({"step": solver.step, "logs": logs}, f)
    return path


def load_training_state(path: str, solver):
    """Restore a ``save_training_state`` checkpoint into `solver`."""
    restored = _load_tree(path, {"params": solver.params,
                                 "opt_state": solver.opt_state,
                                 "train_key": solver._train_key})
    with open(os.path.abspath(path) + ".logs.json") as f:
        meta = json.load(f)
    solver.params = restored["params"]
    solver.opt_state = restored["opt_state"]
    solver._train_key = restored["train_key"]
    solver.step = int(meta["step"])
    for name, value in meta["logs"].items():
        setattr(solver, name, value)
    return solver
