"""Checkpoints as .npz (utils/checkpoint.py): round trips of params,
optimizer state and typed PRNG keys, and refusal of a mismatched tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pspde.problems import LLGC
from pspde.solvers import HJBSolver
from pspde.utils import load_params, save_params


def _solver(rng_impl):
    return HJBSolver("ckpt", LLGC(d=2, T=0.5), lr=1e-2, L=3, K=32,
                     delta_t=0.1, time_approx="inner", learn_Y_0=True,
                     verbose=False, early_stopping_time=None,
                     rng_impl=rng_impl)


@pytest.mark.parametrize("rng_impl", ["threefry", "rbg"])
def test_training_state_roundtrip(tmp_path, rng_impl):
    s = _solver(rng_impl)
    s.train()
    path = s.save_training_state(out_dir=str(tmp_path))
    s2 = _solver(rng_impl)
    s2.load_training_state(path)
    assert s2.step == 3 and s2.loss_log == s.loss_log
    for a, b in zip(jax.tree.leaves((s.params, s.opt_state)),
                    jax.tree.leaves((s2.params, s2.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    k1, k2 = s._train_key, s2._train_key
    if rng_impl == "threefry":
        np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
    else:
        assert jnp.issubdtype(k2.dtype, jax.dtypes.prng_key)
        assert str(jax.random.key_impl(k2)) == str(jax.random.key_impl(k1))
        np.testing.assert_array_equal(jax.random.key_data(k1),
                                      jax.random.key_data(k2))


def test_load_into_mismatched_tree_raises(tmp_path):
    path = str(tmp_path / "p")
    params = {"params": {"Dense_0": {"kernel": jnp.ones((3, 2)),
                                     "bias": jnp.zeros((2,))}}}
    save_params(path, params)
    got, _ = load_params(path, params)
    np.testing.assert_array_equal(got["params"]["Dense_0"]["kernel"], 1.0)
    renamed = {"params": {"Dense_1": params["params"]["Dense_0"]}}
    with pytest.raises(ValueError, match="tree structure"):
        load_params(path, renamed)
    reshaped = jax.tree.map(lambda a: jnp.zeros(a.shape + (1,)), params)
    with pytest.raises(ValueError, match="leaf"):
        load_params(path, reshaped)
