"""Function-space (ansatz) library as plain JAX modules.

Rebuilds every approximator class of the reference's ``function_space.py``
plus the notebook-local variants (single optax optimizer over the combined
param PyTree replaces the reference's per-module Adam; cf.
function_space.py:18,104,131,150,168,185 and solver.py:194-200):

  * ``DenseNet``       — function_space.py:116-140: concat-skip MLP with
                         relu(Wx+b)^2 hidden features, weights 0.1*randn,
                         zero bias.  ``bias_init_value`` and
                         ``output_relu`` cover the notebook variants
                         (FP-eigenvalue nb cell 1: bias 0.8 + relu output;
                         Schroedinger nb cell 4: bias 0.1).
  * ``DenseNetTanh``   — function_space.py:143-158: nn.Linear + tanh concat.
  * ``DenseNetTanh2``  — Committor nb cell 1: 0.1*randn weights, tanh(.)^2.
  * ``TanhMLP``        — ``MySequential``, function_space.py:177-195:
                         [d_in, 30, 30, d_out] tanh MLP, N(0, 0.01) init.
  * ``BatchNormMLP``   — ``NN``, function_space.py:82-113 (functional
                         batch statistics — the reference only ever runs it
                         in training mode, which uses per-batch stats).
  * ``ReluMLP1d``      — ``NN_Nik``, function_space.py:161-174.
  * ``Sines``          — function_space.py:66-79.
  * ``ScalarParam``    — ``SingleParam``, function_space.py:6-21 (used for
                         y_0 and the eigenvalue lambda).
  * ``ConstantVector`` — ``Constant``, function_space.py:24-34.
  * ``LinearLQ``       — ``Linear``, function_space.py:37-48.
  * ``Affine``         — function_space.py:51-63.

Calling convention (every solver and evaluator relies on it):
``net.init(key, x) -> {"params": tree}`` and ``net.apply(variables, x)``.
A module is a frozen dataclass of hyperparameters; the parameter tree is
plain nested dicts.  Dense layers are named ``Dense_<i>`` in call order and
hold ``kernel`` (d_in, d_out) and ``bias`` (d_out,), which is the layout
ansatz/transposed.py and the tp-sharding helper index by name.  Unlabelled
dense layers use LeCun-normal kernels (truncated normal, fan-in scaled)
and zero biases.  A custom ansatz subclasses :class:`Module` and defines
``_init(key, x) -> params`` and ``_apply(params, x)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import initializers as init

_module = dataclasses.dataclass(frozen=True)


class Module:
    """Base of the ansatz modules: ``init`` / ``apply`` around the
    subclass's ``_init(key, x) -> params`` and ``_apply(params, x)``."""

    def init(self, key, x):
        return {"params": self._init(key, jnp.asarray(x))}

    def apply(self, variables, x):
        return self._apply(variables["params"], x)

    def _init(self, key, x):
        raise NotImplementedError

    def _apply(self, params, x):
        raise NotImplementedError


def _scaled_normal(scale):
    def fn(key, shape, dtype=jnp.float32):
        return scale * jax.random.normal(key, shape, dtype)
    return fn


def _dense_params(key, d_in, d_out, kernel_init=init.lecun_normal(),
                  bias_init=init.zeros, use_bias=True):
    k_w, k_b = jax.random.split(key)
    p = {"kernel": kernel_init(k_w, (d_in, d_out), jnp.float32)}
    if use_bias:
        p["bias"] = bias_init(k_b, (d_out,), jnp.float32)
    return p


def _dense(p, x, dtype=None):
    """Affine layer x @ kernel + bias.  Inputs and parameters are cast to
    ``dtype`` (default: their common type), so a bf16 ``dtype`` runs the
    matmul in bf16 while the stored parameters stay f32."""
    kernel, bias = p["kernel"], p.get("bias")
    if dtype is None:
        dtype = jnp.result_type(x, kernel, *([] if bias is None else [bias]))
    y = lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                        (((x.ndim - 1,), (0,)), ((), ())))
    if bias is not None:
        y = y + bias.astype(dtype)
    return y


def _skip_widths(d_in, arch):
    """Input widths of the layers of a concat-skip net."""
    widths, w = [], d_in
    for width in arch:
        widths.append(w)
        w += width
    return widths + [w]


@_module
class DenseNet(Module):
    """Concat-skip DenseNet with relu^2 hidden features.

    Layer i maps the running feature vector (width sum(dims[:i+1])) through
    a dense layer; hidden outputs are relu(.)^2 and concatenated onto the
    features (function_space.py:133-140).
    """

    d_out: int
    arch: Sequence[int] = (30, 30)
    weight_scale: float = 0.1
    bias_init_value: float = 0.0
    output_relu: bool = False
    compute_dtype: Optional[jnp.dtype] = None  # e.g. bf16 matmuls

    def _init(self, key, x):
        outs = [*self.arch, self.d_out]
        keys = jax.random.split(key, len(outs))
        return {f"Dense_{i}": _dense_params(
                    keys[i], w_in, w_out,
                    _scaled_normal(self.weight_scale),
                    init.constant(self.bias_init_value))
                for i, (w_in, w_out) in enumerate(
                    zip(_skip_widths(x.shape[-1], self.arch), outs))}

    def _apply(self, p, x):
        feats = x
        for i in range(len(self.arch)):
            h = _dense(p[f"Dense_{i}"], feats, self.compute_dtype)
            feats = jnp.concatenate(
                [feats, (jax.nn.relu(h) ** 2).astype(x.dtype)], axis=-1)
        out = _dense(p[f"Dense_{len(self.arch)}"], feats, self.compute_dtype)
        if self.output_relu:
            out = jax.nn.relu(out)
        return out.astype(x.dtype)


def _skip_init(key, d_in, arch, d_out, kernel_init=init.lecun_normal(),
               bias_init=init.zeros):
    outs = [*arch, d_out]
    keys = jax.random.split(key, len(outs))
    return {f"Dense_{i}": _dense_params(keys[i], w_in, w_out, kernel_init,
                                        bias_init)
            for i, (w_in, w_out) in enumerate(
                zip(_skip_widths(d_in, arch), outs))}


def _skip_apply(p, x, n_hidden, act):
    feats = x
    for i in range(n_hidden):
        feats = jnp.concatenate([feats, act(_dense(p[f"Dense_{i}"], feats))],
                                axis=-1)
    return _dense(p[f"Dense_{n_hidden}"], feats)


@_module
class DenseNetTanh(Module):
    """Concat-skip net with tanh hidden features (function_space.py:143-158).
    ``output_relu`` covers the notebook ``DenseNet_2`` variant used for
    nonnegative eigenfunctions (Schroedinger notebook cell 4)."""

    d_out: int
    arch: Sequence[int] = (30, 30)
    output_relu: bool = False

    def _init(self, key, x):
        return _skip_init(key, x.shape[-1], self.arch, self.d_out)

    def _apply(self, p, x):
        out = _skip_apply(p, x, len(self.arch), jnp.tanh)
        return jax.nn.relu(out) if self.output_relu else out


@_module
class DenseNetTanh2(Module):
    """Concat-skip net with tanh(.)^2 features and 0.1*randn weights
    (Committor function.ipynb cell 1)."""

    d_out: int
    arch: Sequence[int] = (30, 30)
    weight_scale: float = 0.1

    def _init(self, key, x):
        return _skip_init(key, x.shape[-1], self.arch, self.d_out,
                          _scaled_normal(self.weight_scale))

    def _apply(self, p, x):
        return _skip_apply(p, x, len(self.arch), lambda h: jnp.tanh(h) ** 2)


@_module
class DenseNetRelu(Module):
    """Concat-skip net with plain relu hidden features, weights
    0.01*randn + 0.01 and bias 0.1, linear output (the ``DenseNet_relu``
    class local to "Eigenvalue - nonlinear Schroedinger equation,
    d = 10.ipynb" cell 4)."""

    d_out: int
    arch: Sequence[int] = (30, 30)

    def _init(self, key, x):
        def kinit(k, shape, dtype=jnp.float32):
            return 0.01 * jax.random.normal(k, shape, dtype) + 0.01
        return _skip_init(key, x.shape[-1], self.arch, self.d_out, kinit,
                          init.constant(0.1))

    def _apply(self, p, x):
        return _skip_apply(p, x, len(self.arch), jax.nn.relu)


@_module
class TanhMLP(Module):
    """[d_in, 30, 30, d_out] tanh MLP with N(0, 0.01) weight AND bias init
    — the default 'inner' time-approx control net (``MySequential``,
    function_space.py:177-195, used at solver.py:91)."""

    d_out: int
    hidden: Sequence[int] = (30, 30)
    init_scale: float = 0.01
    compute_dtype: Optional[jnp.dtype] = None  # e.g. bf16 matmuls

    def _init(self, key, x):
        dims = [x.shape[-1], *self.hidden, self.d_out]
        keys = jax.random.split(key, len(dims) - 1)
        s = _scaled_normal(self.init_scale)
        return {f"Dense_{i}": _dense_params(keys[i], dims[i], dims[i + 1],
                                            s, s)
                for i in range(len(dims) - 1)}

    def _apply(self, p, x):
        in_dtype = x.dtype
        for i in range(len(self.hidden)):
            x = jnp.tanh(_dense(p[f"Dense_{i}"], x, self.compute_dtype))
        out = _dense(p[f"Dense_{len(self.hidden)}"], x, self.compute_dtype)
        return out.astype(in_dtype)


@_module
class BatchNormMLP(Module):
    """Plain MLP with per-batch normalization layers (``NN``,
    function_space.py:82-113).  The reference never uses running averages
    in its training loops, so normalization uses the batch statistics."""

    d_out: int
    hidden: int = 20

    def _init(self, key, x):
        k0, k1 = jax.random.split(key)
        p = {}
        for i, w in enumerate((x.shape[-1], self.hidden, self.d_out)):
            p[f"bn_scale_{i}"] = jnp.ones((w,), jnp.float32)
            p[f"bn_bias_{i}"] = jnp.zeros((w,), jnp.float32)
        normal = init.normal(1.0)
        p["Dense_0"] = _dense_params(k0, x.shape[-1], self.hidden, normal,
                                     use_bias=False)
        p["Dense_1"] = _dense_params(k1, self.hidden, self.d_out, normal,
                                     use_bias=False)
        return p

    def _apply(self, p, x):
        def bn(v, i):
            mu = jnp.mean(v, axis=0, keepdims=True)
            var = jnp.var(v, axis=0, keepdims=True)
            return (p[f"bn_scale_{i}"] * (v - mu) / jnp.sqrt(var + 1e-5)
                    + p[f"bn_bias_{i}"])

        x = bn(x, 0)
        x = jax.nn.relu(bn(_dense(p["Dense_0"], x), 1))
        return bn(_dense(p["Dense_1"], x), 2)


@_module
class ReluMLP1d(Module):
    """Tiny 1-d two-layer ReLU net (``NN_Nik``, function_space.py:161-174)."""

    hidden: int = 16

    def _init(self, key, x):
        k0, k1 = jax.random.split(key)
        return {"Dense_0": _dense_params(k0, x.shape[-1], self.hidden),
                "Dense_1": _dense_params(k1, self.hidden, 1)}

    def _apply(self, p, x):
        return _dense(p["Dense_1"], jax.nn.relu(_dense(p["Dense_0"], x)))


@_module
class Sines(Module):
    """Linear combination of M sine basis functions, d = 1 only
    (function_space.py:66-79)."""

    M: int = 10

    def _init(self, key, x):
        return {"alpha": init.normal(1.0)(key, (self.M, 1), jnp.float32)}

    def _apply(self, p, x):
        omega = jnp.linspace(1.0, float(self.M), self.M)[None, :]
        return jnp.sin(x @ omega) @ p["alpha"]


@_module
class ScalarParam(Module):
    """Single learnable scalar broadcast over the batch (``SingleParam``,
    function_space.py:6-21).  Used for Y_0 and the eigenvalue lambda."""

    initial: Optional[float] = 0.0  # None => random

    def _init(self, key, x):
        fn = (init.normal(1.0) if self.initial is None
              else init.constant(self.initial))
        return {"Y_0": fn(key, (1,), jnp.float32)}

    def _apply(self, p, x):
        return jnp.broadcast_to(p["Y_0"], (x.shape[0],))


@_module
class ConstantVector(Module):
    """Learnable constant d-vector (``Constant``, function_space.py:24-34)."""

    d: int

    def _init(self, key, x):
        return {"c": init.normal(1.0)(key, (self.d,), jnp.float32)}

    def _apply(self, p, x):
        return jnp.broadcast_to(p["c"], (x.shape[0], self.d))


@_module
class LinearLQ(Module):
    """LQ-structured linear control u = Q^{-1} B^T F x with learnable F
    (``Linear``, function_space.py:37-48).

    ``init_scale`` scales the N(0,1) init of F (reference: 1.0).  At
    large d a standard-normal F is a violent initial control (|u| ~ d
    per unit |x|) that destabilizes the adaptive forward process and
    makes u_L2[0] meaningless as a |u*| yardstick — init_scale=0.0
    starts from the zero control instead."""

    B: jnp.ndarray
    Q: jnp.ndarray
    init_scale: float = 1.0

    def _init(self, key, x):
        d = self.B.shape[0]
        return {"F": init.normal(self.init_scale)(key, (d, d), jnp.float32)}

    def _apply(self, p, x):
        gain = jnp.linalg.inv(self.Q) @ self.B.T @ p["F"]
        return x @ gain.T


@_module
class LinearLQTime(Module):
    """Time-conditioned LQ-structured linear control for
    ``time_approx='inner'`` (input ``[t, x]``):

        u(t, x) = Q^{-1} B^T F_hat(t) x,
        F_hat(t) = sum_j T_j(2 t / T - 1) F_j

    with a Chebyshev time basis over ``degree + 1`` learnable (d, d)
    matrices, zero-initialized.  The exact LQGC Riccati control
    u* = -Q^{-1} B^T F(t) x (problems.py:169-175) is LINEAR in x with a
    smooth (Riccati) time dependence, so this ansatz contains it up to
    the Chebyshev interpolation error of F(t) — unlike the reference's
    per-step ``Linear`` (function_space.py:37-48, one independent F per
    time step, each seeing 1/N of the loss signal), every step trains
    the same (degree + 1) matrices.  No reference counterpart: this is
    the shared-across-steps LQ ansatz the d=100 BASELINE config needs.
    """

    B: jnp.ndarray
    Q: jnp.ndarray
    T: float
    degree: int = 8

    def _init(self, key, x):
        d = self.B.shape[0]
        return {"F": jnp.zeros((self.degree + 1, d, d), jnp.float32)}

    def _apply(self, p, tx):
        t, x = tx[:, :1], tx[:, 1:]
        s = 2.0 * t / self.T - 1.0
        feats = [jnp.ones_like(s), s]
        for _ in range(self.degree - 1):
            feats.append(2.0 * s * feats[-1] - feats[-2])
        phi = jnp.concatenate(feats[: self.degree + 1], axis=1)  # (K, J)
        gain = jnp.linalg.inv(self.Q) @ self.B.T               # (d, d)
        # J matmuls of (K, d) x (d, d); the per-row basis contraction is
        # O(K J d)
        xF = jnp.einsum("ke,jde->kjd", x, p["F"])
        return jnp.einsum("kj,kjd->kd", phi, xF) @ gain.T


@_module
class Affine(Module):
    """Zero-initialized affine map A x + b (function_space.py:51-63)."""

    d_out: int

    def _init(self, key, x):
        return {"A": jnp.zeros((self.d_out, x.shape[-1]), jnp.float32),
                "b": jnp.zeros((1, self.d_out), jnp.float32)}

    def _apply(self, p, x):
        return x @ p["A"].T + p["b"]
