"""Ornstein-Uhlenbeck / linear-quadratic control problems.

Rebuilds (pure JAX) the reference problems:
  * ``LLGC``            — problems.py:14-65   (OU drift, linear terminal cost)
  * ``LLGC_general_f``  — problems.py:68-115  (non-quadratic control cost)
  * ``LQGC``            — problems.py:118-175 (quadratic running+terminal cost,
                          Riccati-recursion reference solution)
  * sign-flipped LLGC   — "Compare relative errors of losses.ipynb" cell 1
                          (``h = +1/2 |z|^2``), via ``LLGC(h_sign=+1)``.

Reference solutions are exposed as discrete-time tables over a caller-chosen
time grid (``u_ref_fn`` / ``v_ref_fn``): host-side SciPy ``expm`` computes the
matrix exponentials once at setup, the result lives on device, and the hot
training loop looks values up with a gather instead of the reference's
per-step host roundtrip (solver.py:491-494).
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np
from scipy.linalg import expm

from .base import DiffusionMatrix, Geometry, Problem


def _randn(rng: np.random.Generator, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class LLGC(Problem):
    """OU process with linear terminal cost g(x) = alpha^T x.

    dX = A X dt + B dW,  running cost f = 0,  h(t,x,y,z) = h_sign * 1/2 |z|^2.
    The HJB value function and optimal control are closed-form
    (problems.py:51-65).  ``h_sign=-1`` matches problems.py:45-46; ``+1`` the
    loss-statistics notebook variant.
    """

    h_is_y_free = True

    def __init__(self, name="LLGC", d=1, off_diag=0.0, T=5.0, seed=42,
                 h_sign=-1.0):
        super().__init__(d=d, T=float(T))
        self.name = name
        rng = np.random.default_rng(seed)
        A = -np.eye(d, dtype=np.float32) + off_diag * _randn(rng, d, d)
        B = np.eye(d, dtype=np.float32) + off_diag * _randn(rng, d, d)
        self._A_np, self._B_np = A.astype(np.float64), B.astype(np.float64)
        self.A = jnp.asarray(A)
        self.B = jnp.asarray(B)
        self.alpha = jnp.ones((d,), dtype=jnp.float32)
        self.h_sign = float(h_sign)
        self.geometry = Geometry(kind="square", X_l=-2.0, X_r=2.0)
        self._sigma = DiffusionMatrix(self.B)
        # A = -I when off_diag == 0: elementwise drift instead of a dense
        # (K, d) x (d, d) matmul in the hot loop
        self._A_is_neg_identity = (off_diag == 0.0)
        if not np.all(np.linalg.eigvals(self._A_np).real < 0):
            print("not all EV of A are negative")

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        if self._A_is_neg_identity:
            return -x
        return x @ self.A.T

    def f(self, x, t):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def h(self, t, x, y, z):
        return self.h_sign * 0.5 * jnp.sum(z * z, axis=-1)

    def g(self, x):
        return x @ self.alpha

    # -- transposed-coefficient protocol (base.py) for the (d, K)
    # rollout fast paths; batch axis is the COLUMN axis here.
    def b_T(self, xT):
        if self._A_is_neg_identity:
            return -xT
        return jnp.matmul(self.A, xT)

    def h_T(self, t, xT, y, zT):
        return self.h_sign * 0.5 * jnp.sum(zT * zT, axis=0)

    def f_T(self, xT, t):
        return jnp.zeros(xT.shape[1], dtype=xT.dtype)

    def g_T(self, xT):
        return self.alpha @ xT

    # -- reference solution ------------------------------------------------
    def _expm_AT(self, tau: float) -> np.ndarray:
        return expm(self._A_np.T * tau)

    def u_ref_table(self, ts: np.ndarray) -> jnp.ndarray:
        """(len(ts), d) table of the (state-independent) optimal control.

        u*(x, t) = -B^T e^{A^T (T - t)} alpha (problems.py:51-53; we return
        (K, d)-batched rather than the reference's transposed layout).
        """
        alpha = np.ones((self.d,), dtype=np.float64)
        tab = np.stack([-self._B_np.T @ self._expm_AT(self.T - t) @ alpha
                        for t in np.asarray(ts)])
        return jnp.asarray(tab, dtype=jnp.float32)

    def u_ref_fn(self, ts: np.ndarray):
        tab = self.u_ref_table(ts)

        def u_ref(x, i):
            return jnp.broadcast_to(tab[i], x.shape)

        return u_ref

    def _Sigma_int(self, t: float, quad_dt: float = 1e-3) -> np.ndarray:
        """Sigma(t) = int_t^T e^{A(T-s)} B B^T e^{A^T(T-s)} ds (problems.py:55-63)."""
        N = int(np.floor((self.T - t) / quad_dt)) + 1
        S = np.zeros((self.d, self.d))
        for s in np.linspace(t, self.T, N):
            E = expm(self._A_np * (self.T - s))
            S += E @ self._B_np @ self._B_np.T @ E.T * quad_dt
        return S

    def v_ref(self, x, t: float):
        """v(x,t) = alpha^T e^{A(T-t)} x - 1/2 alpha^T Sigma(t) alpha (problems.py:64-65)."""
        alpha = np.ones((self.d,), dtype=np.float64)
        lin = jnp.asarray(self._expm_AT(self.T - t) @ alpha, dtype=jnp.float32)
        const = float(0.5 * alpha @ self._Sigma_int(t) @ alpha)
        return x @ lin - const

    def v_ref_fn(self, ts: np.ndarray):
        alpha = np.ones((self.d,), dtype=np.float64)
        lins = np.stack([self._expm_AT(self.T - t) @ alpha for t in ts])
        consts = np.array([0.5 * alpha @ self._Sigma_int(t) @ alpha for t in ts])
        lins = jnp.asarray(lins, dtype=jnp.float32)
        consts = jnp.asarray(consts, dtype=jnp.float32)

        def v_ref(x, i):
            return x @ lins[i] - consts[i]

        return v_ref


class LLGC_general_f(Problem):
    """OU (A = 0) with non-quadratic control cost (problems.py:68-115).

    h(t,x,y,z) = -(0.8 ((-z)^2)^0.625 + x e^{T-t} - 0.8 e^{1.25 (T-t)})[:, 0]
    demonstrates the losses do not require quadratic running costs
    (problems.py:95-96).
    """

    h_is_y_free = True

    def __init__(self, name="LLGC", d=1, off_diag=0.0, T=5.0, seed=42):
        super().__init__(d=d, T=float(T))
        self.name = name
        rng = np.random.default_rng(seed)
        self.A = jnp.zeros((d, d), dtype=jnp.float32)
        B = np.eye(d, dtype=np.float32) + off_diag * _randn(rng, d, d)
        self._B_np = B.astype(np.float64)
        self.B = jnp.asarray(B)
        self.alpha = -jnp.ones((d,), dtype=jnp.float32)
        self._sigma = DiffusionMatrix(self.B)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return jnp.zeros_like(x)

    def f(self, x, t):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def h(self, t, x, y, z):
        return -(0.8 * ((-z) ** 2) ** 0.625
                 + x * jnp.exp(self.T - t)
                 - 0.8 * jnp.exp(1.25 * (self.T - t)))[:, 0]

    def g(self, x):
        return x @ self.alpha

    def u_ref_fn(self, ts: np.ndarray):
        """problems.py:101-103: -B^T e^{B^T (T-t)} alpha (state-independent)."""
        alpha = -np.ones((self.d,), dtype=np.float64)
        tab = np.stack([-self._B_np.T @ expm(self._B_np.T * (self.T - t)) @ alpha
                        for t in np.asarray(ts)])
        tab = jnp.asarray(tab, dtype=jnp.float32)

        def u_ref(x, i):
            return jnp.broadcast_to(tab[i], x.shape)

        return u_ref


class LQGC(Problem):
    """Linear-quadratic Gaussian control (problems.py:118-175).

    f(x) = x^T P x, g(x) = x^T R x, h = -1/2 |z|^2 - f.  Reference solution
    from the (time-discretized) Riccati recursion computed at init on the
    problem's own ``delta_t`` grid (problems.py:140-152).

    Note: the reference's ``v_true`` (problems.py:173-175) has a sign/shape
    quirk (returns ``-x F x^T + G`` as a (K, K) matrix and integrates G with
    the wrong sign); here ``v_ref`` returns the mathematically consistent
    value ``x^T F_n x + G_n`` with ``G' = -Tr(B B^T F)`` backwards, which
    satisfies ``u* = -sigma^T grad v``.
    """

    h_is_y_free = True

    def __init__(self, name="LQGC", delta_t=0.05, d=1, off_diag=0.0, T=5.0,
                 seed=42):
        super().__init__(d=d, T=float(T))
        self.name = name
        rng = np.random.default_rng(seed)
        A = -np.eye(d) + off_diag * _randn(rng, d, d).astype(np.float64)
        B = np.eye(d) + off_diag * _randn(rng, d, d).astype(np.float64)
        self._A_np, self._B_np = A, B
        self.A = jnp.asarray(A, dtype=jnp.float32)
        self.B = jnp.asarray(B, dtype=jnp.float32)
        self.delta_t = float(delta_t)
        self.N = int(np.floor(self.T / self.delta_t))
        P = 0.5 * np.eye(d)
        Q = 0.5 * np.eye(d)
        R = np.eye(d)
        self.P = jnp.asarray(P, dtype=jnp.float32)
        self.Q = jnp.asarray(Q, dtype=jnp.float32)
        self.R = jnp.asarray(R, dtype=jnp.float32)
        # Riccati recursion, backward Euler (problems.py:140-152)
        F = np.zeros((self.N + 1, d, d))
        F[self.N] = R
        Qinv = np.linalg.inv(Q)
        for n in range(self.N, 0, -1):
            F[n - 1] = F[n] + (A.T @ F[n] + F[n] @ A
                               - F[n] @ B @ Qinv @ B.T @ F[n] + P) * self.delta_t
        G = np.zeros(self.N + 1)
        for n in range(self.N, 0, -1):
            G[n - 1] = G[n] + np.trace(B @ B.T @ F[n]) * self.delta_t
        self._F_np, self._G_np = F, G
        self.F = jnp.asarray(F, dtype=jnp.float32)
        self.G = jnp.asarray(G, dtype=jnp.float32)
        self._Qinv_BT = jnp.asarray(Qinv @ B.T, dtype=jnp.float32)
        self._sigma = DiffusionMatrix(self.B)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return x @ self.A.T

    def f(self, x, t):
        return jnp.einsum("kd,de,ke->k", x, self.P, x)

    def g(self, x):
        return jnp.einsum("kd,de,ke->k", x, self.R, x)

    def h(self, t, x, y, z):
        return -0.5 * jnp.sum(z * z, axis=-1) - self.f(x, t)

    # -- transposed-coefficient protocol (base.py), batch in columns ----
    def b_T(self, xT):
        return jnp.matmul(self.A, xT)

    def f_T(self, xT, t):
        return jnp.sum(xT * jnp.matmul(self.P, xT), axis=0)

    def h_T(self, t, xT, y, zT):
        return -0.5 * jnp.sum(zT * zT, axis=0) - self.f_T(xT, t)

    def _t_index(self, t: float) -> int:
        return int(np.ceil(t / self.delta_t))

    def u_ref_fn(self, ts: np.ndarray):
        """u*(x, t) = -Q^{-1} B^T F_n x with n = ceil(t/dt) (problems.py:169-171)."""
        idx = np.minimum(np.ceil(np.asarray(ts) / self.delta_t).astype(int),
                         self.N)
        # fold -Q^{-1} B^T F_n into one (len(ts), d, d) gain table
        gains = np.stack([-np.linalg.inv(np.asarray(self.Q, dtype=np.float64))
                          @ self._B_np.T @ self._F_np[n] for n in idx])
        gains = jnp.asarray(gains, dtype=jnp.float32)

        def u_ref(x, i):
            return x @ gains[i].T

        return u_ref

    def v_ref_fn(self, ts: np.ndarray):
        idx = np.minimum(np.ceil(np.asarray(ts) / self.delta_t).astype(int),
                         self.N)
        Fs = jnp.asarray(self._F_np[idx], dtype=jnp.float32)
        Gs = jnp.asarray(self._G_np[idx], dtype=jnp.float32)

        def v_ref(x, i):
            return jnp.einsum("kd,de,ke->k", x, Fs[i], x) + Gs[i]

        return v_ref
