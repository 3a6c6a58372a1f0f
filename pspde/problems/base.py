"""Problem protocol for path-space PDE solvers.

The reference (`/root/reference/problems.py`) defines problems as duck-typed
classes exposing ``d, T, X_0, b, sigma, f, g, h`` plus optional reference
solutions ``u_true / v_true`` and elliptic geometry metadata
(``boundary, boundary_distance*, X_l, X_r, one_boundary, boundary_type`` —
see e.g. problems.py:18-49, problems.py:962-992).  We keep the same implicit
protocol but make every method a *pure JAX function over batched inputs*
``x: (K, d)`` so that solvers can ``jit``/``vmap``/shard them, and we add
structured diffusion metadata so the hot rollout can avoid dense ``(d, d)``
matmuls when sigma is (a multiple of) the identity — which is the case for
every problem in the reference.

Protocol conventions (all shapes batched over leading axis K):

* ``b(x) -> (K, d)``                     drift
* ``sigma(x) -> (d, d)``                 diffusion matrix (state-independent
                                         in all reference problems)
* HJB/parabolic family (driven by :class:`pspde.solvers.hjb.HJBSolver`):
  ``f(x, t) -> (K,)`` running cost, ``g(x) -> (K,)`` terminal cost,
  ``h(t, x, y, z) -> (K,)`` with ``y: (K,)``, ``z: (K, d)``,
  ``u_ref(x, t) -> (K, d)`` and ``v_ref(x, t) -> (K,)`` when available.
* Elliptic family (driven by ``EllipticSolver``): ``h(x, y, z)``,
  ``g(x)`` boundary data (scalar Dirichlet value or ``(K, d)`` Neumann
  gradient data), ``v_ref(x) -> (K,)``, and a :class:`Geometry`.
* General parabolic family (driven by ``GeneralSolver``): additionally
  ``f_terminal(x) -> (K,)`` terminal condition and ``g(x, t)`` space-time
  boundary data; cf. solver.py:1062-1074.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Spatial domain metadata for elliptic / general solvers.

    Mirrors the reference's per-problem attributes (problems.py:970-971,
    problems.py:1227-1231, solver.py:647-708) as one structured object.

    kind: one of 'sphere', 'two_spheres', 'square', 'square-corner',
          'unbounded', 'unbounded_square'.
    """

    kind: str
    # sphere / unbounded
    boundary_distance: float = 1.0
    # two_spheres
    boundary_distance_1: float = 1.0
    boundary_distance_2: float = 2.0
    # square / square-corner / unbounded_square
    X_l: float = -1.0
    X_r: float = 1.0
    X_corner: float = 0.0
    one_boundary: bool = False

    @property
    def bounded(self) -> bool:
        return "unbounded" not in self.kind


class DiffusionMatrix:
    """Structured (d, d) diffusion matrix.

    In the Euler-Maruyama hot loop the reference computes
    ``pt.mm(sigma(X), xi.t()).t()`` (solver.py:471-472) — a dense (d, d) x
    (d, K) matmul even though sigma is almost always ``c * I``.  We record
    the structure ('scalar' | 'diag' | 'full') so ``apply`` lowers to a
    broadcasted elementwise multiply when possible and only runs a matmul
    for genuinely dense sigmas (e.g. ExponentialOnBallNonlinearSinHessian,
    problems.py:1072).
    """

    def __init__(self, mat: jnp.ndarray):
        mat = jnp.asarray(mat, dtype=jnp.float32)
        assert mat.ndim == 2 and mat.shape[0] == mat.shape[1]
        self.mat = mat
        host = np.asarray(mat)
        d = host.shape[0]
        if np.allclose(host, host[0, 0] * np.eye(d)):
            self.kind = "scalar"
            self.scale = float(host[0, 0])
            self.diag = None
        elif np.allclose(host, np.diag(np.diagonal(host))):
            self.kind = "diag"
            self.scale = None
            self.diag = jnp.asarray(np.diagonal(host), dtype=jnp.float32)
        else:
            self.kind = "full"
            self.scale = None
            self.diag = None

    @property
    def d(self) -> int:
        return self.mat.shape[0]

    def apply(self, v: jnp.ndarray) -> jnp.ndarray:
        """sigma @ v per batch row: v (..., d) -> (..., d)."""
        if self.kind == "scalar":
            return self.scale * v
        if self.kind == "diag":
            return self.diag * v
        return v @ self.mat.T

    def apply_T(self, v: jnp.ndarray) -> jnp.ndarray:
        """sigma^T @ v per batch row (used for Z = sigma^T grad V)."""
        if self.kind == "scalar":
            return self.scale * v
        if self.kind == "diag":
            return self.diag * v
        return v @ self.mat

    def apply_cols(self, v: jnp.ndarray) -> jnp.ndarray:
        """sigma @ v in COLUMN layout: v (d, K) -> (d, K).  Used by the
        transposed (dk) rollout paths, where the batch axis is the minor
        dimension (ansatz/transposed.py layout note)."""
        if self.kind == "scalar":
            return self.scale * v
        if self.kind == "diag":
            return self.diag[:, None] * v
        return jnp.matmul(self.mat, v)

    def apply_T_cols(self, v: jnp.ndarray) -> jnp.ndarray:
        """sigma^T @ v in COLUMN layout: v (d, K) -> (d, K).  Used by the
        transposed stopped rollout for Z = sigma^T grad V
        (rollout/sde.py: stopped_rollout_dk)."""
        if self.kind == "scalar":
            return self.scale * v
        if self.kind == "diag":
            return self.diag[:, None] * v
        return jnp.matmul(self.mat.T, v)


class Problem:
    """Base class: holds common metadata; subclasses define the physics.

    Optional transposed-coefficient protocol (column layout, batch as the
    minor dimension; see ansatz/transposed.py): a problem may define
    ``b_T(xT (d, K)) -> (d, K)``, ``h_T(t, xT, y (K,), zT) -> (K,)`` and
    ``f_T(xT, t) -> (K,)`` to enable the transposed (dk) rollouts
    (rollout/sde.py: hjb_rollout_dk, stopped_rollout_dk).
    ``supports_transposed`` reports whether all required pieces exist.
    """

    # True when h(t, x, y, z) ignores y — enables the batched-gradient
    # rollout fast path (rollout/sde.py: hjb_rollout_batched_grad)
    h_is_y_free: bool = False

    @property
    def supports_transposed(self) -> bool:
        return hasattr(self, "b_T") and hasattr(self, "h_T")

    name: str = "problem"
    d: int
    T: Optional[float] = None
    geometry: Optional[Geometry] = None
    boundary_type: str = "Dirichlet"

    def __init__(self, d: int, T: Optional[float] = None):
        self.d = d
        self.T = T
        self.X_0 = jnp.zeros((d,), dtype=jnp.float32)

    # -- diffusion ---------------------------------------------------------
    def sigma(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.sigma_struct.mat

    @property
    def sigma_struct(self) -> DiffusionMatrix:
        raise NotImplementedError

    def b(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    # -- optional reference solutions -------------------------------------
    @property
    def has_u_ref(self) -> bool:
        return hasattr(self, "u_ref")

    @property
    def has_v_ref(self) -> bool:
        return hasattr(self, "v_ref")
