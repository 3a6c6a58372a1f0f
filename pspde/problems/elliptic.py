"""Elliptic boundary-value problems (first-exit formulations).

Rebuilds (protocol: ``h(x, y, z)``, ``g(x)`` boundary data, ``v_ref(x)``):
  * ``ExponentialOnSphere``                — problems.py:962-992
  * ``ExponentialOnBallNonlinear``         — problems.py:995-1028
  * ``ExponentialOnBallNonlinearSin``      — problems.py:1031-1064
  * ``ExponentialOnBallNonlinearSinHessian`` — problems.py:1067-1100
                                             (non-diagonal sigma)
  * ``Committor``                          — problems.py:1546-1579
  * ``QuadraticGradient``                  — problems.py:1582-1611
  * ``Helmholtz``                          — problems.py:1614-1654
  * ``Oscillations``                       — problems.py:1657-1693
  * ``SinNorm2``                           — problems.py:1696-1730
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import DiffusionMatrix, Geometry, Problem


class _ZeroDriftBall(Problem):
    """Shared scaffolding: zero drift, constant sigma, unit-ball geometry."""

    def __init__(self, d, B, boundary_distance=1.0, boundary_type="Dirichlet"):
        super().__init__(d=d)
        self.B = B
        self._sigma = DiffusionMatrix(B)
        self.geometry = Geometry(kind="sphere",
                                 boundary_distance=boundary_distance)
        self.boundary_type = boundary_type

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return jnp.zeros_like(x)

    def f(self, x, t=None):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    # transposed-coefficient protocol (base.py; column layout, batch as
    # the minor dimension): zero drift is layout-trivial; subclasses
    # add h_T — their h's consume x only through per-path reductions, so
    # the column form just swaps the reduction axis to 0.
    def b_T(self, xT):
        return jnp.zeros_like(xT)

    def f_T(self, xT, t=None):
        return jnp.zeros(xT.shape[1], dtype=xT.dtype)


class ExponentialOnSphere(_ZeroDriftBall):
    """Linear elliptic on the unit ball, manufactured v = exp(alpha |x|^2)."""

    def __init__(self, name="Exponential on sphere", d=2, alpha=1.0):
        super().__init__(d=d, B=jnp.sqrt(2.0) * jnp.eye(d, dtype=jnp.float32))
        self.name = name
        self.alpha = float(alpha)

    def g(self, x):
        return jnp.exp(self.alpha * jnp.sum(x * x, axis=-1))

    def h(self, x, y, z):
        return -self.alpha * y * (self.alpha * 4.0 * jnp.sum(x * x, axis=-1)
                                  + 2.0 * self.d)

    def h_T(self, xT, y, zT):
        return -self.alpha * y * (self.alpha * 4.0 * jnp.sum(xT * xT, axis=0)
                                  + 2.0 * self.d)

    def v_ref_T(self, xT):
        return jnp.exp(self.alpha * jnp.sum(xT * xT, axis=0))

    def u_ref(self, x):
        return (-2.0 * jnp.sqrt(2.0) * self.alpha * x
                * jnp.exp(self.alpha * jnp.sum(x * x, axis=-1))[:, None])

    def v_ref(self, x):
        return jnp.exp(self.alpha * jnp.sum(x * x, axis=-1))


class ExponentialOnBallNonlinear(_ZeroDriftBall):
    """Nonlinear elliptic (h contains -y^2); Dirichlet or Neumann
    (g returns gradient data for Neumann, problems.py:1017-1019)."""

    def __init__(self, name="Exponential on ball nonlinear", d=2, alpha=1.0,
                 boundary_type="Dirichlet"):
        super().__init__(d=d, B=jnp.sqrt(2.0) * jnp.eye(d, dtype=jnp.float32),
                         boundary_type=boundary_type)
        self.name = name
        self.alpha = float(alpha)

    def g(self, x):
        r2 = jnp.sum(x * x, axis=-1)
        if self.boundary_type == "Neumann":
            return 2.0 * self.alpha * x * jnp.exp(self.alpha * r2)[:, None]
        return jnp.exp(self.alpha * r2)

    def h(self, x, y, z):
        r2 = jnp.sum(x * x, axis=-1)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d)
                + jnp.exp(2.0 * self.alpha * r2) - y ** 2)

    def h_T(self, xT, y, zT):
        r2 = jnp.sum(xT * xT, axis=0)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d)
                + jnp.exp(2.0 * self.alpha * r2) - y ** 2)

    def v_ref_T(self, xT):
        return jnp.exp(self.alpha * jnp.sum(xT * xT, axis=0))

    def v_ref(self, x):
        return jnp.exp(self.alpha * jnp.sum(x * x, axis=-1))


class ExponentialOnBallNonlinearSin(ExponentialOnBallNonlinear):
    """sin() nonlinearity — the d=10/50 workhorse (problems.py:1031-1064)."""

    def h(self, x, y, z):
        r2 = jnp.sum(x * x, axis=-1)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d)
                + jnp.sin(jnp.exp(2.0 * self.alpha * r2) - y ** 2))

    def h_T(self, xT, y, zT):
        r2 = jnp.sum(xT * xT, axis=0)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d)
                + jnp.sin(jnp.exp(2.0 * self.alpha * r2) - y ** 2))


class ExponentialOnBallNonlinearSinHessian(_ZeroDriftBall):
    """Same as ...Sin but with non-diagonal sigma B = sqrt(2/d) * ones(d, d)
    (problems.py:1072), forcing full-Hessian treatment in PINN mode."""

    def __init__(self, name="Exponential on ball nonlinear", d=2, alpha=1.0,
                 boundary_type="Dirichlet"):
        B = jnp.sqrt(2.0 / d) * jnp.ones((d, d), dtype=jnp.float32)
        super().__init__(d=d, B=B, boundary_type=boundary_type)
        self.name = name
        self.alpha = float(alpha)

    def g(self, x):
        r2 = jnp.sum(x * x, axis=-1)
        if self.boundary_type == "Neumann":
            return 2.0 * self.alpha * x * jnp.exp(self.alpha * r2)[:, None]
        return jnp.exp(self.alpha * r2)

    def h(self, x, y, z):
        # problems.py:1094: sum over x x^T outer products == (sum_i x_i)^2
        outer = jnp.sum(x, axis=-1) ** 2
        r2 = jnp.sum(x * x, axis=-1)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * outer + self.d)
                + jnp.sin(jnp.exp(2.0 * self.alpha * r2) - y ** 2))

    def h_T(self, xT, y, zT):
        outer = jnp.sum(xT, axis=0) ** 2
        r2 = jnp.sum(xT * xT, axis=0)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * outer + self.d)
                + jnp.sin(jnp.exp(2.0 * self.alpha * r2) - y ** 2))

    def v_ref_T(self, xT):
        return jnp.exp(self.alpha * jnp.sum(xT * xT, axis=0))

    def v_ref(self, x):
        return jnp.exp(self.alpha * jnp.sum(x * x, axis=-1))


class Committor(Problem):
    """Committor function between spheres of radii a=1 and c=2
    (problems.py:1546-1579), exact radial solution problems.py:1577-1579."""

    def __init__(self, name="Committor", d=2, alpha=1.0):
        super().__init__(d=d)
        self.name = name
        self.a = 1.0
        self.c = 2.0
        self.B = jnp.eye(d, dtype=jnp.float32)
        self._sigma = DiffusionMatrix(self.B)
        self.geometry = Geometry(kind="two_spheres",
                                 boundary_distance_1=self.a,
                                 boundary_distance_2=self.c)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return jnp.zeros_like(x)

    def f(self, x, t=None):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def g(self, x):
        return (jnp.sqrt(jnp.sum(x * x, axis=-1)) > self.a).astype(x.dtype)

    def h(self, x, y, z):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def b_T(self, xT):
        return jnp.zeros_like(xT)

    def h_T(self, xT, y, zT):
        return jnp.zeros(xT.shape[1], dtype=xT.dtype)

    def f_T(self, xT, t=None):
        return jnp.zeros(xT.shape[1], dtype=xT.dtype)

    def v_ref_T(self, xT):
        r = jnp.sqrt(jnp.sum(xT * xT, axis=0))
        return ((self.a ** 2 - r ** (2 - self.d) * self.a ** self.d)
                / (self.a ** 2 - self.c ** (2 - self.d) * self.a ** self.d))

    def v_ref(self, x):
        r = jnp.sqrt(jnp.sum(x * x, axis=-1))
        return ((self.a ** 2 - r ** (2 - self.d) * self.a ** self.d)
                / (self.a ** 2 - self.c ** (2 - self.d) * self.a ** self.d))


class QuadraticGradient(_ZeroDriftBall):
    """Elliptic with |z|^2 gradient nonlinearity, v = log((|x|^2 + 1)/d)
    (problems.py:1582-1611)."""

    def __init__(self, name="Quadratic Gradient", d=1, r=1.0):
        super().__init__(d=d, B=jnp.sqrt(2.0) * jnp.eye(d, dtype=jnp.float32),
                         boundary_distance=r)
        self.name = name
        self.X_0 = -jnp.ones((d,), dtype=jnp.float32)

    def g(self, x):
        return jnp.log((jnp.sum(x * x, axis=-1) + 1.0) / self.d)

    def h(self, x, y, z):
        return jnp.sum(z * z, axis=-1) / 2.0 - 2.0 * jnp.exp(-y)

    def v_ref(self, x):
        return jnp.log((jnp.sum(x * x, axis=-1) + 1.0) / self.d)


class Helmholtz(Problem):
    """2-d Helmholtz with manufactured sin*sin solution (problems.py:1614-1654)."""

    def __init__(self, name="Helmholtz", d=2, r=1.0):
        super().__init__(d=d)
        self.name = name
        self.B = jnp.sqrt(2.0) * jnp.eye(d, dtype=jnp.float32)
        self._sigma = DiffusionMatrix(self.B)
        self.a_1, self.a_2, self.k = 1.0, 4.0, 1.0
        self.geometry = Geometry(kind="square", X_l=-1.0, X_r=1.0)
        self.X_0 = -jnp.ones((d,), dtype=jnp.float32)
        if d != 2:
            print("Only implemented for d = 2.")

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return jnp.zeros_like(x)

    def f(self, x, t=None):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def _sinsin(self, x):
        pi = jnp.pi
        return (jnp.sin(self.a_1 * pi * x[:, 0])
                * jnp.sin(self.a_2 * pi * x[:, 1]))

    def g(self, x):
        return self._sinsin(x)

    def h(self, x, y, z):
        pi = jnp.pi
        s = self._sinsin(x)
        return (self.k ** 2 * y + (self.a_1 * pi) ** 2 * s
                + (self.a_2 * pi) ** 2 * s - self.k ** 2 * s)

    def v_ref(self, x):
        return self._sinsin(x)


class Oscillations(Problem):
    """1-d multiscale oscillatory Poisson problem (problems.py:1657-1693)."""

    def __init__(self, name="Oscillations", d=1, r=1.0):
        super().__init__(d=d)
        self.name = name
        self.B = jnp.sqrt(2.0) * jnp.eye(d, dtype=jnp.float32)
        self._sigma = DiffusionMatrix(self.B)
        self.a = 5.0
        self.geometry = Geometry(kind="square", X_l=0.0, X_r=1.0)
        self.X_0 = -jnp.ones((d,), dtype=jnp.float32)
        if d != 1:
            print("Only implemented for d = 1.")

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return jnp.zeros_like(x)

    def f(self, x, t=None):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def g(self, x):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def h(self, x, y, z):
        pi = jnp.pi
        return ((2.0 * pi) ** 2 * jnp.sin(2.0 * pi * x[:, 0])
                + (self.a * pi) ** 2 * 0.1 * jnp.sin(self.a * pi * x[:, 0]))

    def v_ref(self, x):
        pi = jnp.pi
        return (jnp.sin(2.0 * pi * x[:, 0])
                + 0.1 * jnp.sin(self.a * pi * x[:, 0]))


class SinNorm2(Problem):
    """v = sin(pi |x|^2) with linear/nonlinear switch and non-diagonal sigma
    (problems.py:1696-1730)."""

    def __init__(self, name="SinNorm2", d=1, r=1.0, linear=True, alpha=1.0):
        super().__init__(d=d)
        self.name = name
        self.alpha = float(alpha)
        self.B = (self.alpha * jnp.sqrt(2.0 / d)
                  * jnp.ones((d, d), dtype=jnp.float32))
        self._sigma = DiffusionMatrix(self.B)
        self.linear = linear
        self.geometry = Geometry(kind="sphere", boundary_distance=1.0)
        self.X_0 = -jnp.ones((d,), dtype=jnp.float32)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return jnp.zeros_like(x)

    def f(self, x, t=None):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def g(self, x):
        return jnp.zeros(x.shape[0], dtype=x.dtype)

    def h(self, x, y, z):
        pi = jnp.pi
        r2 = jnp.sum(x * x, axis=-1)
        s1 = jnp.sum(x, axis=-1) ** 2
        if self.linear:
            return self.alpha ** 2 * (4.0 * pi ** 2 * jnp.sin(pi * r2) * s1
                                      - 2.0 * self.d * pi * jnp.cos(pi * r2))
        return self.alpha ** 2 * (4.0 * pi ** 2 * y * s1
                                  - 2.0 * self.d * pi * jnp.cos(pi * r2)
                                  + jnp.sin(pi * r2) ** 2 - y ** 2)

    def v_ref(self, x):
        return jnp.sin(jnp.pi * jnp.sum(x * x, axis=-1))
