"""Problem-library unit tests: shapes, closed-form identities, FD oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pspde import problems as P


K = 7


def _batch(problem, key):
    return jax.random.normal(key, (K, problem.d))


def test_registry_complete():
    # SURVEY.md section 2.2: 26 reference problems + 2 notebook eigenproblems
    assert len(P.REGISTRY) >= 28


@pytest.mark.parametrize("name", list(P.REGISTRY))
def test_shapes(name, key):
    cls = P.REGISTRY[name]
    kwargs = {}
    if name in ("Helmholtz",):
        kwargs = {"d": 2}
    p = cls(**kwargs) if name != "LQGC" else cls(d=2, T=1.0)
    x = _batch(p, key)
    assert p.b(x).shape == (K, p.d)
    assert p.sigma(x).shape == (p.d, p.d)
    s = p.sigma_struct
    v = jax.random.normal(key, (K, p.d))
    np.testing.assert_allclose(np.asarray(s.apply(v)),
                               np.asarray(v @ s.mat.T), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s.apply_T(v)),
                               np.asarray(v @ s.mat), rtol=1e-5, atol=1e-5)


def test_llgc_u_v_consistency(key):
    """u* = -sigma^T grad_x v for the closed-form LLGC solution."""
    p = P.LLGC(d=3, T=1.0, off_diag=0.1)
    x = jax.random.normal(key, (K, 3))
    t = 0.3
    v = lambda xx: p.v_ref(xx, t)
    grad = jax.vmap(jax.grad(lambda xx: v(xx[None, :])[0]))(x)
    u_expected = -p.sigma_struct.apply_T(grad)
    ts = np.array([t])
    u_tab = p.u_ref_fn(ts)(x, 0)
    np.testing.assert_allclose(np.asarray(u_tab), np.asarray(u_expected),
                               rtol=1e-3, atol=1e-4)


def test_lqgc_u_v_consistency(key):
    p = P.LQGC(d=2, T=1.0, delta_t=0.01)
    x = jax.random.normal(key, (K, 2))
    ts = np.array([0.25])
    v_fn = p.v_ref_fn(ts)
    u_fn = p.u_ref_fn(ts)
    grad = jax.vmap(jax.grad(lambda xx: v_fn(xx[None, :], 0)[0]))(x)
    u_expected = -p.sigma_struct.apply_T(grad)
    np.testing.assert_allclose(np.asarray(u_fn(x, 0)),
                               np.asarray(u_expected), rtol=2e-2, atol=2e-2)


def test_double_well_fd_oracle_terminal():
    """At t = T the FD solution must satisfy psi = exp(-g), i.e.
    v(x, T) = g(x)."""
    p = P.DoubleWell(d=1, T=1.0, eta=2.0, kappa=1.0)
    p.compute_reference_solution(delta_t=0.01, nx=400)
    ts = np.array([1.0])
    v_fn = p.v_ref_fn(ts)
    x = jnp.linspace(-1.5, 1.5, 11)[:, None]
    v_T = np.asarray(v_fn(x, 0))
    g = np.asarray(p.g(x))
    # floor-index lookup => O(g'(x) * dx) error at the steep ends
    np.testing.assert_allclose(v_T, g, atol=0.12)


def test_double_well_fd_oracle_matches_ou_limit():
    """kappa -> 0 double well with eta-quadratic terminal approaches a
    Brownian-motion problem whose v(x, 0) = -log E[exp(-eta (x+W_T-1)^2)]
    has the Gaussian closed form."""
    eta, T = 0.5, 0.5
    p = P.DoubleWell(d=1, T=T, eta=eta, kappa=0.0)
    p.compute_reference_solution(delta_t=0.002, xb=6.0, nx=1500)
    v_fn = p.v_ref_fn(np.array([0.0]))
    xs = np.linspace(-1.0, 1.0, 9)
    # E[e^{-eta (x + sqrt(T) Z - 1)^2}] with Z ~ N(0,1):
    # = 1/sqrt(1 + 2 eta T) * exp(-eta (x-1)^2 / (1 + 2 eta T))
    expected = -np.log(np.exp(-eta * (xs - 1) ** 2 / (1 + 2 * eta * T))
                       / np.sqrt(1 + 2 * eta * T))
    got = np.asarray(v_fn(jnp.asarray(xs)[:, None].astype(jnp.float32), 0))
    np.testing.assert_allclose(got, expected, atol=0.03)


def test_committor_reference_formula():
    p = P.Committor(d=3)
    x = jnp.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0], [1.5, 0.0, 0.0]])
    v = np.asarray(p.v_ref(x))
    assert abs(v[0] - 0.0) < 1e-5   # inner sphere
    assert abs(v[1] - 1.0) < 1e-5   # outer sphere
    assert 0.0 < v[2] < 1.0


def test_heat_equation_reference(key):
    p = P.HeatEquation(d=5, T=1.0)
    x = jax.random.normal(key, (K, 5))
    v0 = p.v_ref(x, 0.0)
    vT = p.v_ref(x, 1.0)
    np.testing.assert_allclose(np.asarray(vT),
                               np.asarray(jnp.sum(x * x, axis=-1)),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(v0 - vT), 2.0 * 5, rtol=1e-5)


def test_schrodinger_normalization_constant():
    # Schroedinger notebooks cell 1 outputs
    assert abs(P.SchrodingerEigen(d=5).c - 1.1040855) < 1e-5
    assert abs(P.SchrodingerEigen(d=10).c - 1.0511402) < 1e-5


def test_elliptic_manufactured_pde_residual(key):
    """ExponentialOnSphere: 1/2 Tr(sigma sigma^T H v) + b . grad v + h(x, v, .) = 0."""
    p = P.ExponentialOnSphere(d=3, alpha=0.7)
    x = 0.5 * jax.random.normal(key, (K, 3))
    v_scalar = lambda xx: p.v_ref(xx[None, :])[0]
    v = p.v_ref(x)
    lap = jax.vmap(lambda xx: jnp.trace(jax.hessian(v_scalar)(xx)))(x)
    # sigma = sqrt(2) I => 1/2 Tr(sigma sigma^T H) = Tr(H)
    resid = lap + p.h(x, v, None)
    np.testing.assert_allclose(np.asarray(resid), 0.0, atol=1e-3)


def test_quadratic_gradient_pde_residual(key):
    p = P.QuadraticGradient(d=4)
    x = 0.4 * jax.random.normal(key, (K, 4))
    v_scalar = lambda xx: p.v_ref(xx[None, :])[0]
    v = p.v_ref(x)
    grad = jax.vmap(jax.grad(v_scalar))(x)
    z = p.sigma_struct.apply_T(grad)
    lap = jax.vmap(lambda xx: jnp.trace(jax.hessian(v_scalar)(xx)))(x)
    resid = lap + p.h(x, v, z)
    np.testing.assert_allclose(np.asarray(resid), 0.0, atol=1e-3)


def test_eigen_problems_satisfy_eigen_equation(key):
    """L v + h-potential terms = lambda v for the reference eigenfunctions."""
    for cls, d in [(P.FokkerPlanckEigen, 3), (P.SchrodingerEigen, 4)]:
        p = cls(d=d)
        x = jnp.pi + 0.5 * jax.random.normal(key, (K, d))
        v_scalar = lambda xx: p.v_ref(xx[None, :])[0]
        v = p.v_ref(x)
        grad = jax.vmap(jax.grad(v_scalar))(x)
        lap = jax.vmap(lambda xx: jnp.trace(jax.hessian(v_scalar)(xx)))(x)
        # generator: L v = 1/2 Tr(B B^T H) + b . grad = lap (B = sqrt(2) I).
        # The notebooks' Y recursion accumulates (-h - lambda V) dt, so the
        # eigen relation is L v + h(x, v, .) = -lambda v.
        resid = lap + jnp.sum(p.b(x) * grad, axis=-1) + p.h(x, v, None)
        target = -p.lambda_true * v
        np.testing.assert_allclose(np.asarray(resid), np.asarray(target),
                                   atol=5e-3)


def _make(name):
    cls = P.REGISTRY[name]
    return cls(d=2, T=1.0) if name == "LQGC" else cls()


TRANSPOSED = [n for n in P.REGISTRY
              if getattr(_make(n), "supports_transposed", False)]


def test_transposed_registry_count():
    assert len(TRANSPOSED) == 12, TRANSPOSED


@pytest.mark.parametrize("name", TRANSPOSED)
def test_transposed_protocol_matches_row_major(name):
    """b_T / h_T / v_ref_T (column layout, base.py protocol) are the
    row-major b / h / v_ref applied to x.T, transposed."""
    from pspde.rollout.sde import _call_h, _call_h_T
    p = _make(name)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    x = 0.5 * jax.random.normal(k1, (K, p.d))
    y = jax.random.normal(k2, (K,))
    z = jax.random.normal(k3, (K, p.d))
    t = jnp.float32(0.25)
    np.testing.assert_allclose(np.asarray(p.b_T(x.T)),
                               np.asarray(p.b(x)).T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(_call_h_T(p, t, x.T, y, z.T)),
                               np.asarray(_call_h(p, t, x, y, z)),
                               rtol=1e-5, atol=1e-6)
    if hasattr(p, "v_ref_T"):
        np.testing.assert_allclose(np.asarray(p.v_ref_T(x.T)),
                                   np.asarray(p.v_ref(x)),
                                   rtol=1e-5, atol=1e-6)
