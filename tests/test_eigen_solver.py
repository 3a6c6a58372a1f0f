"""Eigenvalue solver tests: Fokker-Planck (lambda = 0) and nonlinear
Schroedinger (lambda = -3) on the torus."""

import numpy as np

from pspde.ansatz import DenseNetTanh
from pspde.problems import FokkerPlanckEigen, SchrodingerEigen
from pspde.solvers import EigenSolver


def test_fokker_planck_lambda_and_eigenfunction():
    p = FokkerPlanckEigen(d=3)
    s = EigenSolver(p, "fp", L=400, K=256, K_boundary=64, N=20,
                    delta_t=1e-3, lr=1e-3, lr_lambda=0.01, lambda_init=0.5,
                    normalization="center", verbose=False)
    s.train()
    # lambda_true = 0; notebook reaches |lambda| ~ 5e-3 after 100k iters
    lam_avg = np.mean(s.lambda_log[-50:])
    assert abs(lam_avg) < 0.05
    assert s.V_L2_log[-1] < s.V_L2_log[0]


def test_schrodinger_lambda_moves_toward_true():
    p = SchrodingerEigen(d=3)
    net = DenseNetTanh(d_out=1, arch=(15, 15, 15, 15), output_relu=True)
    s = EigenSolver(p, "schroedinger", L=600, K=256, K_boundary=64, N=20,
                    delta_t=1e-3, lr=1e-3, lambda_init=-2.0,
                    normalization="l2_penalty", value_net=net,
                    verbose=False)
    s.train()
    # lambda_true = -3; from -2.0 it must move clearly toward it
    lam_avg = np.mean(s.lambda_log[-50:])
    assert lam_avg < -2.1
    assert np.isfinite(s.loss_log[-1])


def test_estimate_lambda_affine_identity_and_shift():
    """Y(lambda) is affine in lambda at frozen V, and shifting the base
    problem by h -> h + mu*y shifts the regression readout by exactly
    -mu (no training needed for either identity)."""
    from pspde.solvers.eigen import _LambdaShiftedProblem

    p = FokkerPlanckEigen(d=2)
    s = EigenSolver(p, "fp", L=30, K=128, K_boundary=32, N=10,
                    verbose=False)
    s.train()
    lam0, err0 = s.estimate_lambda(K=512, n_batches=4)
    assert np.isfinite(lam0) and err0 >= 0.0

    # shifted problem: same geometry/sigma, h + mu*y
    mu = 0.37
    shifted = _LambdaShiftedProblem(p, mu)
    shifted.geometry = p.geometry
    shifted.d = p.d
    s2 = EigenSolver.__new__(EigenSolver)
    s2.__dict__.update(s.__dict__)
    s2.problem = shifted
    lam1, _ = s2.estimate_lambda(K=512, n_batches=4)
    assert abs((lam1 + mu) - lam0) < 5e-3


def test_lambda_tail_mean():
    p = FokkerPlanckEigen(d=2)
    s = EigenSolver(p, "fp", L=20, K=64, K_boundary=32, N=5, verbose=False)
    assert s.lambda_tail_mean() is None
    s.train()
    assert abs(s.lambda_tail_mean(window=20)
               - np.mean(s.lambda_log)) < 1e-12
    assert s.lambda_tail_mean(window=1) == s.lambda_log[-1]


def test_loss_parts_logged():
    p = FokkerPlanckEigen(d=2)
    s = EigenSolver(p, "fp", L=5, K=64, K_boundary=32, N=5, verbose=False)
    s.train()
    assert len(s.loss_log_domain) == 5
    assert len(s.loss_log_boundary) == 5
    assert len(s.loss_log_derivative_boundary) == 5
    assert len(s.lambda_log) == 5


def test_estimate_lambda_richardson_cancels_dt_bias():
    """At frozen V = v_true the regression readout carries ONLY the
    discretization bias + MC noise (lambda_true = 0); the bias is
    O(sqrt(dt)) (discrete boundary stopping), and the sqrt-order
    Richardson combination must land closer to 0 than the coarse-dt
    readout (no training involved)."""
    import jax
    import jax.numpy as jnp

    from pspde.ansatz import Module

    p = FokkerPlanckEigen(d=2)

    class TrueV(Module):
        def _init(self, key, x):
            return {"dummy": jnp.zeros((1,))}

        def _apply(self, params, x):
            return p.v_ref(x)[:, None] + 0.0 * params["dummy"]

    s = EigenSolver(p, "fp-true-v", L=1, K=64, K_boundary=16, N=10,
                    delta_t=1.6e-2, value_net=TrueV(), verbose=False)
    key = jax.random.PRNGKey(7)
    lam_c, se_c = s.estimate_lambda(K=2048, n_batches=8,
                                    key=jax.random.fold_in(key, 0))
    lam_R, se_R = s.estimate_lambda_richardson(
        K=2048, n_batches=8, key=jax.random.fold_in(key, 1))
    # the coarse readout must actually SEE the bias (else the test is
    # vacuous: bias ~2.3e-3 at dt=1.6e-2, se ~4e-4) and the sqrt-order
    # extrapolation must cancel most of it
    assert abs(lam_c) > 3 * se_c, (lam_c, se_c)
    assert abs(lam_R) < 0.5 * abs(lam_c), (lam_R, lam_c, se_R)


def test_eigen_subspace_spectral_gap_matches_fd_oracle():
    """Block Feynman-Kac power iteration (eval.eigen_subspace_refine)
    recovers the TOP-TWO eigenvalues — i.e. the spectral gap — of the
    d=1 Fokker-Planck generator, validated against the dense periodic
    FD spectrum oracle (fd_oracles.generator_spectrum_periodic_1d).
    No reference counterpart (notebooks read only lambda_0)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax

    from pspde.eval import eigen_subspace_refine
    from pspde.problems.fd_oracles import generator_spectrum_periodic_1d

    p = FokkerPlanckEigen(d=1)

    def b1(x):
        return np.asarray(p.b(jnp.asarray(x, jnp.float32)[:, None]))[:, 0]

    def W1(x):
        xj = jnp.asarray(x, jnp.float32)[:, None]
        return np.asarray(p.h(xj, jnp.ones(len(x), jnp.float32), None))

    _, lam_fd, _ = generator_spectrum_periodic_1d(b1, W1, n=256)
    assert abs(lam_fd[0]) < 1e-4          # lambda_true = 0
    assert abs(lam_fd[1] - 1.0) < 0.05    # near-Laplacian gap ~ 1

    net = DenseNetTanh(d_out=1, arch=(20, 20))
    Xs = 2.0 * np.pi * jax.random.uniform(jax.random.PRNGKey(7), (1024, 1))

    @jax.jit
    def fit(params, targets):
        tx = optax.adam(3e-3)
        state = tx.init(params)

        def body(carry, _):
            params, state = carry
            g = jax.grad(lambda q: jnp.mean(
                (net.apply(q, Xs)[:, 0] - targets) ** 2))(params)
            up, state = tx.update(g, state, params)
            return (optax.apply_updates(params, up), state), None

        (params, _), _ = lax.scan(body, (params, state), None, length=1500)
        return params

    # crude initial subspace: constant (dominant guess) + first harmonic
    inits = [jnp.ones(1024), jnp.sin(Xs[:, 0])]
    params_list = [fit(net.init(jax.random.PRNGKey(j), Xs[:2]), t)
                   for j, t in enumerate(inits)]

    _, hist = eigen_subspace_refine(
        p, net, params_list, n_stages=3, T_horizon=0.5, M=1024,
        K_inner=32, delta_t=0.01, reg_steps=1500, reg_lr=3e-3,
        key=jax.random.PRNGKey(1))
    lams = hist[-1]["lambdas"]            # ascending
    assert abs(lams[0] - lam_fd[0]) < 0.05
    assert abs(lams[1] - lam_fd[1]) < 0.15
