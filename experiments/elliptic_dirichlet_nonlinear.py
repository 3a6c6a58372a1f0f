"""Nonlinear elliptic toy problem with Dirichlet data, d=50.

Reproduces "Nonlinear toy problem - elliptic with Dirichlet.ipynb" with
the notebook's EXACT configs (verified against the saved cell sources and
outputs):

  * every model overrides the value net to the big concat-skip
    ``DenseNet(arch=[d+20, d, d, d])`` (cells 3/9/14);
  * cell 3/4 = PINN sweep, alpha0 in {1e-3, 1e-4, 1e-5} x uniform_square,
    L=220k — best saved output: v-L2 4.59e-8 (alpha0=1e-3, us=False);
  * cell 9/10 = diffusion sweep, alpha0 in {0.1, 1, 10} x uniform_square,
    L=220k — saved finals ~6.9e-6 .. 5.1e-5;
  * cell 14/15 = BSDE with trajectory cap N=200,000, L=220k — saved output
    (cut at iter 187k): v-L2 7.07e-6, and the per-iteration prints show
    ALL 200 paths exit the unit ball within n ~ 7..20 steps, so the cap is
    never approached.

``--leg`` selects a subset (all / diffusion / pinn / bsde) so the long
parity runs can be executed one at a time on the chip.

BSDE note: the reference's eager loop BREAKS as soon as every path has
exited (solver.py:735-736); a fixed-length scan cannot break early, so
``--bsde-n`` sets the compiled cap (default 128 >> the observed ~20-step
exit tail) and ``not_all_stopped_count`` records any cap hits (0
expected), making the run semantically identical to the reference's
N=200,000 configuration without 10^4x wasted steps on frozen paths.
"""

from common import parse_args, save

from pspde.ansatz import DenseNet
from pspde.problems import ExponentialOnBallNonlinearSin
from pspde.solvers import EllipticSolver


def main():
    args = parse_args(default_L=220000,
                      extra={"--bsde-n": dict(type=int, default=128),
                             "--leg": dict(type=str, default="all"),
                             "--us": dict(type=str, default="false",
                                          choices=["false", "true", "both"]),
                             "--anneal": dict(action="store_true"),
                             "--dk": dict(action="store_true",
                                          help="layout='dk' + "
                                               "rng_impl='rbg' (the "
                                               "transposed stopped-"
                                               "rollout engine)"),
                             "--steps-per-call": dict(type=int, default=200)})
    d = 50
    p = ExponentialOnBallNonlinearSin(d=d, alpha=1.0)
    models = []
    spc = 1 if args.smoke else args.steps_per_call

    def net():
        # notebook override: DenseNet(d, 1, 0.001, arch=[d+20, d, d, d])
        return DenseNet(d_out=1, arch=(d + 20, d, d, d))

    us_list = {"false": [False], "true": [True],
               "both": [False, True]}[args.us]
    lr = 1e-3
    if args.anneal:
        # round 3 (after the committor finding): a cosine lr anneal turns
        # out to be what the fresh-sample metric needs at these budgets
        import optax
        lr = optax.cosine_decay_schedule(1e-3, args.L, alpha=1e-2)
    common = dict(seed=args.seed, delta_t=1e-3, N=20, lr=lr, K=200,
                  K_boundary=50, K_test_log=10000, steps_per_call=spc,
                  print_every=max(args.L // 20, 1))
    if args.dk:
        common.update(layout="dk", rng_impl="rbg")
    if args.leg in ("all", "diffusion"):
        for a0 in [0.1, 1.0, 10.0]:
            for us in us_list:
                s = EllipticSolver(p, f"diffusion a0={a0:g} us={us}",
                                   L=args.L, alpha=(a0, 1.0),
                                   loss_method="diffusion",
                                   uniform_square=us, value_net=net(),
                                   **common)
                s.train()
                models.append(s)
    if args.leg in ("all", "pinn"):
        for a0 in [1e-3, 1e-4, 1e-5]:
            for us in us_list:
                s = EllipticSolver(p, f"PINN a0={a0:g} us={us}", L=args.L,
                                   alpha=(a0, 1.0), loss_method="PINN",
                                   uniform_square=us, value_net=net(),
                                   **common)
                s.train()
                models.append(s)
    if args.leg == "picard":
        # Round-3: stopped-domain Picard refinement of the trained
        # diffusion model (eval/picard.py).  CAUTION per refine.py's
        # contraction caveat: this problem's dh/dy is stiff, so the map
        # is only weakly contractive — Krasnoselskij damping sweeps are
        # reported honestly either way.
        import jax
        import jax.numpy as jnp
        from pspde.eval import picard_refine_elliptic
        from pspde.rollout.sampling import sample_domain
        s = EllipticSolver(p, "diffusion a0=0.1 + picard", L=args.L,
                           alpha=(0.1, 1.0), loss_method="diffusion",
                           value_net=net(), **common)
        s.train()
        models.append(s)
        Xt = sample_domain(jax.random.PRNGKey(99), p.geometry, 50000, d)
        vr = p.v_ref(Xt)
        mse0 = float(jnp.mean((s.V_net.apply(s.params, Xt)[:, 0]
                               - vr) ** 2))
        for damping in (1.0, 0.5):
            refined, hist = picard_refine_elliptic(
                p, s.V_net, s.params, n_stages=2, M=8192, K_inner=512,
                N_cap=4096, delta_t=1e-3, reg_steps=4000,
                damping=damping, key=jax.random.PRNGKey(args.seed))
            mse = float(jnp.mean((s.V_net.apply(refined, Xt)[:, 0]
                                  - vr) ** 2))
            print(f"  picard damping={damping:g}: fresh MSE {mse0:.3e} "
                  f"-> {mse:.3e}  ({hist})")
    if args.leg in ("all", "bsde"):
        n_bsde = 32 if args.smoke else args.bsde_n
        s = EllipticSolver(p, f"BSDE N={n_bsde}", L=args.L, alpha=(1.0, 1.0),
                           loss_method="BSDE", value_net=net(),
                           **{**common, "N": n_bsde})
        s.train()
        models.append(s)
        print(f"  BSDE cap hits (not all stopped): "
              f"{s.not_all_stopped_count}/{len(s.loss_log)}")
    for m in models:
        print(f"  {m.name}: test L2 {m.V_test_L2[-1]:.3e} "
              f"(best {min(m.V_test_L2):.3e}), in-path v_L2 "
              f"{m.V_L2_log[-1]:.3e}, {sum(m.times):.0f}s")
    save(models, f"elliptic_dirichlet_d50_{args.leg}_us{args.us}", args)


if __name__ == "__main__":
    main()
