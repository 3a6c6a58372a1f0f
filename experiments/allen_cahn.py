"""Allen-Cahn d=100: diffusion vs PINN vs BSDE.

Reproduces "Allen-Cahn.ipynb": GeneralSolver on AllenCahn(d=100, T=0.3)
with the notebook's exact configs (cells 2/7/10):

  * sampling ball radius 7.0 (cell 2: ``problem.boundary_distance = 7.0``),
    uniform_square=True, net DenseNet(d_in=d+1, arch=[110, 110, 50]) on
    EVERY leg, loss_with_stopped=False, K=200, K_boundary=50, lr=1e-3;
  * diffusion / PINN: alpha0 sweep {10, 1, 0.1} (headline comparison
    models: diffusion alpha0=10, PINN alpha0=0.1 — cell 13), N=25,
    delta_t=1e-3, L=60k;
  * BSDE: N=300, alpha=[1,1,1], L=80k.

The reference value v(0, x=0) = 0.052802 (literature; cell 13 scatter).
Reference runtimes: 194 / 325 / 4280 minutes on a CUDA GPU (cells 14-16).
``--K``/``--L`` allow spending this framework's ~6x wall-clock margin on
a lower-variance configuration.
"""

import time

import jax.numpy as jnp
from common import parse_args, save

from pspde.ansatz import DenseNet
from pspde.problems import AllenCahn
from pspde.solvers import GeneralSolver

V0_REF = AllenCahn.V0_LITERATURE


def v_at_origin(s):
    return float(s._v_fn(s.params)(jnp.zeros((1, s.d)), jnp.zeros((1,)))[0])


def main():
    args = parse_args(
        default_L=60000,
        extra={"--leg": dict(type=str, default="all"),
               "--K": dict(type=int, default=200),
               "--alphas": dict(type=str, default="10,1,0.1"),
               "--finetune-L": dict(type=int, default=0),
               "--finetune-lr": dict(type=float, default=1e-4),
               "--dt": dict(type=float, default=1e-3),
               "--N": dict(type=int, default=25),
               "--refine": dict(action="store_true"),
               "--picard": dict(type=int, default=0),
               "--refine-K": dict(type=int, default=1000000),
               "--radius": dict(type=float, default=7.0),
               "--dk": dict(action="store_true",
                            help="layout='dk' + rng_impl='rbg' (the "
                                 "transposed stopped-rollout engine; "
                                 "same values, speed not measured on "
                                 "the GPU)"),
               "--steps-per-call": dict(type=int, default=100)})
    d = 100
    p = AllenCahn(d=d, T=0.3)
    # notebook cell 2: sampling ball radius 7, cube-direction x uniform
    # radius (uniform_square), net arch [110, 110, 50]
    from pspde.problems.base import Geometry
    p.geometry = Geometry(kind="unbounded", boundary_distance=args.radius)

    def net():
        return DenseNet(d_out=1, arch=(110, 110, 50))

    alphas = [float(a) for a in args.alphas.split(",")]
    spc = 1 if args.smoke else args.steps_per_call
    common = dict(seed=args.seed, lr=1e-3, K=args.K, K_boundary=50,
                  uniform_square=True, loss_with_stopped=False,
                  steps_per_call=spc)
    if args.dk:
        common.update(layout="dk", rng_impl="rbg")
    configs = []
    if args.leg in ("all", "diffusion"):
        configs += [(f"diffusion a0={a0:g}",
                     dict(loss_method="diffusion", N=args.N,
                          delta_t=args.dt, L=args.L,
                          alpha=(a0, 1.0, 1.0)))
                    for a0 in alphas]
    if args.leg in ("all", "pinn"):
        configs += [(f"PINN a0={a0:g}",
                     dict(loss_method="PINN", N=args.N, delta_t=args.dt,
                          L=args.L, alpha=(a0, 1.0, 1.0)))
                    for a0 in alphas]
    if args.leg in ("all", "bsde"):
        configs += [("BSDE", dict(loss_method="BSDE", N=300, delta_t=1e-3,
                                  L=args.L * 4 // 3,
                                  alpha=(1.0, 1.0, 1.0)))]
    models = []
    for name, kw in configs:
        t0 = time.time()
        s = GeneralSolver(p, name, value_net=net(),
                          print_every=max(kw["L"] // 20, 1),
                          **common, **kw)
        s.train()
        mins = (time.time() - t0) / 60
        v0 = v_at_origin(s)
        print(f"  {name}: v(0,0) = {v0:.6f} (ref {V0_REF}), "
              f"rel err {abs(v0 - V0_REF) / V0_REF:.2%}, {mins:.1f} min")
        if args.finetune_L:
            # v(0,0) oscillates with the Adam noise scale at lr=1e-3
            # (~±4% over 100k-iter windows); annealing the tail shrinks
            # the stationary oscillation ~lr-proportionally
            import optax
            s.tx = optax.adam(args.finetune_lr)
            s.opt_state = s.tx.init(s.params)
            s.L = kw["L"] + args.finetune_L
            s.train()
            v0 = v_at_origin(s)
            mins = (time.time() - t0) / 60
            print(f"  {name} after lr={args.finetune_lr:g} x "
                  f"{args.finetune_L}: v(0,0) = {v0:.6f}, rel err "
                  f"{abs(v0 - V0_REF) / V0_REF:.2%}, {mins:.1f} min")
        if args.refine:
            # Feynman-Kac MC refinement (pspde.eval.refine): the learned V
            # enters only through the h integral, contracting its error
            # ~T*sup|h'| = 0.3x; K=1e6 paths make the MC error ~1e-4.
            import jax
            from pspde.eval import feynman_kac_refine
            out = feynman_kac_refine(
                p, lambda X, t: s._v_fn(s.params)(X, t),
                jnp.zeros((d,)), K=args.refine_K, delta_t=args.dt,
                key=jax.random.PRNGKey(args.seed + 1000))
            v0r = float(out.value)
            print(f"  {name} MC-refined: v(0,0) = {v0r:.6f} +- "
                  f"{float(out.stderr):.6f}, rel err "
                  f"{abs(v0r - V0_REF) / V0_REF:.2%}")
        if args.picard:
            # multi-stage Picard regression around the trained model
            # (pspde.eval.picard): each stage contracts the systematic
            # model error ~T*sup|h'| = 0.3x
            import jax
            from pspde.eval import picard_refine
            val, stderr, _ = picard_refine(
                p, s.V_net, s.params, jnp.zeros((d,)),
                n_stages=args.picard, M=4096, K_inner=1024,
                delta_t=kw["delta_t"], readout_K=args.refine_K,
                key=jax.random.PRNGKey(args.seed + 2000), verbose=True)
            v0p = float(val)
            print(f"  {name} Picard x{args.picard}: v(0,0) = {v0p:.6f} "
                  f"+- {float(stderr):.6f}, rel err "
                  f"{abs(v0p - V0_REF) / V0_REF:.2%}")
        models.append(s)
    save(models, f"AllenCahn_d100_{args.leg}", args)


if __name__ == "__main__":
    main()
