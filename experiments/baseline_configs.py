#!/usr/bin/env python3
"""BASELINE.json 'configs' — the rebuild-scale targets (no reference run).

BASELINE.json lists five target configurations for the rebuild.
Config 1 is covered by existing experiments (ou_linear_costs /
ou_quadratic_costs_linear_ansatz, the d=10 closed-form check); this
script runs the other four:

  --config 3  HJB double-well d=20 AND d=50 as BASELINE states them,
              moment vs log-variance head-to-head at K=10^4, validated
              against the per-dim FD oracle + IS relative error.

  --config 2  Heat equation d=50 via diffusion loss (terminal-condition
              regression along sampled paths; validated against the
              closed form v = |x|^2 + 2(T-t)d, problems.py:1733-1764).
  --config 4  d=100 HJB with nonlinear (quadratic) running cost — LQGC —
              relative-entropy (full backprop-through-rollout,
              detach_forward=False) AND log-variance, validated against
              the Riccati feedback control (problems.py:140-171).
  --config 5  d=1000 HJB long-horizon (T=2, N=200), 10^5-path ensemble.
              One card runs the full ensemble (layout='dk' +
              rng_impl='rbg', sqrt-schedule remat); the dp sharding of this
              exact training step over a mesh is exercised by
              __graft_entry__.dryrun_multichip and
              tests/test_chunked_and_sharding.py — the step contains a
              plain jnp.mean over the path axis, which GSPMD lowers to a
              psum when K is sharded (BASELINE's "shard_map + psum").
"""

import time

from common import parse_args, save

import optax

from pspde.problems import LLGC, LQGC, HeatEquation
from pspde.problems.base import Geometry
from pspde.solvers import GeneralSolver, HJBSolver


def config_2(args):
    d, T = 50, 0.2
    p = HeatEquation(d=d, T=T)
    # diffusion spread sqrt(tr(2 I_50) T) = 4.5 exceeds the default
    # sampling radius 1.0 (solver coverage guard); widen it
    p.geometry = Geometry(kind="unbounded", boundary_distance=6.0)
    L = args.L
    # measured (d=10 CPU sweep + d=50 chip runs): the relu^2 DenseNet is
    # the right family for this large-magnitude value regression (the
    # tanh-skip net stalls 10x worse), and the wall at short budgets is
    # optimization, not ensemble noise — K=512 vs 8192 lands at the same
    # 14-17%.  Train the reference's two arch conventions head-to-head
    # at the lr-1e-2 cosine schedule the d=10 study preferred.
    from pspde.ansatz import DenseNet
    K = 512 if args.smoke else 4096
    models = []
    for name, net in [
        ("arch30-30", None),                                # class default
        ("arch-d20-d-d", DenseNet(d_out=1, arch=(d + 20, d, d))),
    ]:
        s = GeneralSolver(
            p, f"heat-d50-diffusion-{name}", seed=args.seed, L=L,
            lr=optax.cosine_decay_schedule(1e-2, L, alpha=3e-4),
            value_net=net,
            delta_t=2e-3, N=100, K=K, K_boundary=K // 2, K_test_log=16384,
            loss_method="diffusion", print_every=max(L // 20, 1))
        t0 = time.time()
        s.train()
        rel = s.V_test_rel_abs[-1]
        print(f"config 2 (heat d=50 diffusion, {name}): V_test_L2 "
              f"{s.V_test_L2[0]:.3e} -> {s.V_test_L2[-1]:.3e} "
              f"(mean rel err {rel:.2e}, best {min(s.V_test_rel_abs):.2e})"
              f" in {time.time() - t0:.0f} s")
        if args.picard:
            # Domain-anchored parabolic Picard (anchors from the SAME
            # test measure compute_test_error uses): for the h = 0 heat
            # equation the MC targets are exact up to noise, so the
            # stage fits the true value function directly — the measured
            # 14-17% short-budget wall is an optimization artifact the
            # corrector removes in seconds.
            import jax
            from pspde.eval import picard_refine
            from pspde.eval.test_error import compute_test_error
            t0 = time.time()
            _, _, refined = picard_refine(
                p, s.V_net, s.params, x0=None, anchors="domain",
                # anchor-count study (measured): the floor is anchor
                # GENERALIZATION, not MC noise — M=4096 lands at 2.4-3.3%
                # whether K_inner is 256 or 2048 (anchored RMSE ~0.2%,
                # fresh 2.4%: the regression overfits 4096 anchors in the
                # 51-dim input space); spend the path budget on anchors
                n_stages=args.picard, M=256 if args.smoke else 32768,
                K_inner=64 if args.smoke else 256, delta_t=2e-3,
                reg_steps=200 if args.smoke else 8000,
                key=jax.random.PRNGKey(args.seed + 77), verbose=True)
            v_fn = lambda XT: s.V_net.apply(refined, XT)[:, 0]
            _, _, mre = compute_test_error(
                v_fn, p, 16384, jax.random.PRNGKey(5), modus="parabolic")
            print(f"  picard x{args.picard} (domain anchors): mean rel "
                  f"err {rel:.2e} -> {float(mre):.2e} "
                  f"in {time.time() - t0:.0f} s")
            s.params = refined
        models.append(s)
    return models


def config_4(args):
    d = 10 if args.smoke else 100
    K_leg = 2048 if args.smoke else 16384
    p = LQGC(d=d, T=1.0, delta_t=0.01)
    L = args.L
    models = []
    # Ansatz notes (measured): the Riccati control u* = -Q^-1 B^T F(t) x
    # is a full-rank linear map of x — the default 30-wide TanhMLP is a
    # rank-30 bottleneck (plateaus at 88% relative error) and even a
    # 128-wide tanh MLP stalls at 23-46% at this budget.  The tanh
    # concat-skip DenseNet's input skip carries the full-rank linear
    # term for free and converges 10x faster.  (The relu^2 DenseNet is
    # NOT usable here: its unbounded squared features feed back through
    # the adaptive forward process and the d=100 ensemble blows up to
    # NaN within one rollout — bounded activations are load-bearing for
    # adaptively-controlled forward SDEs, which is why the reference's
    # 'inner' default is a tanh net.)
    from pspde.ansatz import DenseNetTanh, LinearLQ

    # normalizer: int E|u*(t, X_t)|^2 dt along zero-controlled paths
    # (a zero-init LQ ansatz tracks u_L2 against the Riccati control)
    s0 = HJBSolver(
        "lqgc-d100-norm", p, seed=args.seed, L=1, lr=0.0, delta_t=0.01,
        K=4096, time_approx="outer", loss_method="log-variance",
        detach_forward=True, verbose=False,
        control_net=LinearLQ(B=p.B, Q=p.Q, init_scale=0.0),
        adaptive_forward_process=True, remat=True,
        early_stopping_time=None)
    s0.train()
    u_star_l2 = s0.u_L2_loss[0]

    # (a per-step LinearLQ outer ansatz — the reference's d=10 protocol —
    # was measured to crawl at d=100: each of the N=100 step-nets sees
    # 1/N of the loss signal.  Round 4: the winning recipe is the
    # shared-across-steps LinearLQTime — a Chebyshev-in-t family of
    # (d, d) gains that CONTAINS the exact Riccati control — trained
    # with relative entropy + full backprop; the tanh-skip DenseNet leg
    # is kept as the generic-ansatz comparison.)
    #
    # Metric note (measured round 4): the training-loop
    # u_L2 follows the reference's semantics (solver.py:491-494: u_true
    # evaluated at the post-step state) and has an O(sqrt(dt)) floor of
    # rel 0.165 at dt=0.01 — the EXACT control reads 0.165 under it.
    # The unbiased same-state metric (eval.control_test_error) is the
    # one with a meaningful <= 5e-2 target.
    from pspde.ansatz import LinearLQTime
    from pspde.eval.test_error import control_test_error

    legs = [
        ("lqtime-relative-entropy",
         LinearLQTime(B=p.B, Q=p.Q, T=p.T, degree=8),
         dict(loss_method="relative_entropy", detach_forward=False,
              learn_Y_0=False, L=L,
              lr=optax.cosine_decay_schedule(1e-2, L, alpha=1e-4))),
        ("densenet-relative-entropy",
         DenseNetTanh(d_out=d, arch=(d + 20, d)),
         dict(loss_method="relative_entropy", detach_forward=False,
              learn_Y_0=False,
              lr=optax.cosine_decay_schedule(3e-3, 2 * L, alpha=1e-3),
              L=2 * L)),
    ]
    for name, net, kw in legs:
        s = HJBSolver(
            f"lqgc-d100-{name}", p, seed=args.seed,
            delta_t=0.01, K=K_leg, time_approx="inner",
            control_net=net,
            adaptive_forward_process=True, remat=True,
            early_stopping_time=None,
            print_every=max(kw["L"] // 20, 1), **kw)
        t0 = time.time()
        s.train()
        rel = (s.u_L2_loss[-1] / u_star_l2) ** 0.5
        rel_ss = control_test_error(p, s, K=4096)
        print(f"config 4 (LQGC d=100, {name}): u_L2 "
              f"{s.u_L2_loss[0]:.3f} -> {s.u_L2_loss[-1]:.4f} "
              f"(ref-semantics rel {rel:.2e}, metric floor 1.65e-1; "
              f"same-state rel {rel_ss:.2e}) in {time.time() - t0:.0f} s")
        models.append(s)
    return models


def config_3(args):
    """BASELINE config 3 AS STATED (VERDICT r4 item 5): HJB double-well
    at d=20 AND d=50, moment vs log-variance head-to-head, 10^4 paths.

    ``DoubleWell_multidim`` scales to any d via the per-dim product FD
    oracle (problems.py:285-476); the mixed-metastability notebook's 30%
    metastable split (eta=3, kappa=5 on d_1 dims, unit wells on the
    rest) is kept: d=20 -> d_1=6, d=50 -> d_1=15.  Both losses train
    with the adaptive (controlled) forward process and detached forward
    drift — apples-to-apples; the moment loss additionally learns Y_0
    (it regresses E-level, solver.py:166).  Validation: per-dim
    FD-oracle u_L2 along paths + the IS relative error of the learned
    control (the metastability experiments' central metric).
    """
    from pspde.eval import importance_sampling
    from pspde.problems import DoubleWell_multidim
    models = []
    ds = [10] if args.smoke else [20, 50]
    K = 512 if args.smoke else 10_000
    for d in ds:
        d_1 = (3 * d) // 10
        p = DoubleWell_multidim(d=d, d_1=d_1, d_2=d - d_1, T=1.0,
                                eta=3.0, kappa=5.0)
        p.compute_reference_solution()
        for name, kw in [
                ("moment", dict(loss_method="moment", learn_Y_0=True)),
                ("log-variance", dict(loss_method="log-variance"))]:
            t0 = time.time()
            s = HJBSolver("c3-%s-d%d" % (name, d), p, L=args.L, lr=5e-3,
                          seed=args.seed, delta_t=0.005, K=K,
                          time_approx="inner",
                          adaptive_forward_process=True,
                          detach_forward=True,
                          print_every=max(args.L // 10, 1),
                          early_stopping_time=None, verbose=False, **kw)
            s.train()
            _, _, rel_is = importance_sampling(
                p, s, K=20000, delta_t=0.005)
            s.IS_rel_log.append(float(rel_is))
            print(f"config 3 d={d} {name}: u_L2 {s.u_L2_loss[0]:.3f} -> "
                  f"{s.u_L2_loss[-1]:.4f}, IS rel err {rel_is:.3f} "
                  f"in {time.time() - t0:.0f} s")
            models.append(s)
    return models


def config_5(args):
    d, T, dt = 1000, 2.0, 0.01
    K = 4096 if args.smoke else 100_000
    p = LLGC(d=d, T=T)
    L = args.L
    s = HJBSolver(
        "llgc-d1000-longhorizon", p, seed=args.seed, L=L,
        lr=optax.cosine_decay_schedule(1e-2, L, alpha=1e-2),
        delta_t=dt, K=K, time_approx="inner",
        loss_method="log-variance", detach_forward=True, learn_Y_0=True,
        adaptive_forward_process=True, layout="dk", rng_impl="rbg",
        remat=True, early_stopping_time=None, steps_per_call=1,
        print_every=max(L // 20, 1))
    # memory note: at (N, d, K) = (200, 1000, 1e5) the plain remat
    # scan's stored carry stack is N*d*K = 80 GB f32, more than one card
    # holds; rollout/sde.py:_remat_scan engages its sqrt-schedule
    # scan-of-scans on a carry-bytes estimate against the device's
    # memory limit, storing ~sqrt(N) carries
    t0 = time.time()
    s.train()
    wall = time.time() - t0
    psps = K * s.N * L / wall
    rel = (s.u_L2_loss[-1] / s.u_L2_loss[0]) ** 0.5
    print(f"config 5 (LLGC d=1000, N={s.N}, K={K}): u_L2 "
          f"{s.u_L2_loss[0]:.3f} -> {s.u_L2_loss[-1]:.4f} (rel {rel:.2e}) "
          f"in {wall:.0f} s ({psps / 1e6:.1f}M path-steps/s incl. compile)")
    return [s]


def main():
    args = parse_args(default_L=3000,
                      extra={"--config": dict(type=str, default="all"),
                             "--picard": dict(type=int, default=2)})
    runs = {"2": config_2, "3": config_3, "4": config_4,
            "5": config_5}
    todo = list(runs) if args.config == "all" else [args.config]
    models = []
    for c in todo:
        if args.smoke and c == "5":
            args_L, args.L = args.L, min(args.L, 10)
            models += runs[c](args)
            args.L = args_L
        else:
            models += runs[c](args)
    # one log file per --config selection (save_exp_logs keys by date and
    # would otherwise overwrite across sequential per-config invocations)
    save(models, "baseline_configs_c%s" % "".join(todo), args)


if __name__ == "__main__":
    main()
