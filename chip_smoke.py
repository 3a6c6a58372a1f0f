#!/usr/bin/env python3
"""Smoke test of pspde's training path on an NVIDIA GPU.

Drives the solvers through their own entry points (``train()``,
``importance_sampling``) at the repository's full-width configurations
and checks what comes out.  Phases, all in this one process:

  (a) device: platform, kind, count, JAX version and the card's name and
      power limit from nvidia-smi; fails when JAX finds no GPU;
  (b) HJB d=100 (LLGC, 30-wide TanhMLP, delta_t=1/32, K=131072,
      log-variance, detach_forward, learn_Y_0): compile seconds,
      seconds per iteration, path-steps/s and peak device bytes, for the
      default layout ('auto', which resolves to 'dk' at this K) and 'kd';
  (c) precision parity: one HJB d=100 loss + gradient at K=8192 on the
      GPU at default matmul precision, on the GPU at "highest" and on the
      CPU at "highest" (same key; threefry noise is backend-independent);
  (d) accuracy: the LLGC d=10 drive recipe (200 iterations; u_L2 must
      fall below 0.05) and importance sampling with the trained control
      (IS relative error well below the naive one);
  (e) stopped family and long horizon: elliptic d=50 diffusion loss at
      K=65536, Allen-Cahn d=100, the Schroedinger eigenproblem d=10 and
      BASELINE config 5 (LLGC d=1000, K=1e5, N=200, sqrt-schedule remat);
  (f) with ``--four-cards`` only, and then nothing else: the HJB d=100
      config for 5 steps and the elliptic d=50 config for 4 steps on a
      4-card 'dp' mesh against the same steps on one card, at "highest"
      (per-step seconds skip the first two steps: the first compiles, and
      the second recompiles for the mesh-placed parameters it receives).

Any failed check raises, so the process exits non-zero and prints no
result line.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Usage:  python chip_smoke.py [--four-cards]
"""

import argparse
import json
import os
import subprocess
import sys
import time

# phase (c) compares against the host CPU in this process: keep the CPU
# backend available when the environment restricts JAX's platforms
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from pspde.utils import enable_compilation_cache  # noqa: E402

# Phase (c) tolerances, as relative errors: |a - b| / |b| for the loss,
# and per parameter leaf ||a - b|| / max(||b||, 1e-3 ||g||) for the
# gradient (g = all gradient leaves; the floor keeps leaves whose exact
# gradient is ~0, like Y_0 under the shift-invariant log-variance loss,
# from dividing rounding noise by rounding noise).
#   GPU "highest" vs CPU "highest": both run true float32 matmuls, so they
#   differ only in summation order and in the approximations of tanh/exp,
#   ~1e-6 relative per operation, grown through 32 Euler steps and the
#   K=8192 path mean.
TOL_GPU_VS_CPU = {"loss": 1e-4, "grad": 1e-3}
#   GPU default vs GPU "highest": the default may run float32 matmuls in
#   TF32, whose operands keep 10 mantissa bits (unit roundoff 2^-11 ~
#   4.9e-4, about 3 decimal digits), so the per-step net outputs carry
#   ~1e-3 relative error into the 32-step value process.
TOL_DEFAULT_VS_HIGHEST = {"loss": 2e-2, "grad": 5e-2}
# Phase (f): the 4-card mesh changes only where the path-axis means are
# summed (psum across cards vs one reduction); Adam's per-parameter
# normalisation can amplify the ~1e-6 difference over a few steps.  The
# CPU-mesh tests hold the same bound.
TOL_MESH_LOSS = 1e-3

HJB_D100 = dict(lr=1e-3, delta_t=1.0 / 32, time_approx="inner",
                loss_method="log-variance", detach_forward=True,
                learn_Y_0=True, verbose=False, early_stopping_time=None)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def emit(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def result_line(devices):
    """The contract's last line: platform, kind and count as JAX reports
    them."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def peak_bytes():
    """Process-wide peak device bytes so far (monotone across phases)."""
    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed_train(solver):
    """Run ``solver.train()`` and split its recorded times into set-up
    (compile) seconds and steady per-iteration seconds.  ``times`` holds
    one per-iteration value per step, equal within a chunk of
    ``resolved_steps_per_call`` steps; the first chunk includes the
    compile."""
    solver.train()
    spc = solver.resolved_steps_per_call
    times = np.asarray(solver.times)
    chunks = times[::spc] * spc
    check(len(chunks) >= 2, "timed_train needs at least two chunks")
    steady = times[spc:][::spc]
    compile_s = float(chunks[0] - np.median(chunks[1:]))
    return compile_s, steady


def finite(name, values):
    values = np.asarray(values, dtype=np.float64)
    check(values.size and np.isfinite(values).all(),
          f"{name}: non-finite values {values[:8]}")


# ----------------------------------------------------------------------
def phase_device(four_cards):
    devices = jax.devices()
    kind = devices[0].device_kind
    emit("a", platform=devices[0].platform, kind=kind, count=len(devices),
         jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""))
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{devices[0].platform!r}); nothing was run")
    if four_cards:
        check(len(devices) >= 4, f"--four-cards needs 4 GPUs, "
                                  f"found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print("nvidia-smi:", line.strip(), flush=True)
    return devices


def phase_hjb_d100():
    from pspde.problems import LLGC
    from pspde.solvers import HJBSolver
    K, L = 131072, 300
    for layout in ("auto", "kd"):
        s = HJBSolver("smoke-hjb-d100", LLGC(d=100, T=1.0), K=K, L=L,
                      layout=layout, **HJB_D100)
        compile_s, steady = timed_train(s)
        finite("HJB d=100 loss", s.loss_log)
        med = float(np.median(steady))
        emit("b", layout=layout, resolved_layout=s.resolved_layout,
             resolved_rollout_mode=s.resolved_rollout_mode,
             steps_per_call=s.resolved_steps_per_call, K=K, N=s.N,
             compile_s=compile_s, s_per_iter_median=med,
             s_per_iter_min=float(steady.min()),
             s_per_iter_max=float(steady.max()),
             spread_pct=100 * float(steady.max() - steady.min()) / med,
             path_steps_per_s=K * s.N / med,
             loss_first=s.loss_log[0], loss_last=s.loss_log[-1],
             peak_bytes_so_far=peak_bytes())


def _hjb_loss_grads(device, precision):
    from pspde.problems import LLGC
    from pspde.solvers import HJBSolver
    with jax.default_device(device), \
            jax.default_matmul_precision(precision):
        s = HJBSolver("smoke-parity", LLGC(d=100, T=1.0), K=8192, L=1,
                      **HJB_D100)
        f = jax.jit(jax.value_and_grad(s._build_step(0).loss_fn,
                                       has_aux=True))
        (loss, _), grads = f(s.params, jax.random.PRNGKey(1234))
        return float(loss), [np.asarray(g, np.float64)
                             for g in jax.tree.leaves(grads)]


def _rel_errors(a, b):
    (la, ga), (lb, gb) = a, b
    total = np.sqrt(sum(float(np.sum(g ** 2)) for g in gb))
    loss_err = abs(la - lb) / max(abs(lb), 1e-30)
    grad_err = max(float(np.linalg.norm(x - y))
                   / max(float(np.linalg.norm(y)), 1e-3 * total)
                   for x, y in zip(ga, gb))
    return loss_err, grad_err


def phase_precision(gpu):
    cpu = jax.devices("cpu")[0]
    gpu_default = _hjb_loss_grads(gpu, None)
    gpu_highest = _hjb_loss_grads(gpu, "highest")
    cpu_highest = _hjb_loss_grads(cpu, "highest")
    for res in (gpu_default, gpu_highest, cpu_highest):
        finite("parity loss", [res[0]])
        for g in res[1]:
            finite("parity gradient", g)
    for name, a, b, tol in (
            ("gpu_highest_vs_cpu", gpu_highest, cpu_highest,
             TOL_GPU_VS_CPU),
            ("gpu_default_vs_highest", gpu_default, gpu_highest,
             TOL_DEFAULT_VS_HIGHEST)):
        loss_err, grad_err = _rel_errors(a, b)
        emit("c", pair=name, loss_rel_err=loss_err, grad_rel_err=grad_err,
             tol_loss=tol["loss"], tol_grad=tol["grad"],
             loss_a=a[0], loss_b=b[0])
        check(loss_err <= tol["loss"] and grad_err <= tol["grad"],
              f"precision parity {name} outside tolerance")


def phase_accuracy():
    from pspde.eval import importance_sampling
    from pspde.problems import LLGC
    from pspde.solvers import HJBSolver
    p = LLGC(d=10, T=1.0)
    s = HJBSolver("llgc", p, lr=1e-2, L=200, K=2048, delta_t=1 / 30,
                  time_approx="inner", loss_method="log-variance",
                  detach_forward=True, learn_Y_0=True, verbose=False,
                  early_stopping_time=None)
    t0 = time.perf_counter()
    s.train()
    train_s = time.perf_counter() - t0
    finite("drive-recipe loss", s.loss_log)
    mn, vn, rn, m_is, v_is, r_is = importance_sampling(
        p, s, K=20000, simulate_naive=True)
    emit("d", u_l2_first=s.u_L2_loss[0], u_l2_last=s.u_L2_loss[-1],
         train_s_incl_compile=train_s, naive_mean=mn, naive_rel_err=rn,
         is_mean=m_is, is_rel_err=r_is)
    check(s.u_L2_loss[-1] < 0.05, "u_L2 did not fall below 0.05")
    check(r_is < 0.1 * rn, "IS relative error not well below the naive one")


def _stopped_run(tag, solver, K, N):
    compile_s, steady = timed_train(solver)
    finite(f"{tag} loss", solver.loss_log)
    med = float(np.median(steady))
    emit("e", config=tag, K=K, N=N, resolved_layout=getattr(
        solver, "resolved_layout", None), compile_s=compile_s,
        s_per_step_median=med, loss_last=solver.loss_log[-1],
        peak_bytes_so_far=peak_bytes())


def phase_stopped_and_long():
    from pspde.ansatz import DenseNet, DenseNetTanh
    from pspde.problems import (AllenCahn, ExponentialOnBallNonlinearSin,
                                LLGC, SchrodingerEigen)
    from pspde.problems.base import Geometry
    from pspde.solvers import (EigenSolver, EllipticSolver, GeneralSolver,
                               HJBSolver)
    d = 50
    s = EllipticSolver(ExponentialOnBallNonlinearSin(d=d, alpha=1.0),
                       "smoke-elliptic-d50", delta_t=1e-3, N=20, lr=1e-3,
                       K=65536, K_boundary=50, L=5, steps_per_call=1,
                       loss_method="diffusion", verbose=False,
                       value_net=DenseNet(d_out=1, arch=(d + 20, d, d, d)))
    _stopped_run("elliptic_d50_diffusion", s, 65536, 20)

    ac = AllenCahn(d=100, T=0.3)
    ac.geometry = Geometry(kind="unbounded", boundary_distance=7.0)
    s = GeneralSolver(ac, "smoke-allen-cahn", N=25, delta_t=1e-3, lr=1e-3,
                      K=200, K_boundary=50, uniform_square=True, L=5,
                      steps_per_call=1, loss_method="diffusion",
                      verbose=False,
                      value_net=DenseNet(d_out=1, arch=(110, 110, 50)))
    _stopped_run("allen_cahn_d100_diffusion", s, 200, 25)

    s = EigenSolver(SchrodingerEigen(d=10), "smoke-eigen", delta_t=1e-3,
                    N=20, lr=1e-3, lambda_init=-2.0, K=500, K_boundary=50,
                    alpha=(50.0, 1.0), normalization="l2_penalty", L=5,
                    steps_per_call=1, verbose=False,
                    value_net=DenseNetTanh(d_out=1, arch=(15, 15, 15, 15),
                                           output_relu=True))
    _stopped_run("schrodinger_eigen_d10", s, 500, 20)

    # BASELINE config 5 (experiments/baseline_configs.py --config 5)
    s = HJBSolver("smoke-config5", LLGC(d=1000, T=2.0), lr=1e-2, L=3,
                  delta_t=0.01, K=100_000, time_approx="inner",
                  loss_method="log-variance", detach_forward=True,
                  learn_Y_0=True, layout="dk", rng_impl="rbg", remat=True,
                  steps_per_call=1, verbose=False,
                  early_stopping_time=None)
    _stopped_run("baseline_config5_llgc_d1000", s, 100_000, s.N)


def phase_four_cards():
    from pspde.ansatz import DenseNet
    from pspde.parallel import make_mesh
    from pspde.problems import ExponentialOnBallNonlinearSin, LLGC
    from pspde.solvers import EllipticSolver, HJBSolver
    mesh = make_mesh(n_dp=4)
    d = 50

    def hjb(**kw):
        return HJBSolver("smoke-dp-hjb", LLGC(d=100, T=1.0), K=131072, L=5,
                         steps_per_call=1, **HJB_D100, **kw)

    def ell(**kw):
        return EllipticSolver(
            ExponentialOnBallNonlinearSin(d=d, alpha=1.0), "smoke-dp-ell",
            delta_t=1e-3, N=20, lr=1e-3, K=65536, K_boundary=50, L=4,
            steps_per_call=1, loss_method="diffusion", verbose=False,
            value_net=DenseNet(d_out=1, arch=(d + 20, d, d, d)), **kw)

    with jax.default_matmul_precision("highest"):
        for tag, make in (("hjb_d100", hjb), ("elliptic_d50", ell)):
            one, four = make(), make(mesh=mesh)
            one.train()
            four.train()
            finite(f"{tag} 1-card loss", one.loss_log)
            finite(f"{tag} 4-card loss", four.loss_log)
            a, b = np.asarray(four.loss_log), np.asarray(one.loss_log)
            err = float(np.max(np.abs(a - b) / np.abs(b)))
            emit("f", config=tag, steps=len(a), loss_1card=b.tolist(),
                 loss_4card=a.tolist(), max_loss_rel_err=err,
                 tol=TOL_MESH_LOSS,
                 s_per_step_1card=float(np.median(one.times[2:])),
                 s_per_step_4card=float(np.median(four.times[2:])),
                 first_step_s_incl_compile_1card=one.times[0],
                 first_step_s_incl_compile_4card=four.times[0])
            check(err <= TOL_MESH_LOSS,
                  f"{tag}: 4-card loss trajectory differs from 1 card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card 'dp' mesh phase")
    args = ap.parse_args(argv)
    devices = phase_device(args.four_cards)
    emit("a", compile_cache=enable_compilation_cache())
    if args.four_cards:
        phase_four_cards()
    else:
        phase_hjb_d100()
        phase_precision(devices[0])
        phase_accuracy()
        phase_stopped_and_long()
    print(result_line(jax.devices()), flush=True)


if __name__ == "__main__":
    main()
