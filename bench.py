#!/usr/bin/env python3
"""Benchmark: SDE path-steps/s per card on the d=100 HJB config (GPU).

Runs the full training step (rollout + log-variance loss + backprop +
Adam update, with the u-L2 reference-error diagnostic ON) of the HJB
solver on a d=100 Ornstein-Uhlenbeck HJB problem, dispatched as
scan-chunked jitted calls exactly like production training, for three
scan modes: float32 row-major ('kd'), float32 transposed with RBG noise
('dk' + rng_impl='rbg') and the bfloat16 variant of the latter.

Baseline: the reference implementation's implied throughput on its
Allen-Cahn d=100 diffusion-loss config is ~15,000 path-steps/s on a CUDA
GPU (BASELINE.md: K*N = 200*25 = 5000 steps per ~0.33 s iteration).

Fails when JAX finds no GPU, and when any mode fails.  Prints the card's
name and power limit, then ONE JSON line.
"""

import json
import subprocess
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 1)[0] if "/" in __file__ else ".")

import jax
import jax.numpy as jnp

from pspde.utils import enable_compilation_cache

enable_compilation_cache()  # reuse step compiles across runs

REFERENCE_PATH_STEPS_PER_SEC = 15_000.0
D = 100
N_STEPS = 32


def measure(dtype, K=131072, d=D, steps_per_call=20, n_chunks=3,
            rng_impl="threefry", layout="kd"):
    from pspde.problems import LLGC
    from pspde.solvers import HJBSolver
    from pspde.solvers._chunk import make_chunked_step

    problem = LLGC(d=d, T=1.0)
    solver = HJBSolver(
        "bench-hjb-d100", problem, lr=1e-3, L=1, K=K, delta_t=1.0 / N_STEPS,
        time_approx="inner", loss_method="log-variance",
        detach_forward=True, learn_Y_0=True, verbose=False,
        early_stopping_time=None, remat=True, dtype=dtype,
        rng_impl=rng_impl, layout=layout)
    N = solver.N
    chunk = make_chunked_step(solver._build_step(0), steps_per_call)

    params, opt_state = solver.params, solver.opt_state
    key = solver._train_key

    t0 = time.perf_counter()
    params, opt_state, key, aux = chunk(params, opt_state, key)  # compile
    jax.block_until_ready(aux["loss"])
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(n_chunks):
        params, opt_state, key, aux = chunk(params, opt_state, key)
    jax.block_until_ready(aux["loss"])
    dt_iter = (time.perf_counter() - t0) / (n_chunks * steps_per_call)
    return {"path_steps_per_sec": K * N / dt_iter, "iter_seconds": dt_iter,
            "setup_seconds_incl_compile": setup_s,
            "resolved_layout": solver.resolved_layout,
            "resolved_rollout_mode": solver.resolved_rollout_mode}


def main():
    dev = jax.devices()
    if dev[0].platform != "gpu":
        sys.exit(f"bench: JAX found no GPU (platform {dev[0].platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    power = smi.stdout.strip().splitlines()
    for line in power:
        print("nvidia-smi:", line.strip(), flush=True)

    results = {
        "f32_scan_kd": measure(jnp.float32),
        "f32_scan_dk_rbg": measure(jnp.float32, rng_impl="rbg",
                                   layout="dk"),
        "bf16_scan_dk_rbg": measure(jnp.bfloat16, rng_impl="rbg",
                                    layout="dk"),
    }
    best_name = max(results, key=lambda k:
                    results[k]["path_steps_per_sec"])
    value = results[best_name]["path_steps_per_sec"] / len(dev)
    out = {
        "metric": "sde_path_steps_per_sec_per_card_d100_hjb",
        "value": value,
        "unit": "path-steps/s/card",
        "vs_baseline": value / REFERENCE_PATH_STEPS_PER_SEC,
        "best_mode": best_name,
        "device": {"platform": dev[0].platform, "kind": dev[0].device_kind,
                   "count": len(dev)},
        "nvidia_smi": power,
        "modes": results,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
