"""Scan-chunked training: run `n_steps` optimizer steps inside ONE jitted
call, carrying (params, opt_state, key) through a ``lax.scan`` and stacking
the per-step metrics.

The reference dispatches one eager iteration at a time (solver.py:430-499);
a jitted-per-step rebuild still pays a host round-trip per iteration, which
can dominate the small-K training configs, whose steps are short.
Chunking amortizes dispatch over `steps_per_call` steps while producing the
exact same iterate/metric trajectory: the per-step PRNG stream is the same
``key, sub = split(key)`` recursion the per-iteration loop uses.
"""

from __future__ import annotations

import jax


def resolve_steps_per_call(solver, chunkable: bool = True) -> int:
    """Resolve ``steps_per_call='auto'`` (the default) to a chunk size.

    The reference trains one eager iteration at a time; at its
    small-K configs (e.g. elliptic solver.py:562-566 defaults K=200)
    the rebuilt step is short, so per-call dispatch can dominate it.
    Auto picks ``min(50, print_every)`` whenever the step is
    phase-static and free of per-iteration host diagnostics
    (`chunkable`, the same gate HJBSolver.train applies); explicit
    integers always force.  The cap at `print_every` keeps the verbose
    print cadence, and 50 bounds how far early stopping can overshoot
    its window (the cap was sized for another machine's dispatch cost
    and is not measured on the GPU).  The resolution is recorded as
    ``solver.resolved_steps_per_call``.
    """
    spc = getattr(solver, "steps_per_call", 1)
    if spc != "auto":
        resolved = int(spc)
    elif not chunkable:
        resolved = 1
    else:
        resolved = max(1, min(50, int(solver.print_every)))
    solver.resolved_steps_per_call = resolved
    return resolved


def make_chunked_step(step_core, n_steps: int):
    """Jit `n_steps` applications of ``step_core(params, opt, key)->
    (params, opt, aux)`` as one call returning the advanced key and the
    stacked per-step aux PyTree (leading axis n_steps)."""

    def chunk(params, opt_state, key):
        def body(carry, _):
            p, o, k = carry
            k, sub = jax.random.split(k)
            p, o, aux = step_core(p, o, sub)
            return (p, o, k), aux

        (params, opt_state, key), auxs = jax.lax.scan(
            body, (params, opt_state, key), None, length=n_steps)
        return params, opt_state, key, auxs

    return jax.jit(chunk, donate_argnums=(0, 1))


def chunk_sizes(total: int, n_steps: int):
    """Split `total` iterations into chunks of `n_steps` plus a remainder."""
    n_steps = max(1, min(int(n_steps), total))
    full, rem = divmod(total, n_steps)
    return n_steps, full, rem


def run_training(solver, step_core, stop_check=None):
    """Generic training driver over a raw ``step_core``.

    Runs ``solver.L`` iterations in jitted chunks of
    ``solver.steps_per_call`` (single-step jit when 1 or for the
    remainder), records each iteration via ``solver._record(aux_row)``,
    advances and persists ``solver._train_key``, and calls the optional
    ``stop_check(done) -> bool`` at chunk boundaries (early stopping)."""
    import time

    L = solver.L
    spc, n_full, rem = chunk_sizes(L, resolve_steps_per_call(solver))
    # record the EFFECTIVE chunk (chunk_sizes caps at L): without this,
    # L=6/auto would record 50 while a 6-step chunk ran (code review r5)
    solver.resolved_steps_per_call = spc
    chunked = make_chunked_step(step_core, spc) if n_full and spc > 1 else None
    # lazy: the remainder (or a resume offset) may need single steps even
    # when L divides steps_per_call
    _single = []

    def single(params, opt_state, sub):
        if not _single:
            _single.append(jax.jit(step_core, donate_argnums=(0, 1)))
        return _single[0](params, opt_state, sub)

    key = solver._train_key
    done = getattr(solver, "step", 0)  # resume point (load_training_state)
    while done < L:
        t0 = time.time()
        if chunked is not None and L - done >= spc:
            solver.params, solver.opt_state, key, auxs = chunked(
                solver.params, solver.opt_state, key)
            auxs = jax.device_get(auxs)
            n = spc
            rows = [jax.tree.map(lambda a: a[i], auxs) for i in range(n)]
        else:
            key, sub = jax.random.split(key)
            solver.params, solver.opt_state, aux = single(
                solver.params, solver.opt_state, sub)
            rows = [jax.device_get(aux)]
            n = 1
        per_iter = (time.time() - t0) / n
        for row in rows:
            solver._record(row)
            solver.times.append(per_iter)
        done += n
        solver.step = done
        solver._train_key = key
        solver._maybe_print(done, n)
        if stop_check is not None and stop_check(done):
            break
