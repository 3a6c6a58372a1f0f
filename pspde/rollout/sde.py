"""Euler-Maruyama SDE rollout engines as ``lax.scan`` loops.

This is the JAX replacement for the reference's eager Python time
loops (solver.py:440-494 for the HJB/parabolic solver, solver.py:723-785
for the stopped elliptic rollout): one ``lax.scan`` over N steps, each step
operating on the whole (K, d) path ensemble, jitted and differentiable
end-to-end (backprop-through-rollout, matching the reference's full-graph
``loss.backward()``), with optional rematerialization for long horizons
(the reference's N=200,000 BSDE runs would not fit activations otherwise).

Noise is generated inside the scan from a folded-in PRNG key, so HBM usage
is O(K d) instead of the reference's pre-drawn (K, d, N+1) tensor
(solver.py:381).

Semantics of one HJB step (solver.py:449-494; note the reference updates X
*before* evaluating h, the accumulators and the reference control, so all
of those see X_{n+1} with time t_n — reproduced exactly):

    Z   = control(X_n, n)                 # pre-step state
    c   = -Z if adaptive else 0           # (detached if detach_forward)
    X'  = X + (b(X) + sigma c) dt + sigma xi sqrt(dt)
    Y  += (-h(t_n, X', Y, Z) + <Z, c>) dt + <Z, xi> sqrt(dt)
    Z_sum, u_L2, ... accumulate at X'
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class HJBRolloutOut(NamedTuple):
    X: jnp.ndarray        # (K, d) terminal state
    Y: jnp.ndarray        # (K,) accumulated value process
    Z_sum: jnp.ndarray    # (K,) KL / Ito accumulators
    u_l2: jnp.ndarray     # (K,) control L2 error accumulator
    add_loss: jnp.ndarray  # (K,) value-mode consistency penalty


@dataclasses.dataclass(frozen=True)
class HJBRolloutConfig:
    N: int
    delta_t: float
    adaptive_forward: bool = True
    detach_forward: bool = False
    accumulate_kl: bool = False       # 'relative_entropy*' losses
    kl_ito_term: bool = False         # 'relative_entropy_BSDE'
    reparametrization: bool = False   # 'reparametrization' loss
    repa_phase: Optional[int] = None  # 'log-variance-repa': l % 2 (static)
    burgers_drift: bool = False
    value_mode: bool = False
    track_u_l2: bool = True
    remat: bool = False
    antithetic: bool = False          # mirrored noise pairs (K even)


def hjb_rollout(
    cfg: HJBRolloutConfig,
    problem,
    control_fn: Callable,     # (params, X, n, t) -> (Z, V_or_None)
    params: Any,
    X0: jnp.ndarray,          # (K, d)
    Y0: jnp.ndarray,          # (K,)
    key: jax.Array,
    u_ref: Optional[Callable] = None,   # (X, n) -> (K, d)
) -> HJBRolloutOut:
    """Forward ensemble rollout with backward value accumulation.

    Mixed precision: the path state X (and hence the net compute, which
    follows the input dtype) runs in ``X0.dtype`` — bf16 halves the
    device-resident scan carry and runs the matmuls in bf16 — while Y,
    Z_sum and the error accumulators ALWAYS accumulate in float32
    (SURVEY.md section 7: Girsanov/value integrals overflow or lose mass
    in bf16)."""
    K, d = X0.shape
    x_dtype = X0.dtype
    dt = jnp.float32(cfg.delta_t)
    sq_dt = jnp.sqrt(dt)
    f32 = jnp.float32
    sig = problem.sigma_struct

    def step(carry, n):
        X, Y, Z_sum, u_l2, add_loss = carry
        t = n.astype(jnp.float32) * dt

        Z, V_here = control_fn(params, X, n, t)

        if cfg.value_mode:
            # solver.py:441-443: consistency penalty (V(X_n, t_n) - Y_n)^2
            # for n > 0
            add_loss = add_loss + jnp.where(
                n > 0, (V_here.astype(f32) - Y) ** 2, jnp.zeros_like(Y))

        if cfg.repa_phase is not None and cfg.repa_phase == 0:
            # even iteration of 'log-variance-repa' (solver.py:444-447):
            # Z from a frozen copy, gradient flows through the forward
            # process only.
            Z_used = lax.stop_gradient(Z)
        else:
            Z_used = Z

        if cfg.adaptive_forward:
            if cfg.burgers_drift:
                # solver.py:453-454
                c = jnp.ones_like(X) * (Y[:, None] - (2.0 + d) / (2.0 * d))
            else:
                c = -Z
        else:
            c = jnp.zeros_like(X)
        if cfg.detach_forward or (cfg.repa_phase is not None
                                  and cfg.repa_phase == 1):
            c = lax.stop_gradient(c)

        # noise in f32 (bf16 rounding would bias the accumulated
        # integrals); the state update casts back to the carry dtype
        if cfg.antithetic:
            # mirrored pairs (xi, -xi): rows i and i + K/2 share one
            # noise stream up to sign — the batch-mean gradient's odd
            # noise components cancel pairwise (variance-reduced
            # training; see eval/importance_sampling.py antithetic)
            xi_h = jax.random.normal(jax.random.fold_in(key, n),
                                     (K // 2, d), dtype=f32)
            xi = jnp.concatenate([xi_h, -xi_h], axis=0)
        else:
            xi = jax.random.normal(jax.random.fold_in(key, n), (K, d),
                                   dtype=f32)

        X_new = (X + (problem.b(X) + sig.apply(c)) * dt
                 + sig.apply(xi) * sq_dt).astype(x_dtype)
        if cfg.detach_forward:
            # with a detached control the X chain carries no parameter
            # gradient; cutting it explicitly prunes the (useless but
            # nonzero) X-cotangent backward work — one dense drift
            # backward matmul per step at d=100
            X_new = lax.stop_gradient(X_new)

        Z32 = Z_used.astype(f32)
        Zc = jnp.sum(Z32 * c.astype(f32), axis=-1)
        Zxi = jnp.sum(Z32 * xi, axis=-1)
        Y_new = (Y + (-problem.h(t, X_new, Y, Z_used).astype(f32) + Zc) * dt
                 + Zxi * sq_dt)

        if cfg.reparametrization:
            # solver.py:459-466, 480-482: v from a frozen copy of the net
            v = lax.stop_gradient(-Z).astype(f32)
            Z_sum = Z_sum + (-0.5 * jnp.sum(v * v, axis=-1) * dt
                             + jnp.sum(v * c.astype(f32), axis=-1) * dt
                             + jnp.sum(v * xi, axis=-1) * sq_dt)
        if cfg.accumulate_kl:
            # solver.py:484-489
            Z_sum = Z_sum + (0.5 * jnp.sum(Z32 * Z32, axis=-1)
                             + problem.f(X_new, t).astype(f32)) * dt
            if cfg.kl_ito_term:
                Z_sum = Z_sum - Zxi * sq_dt

        if cfg.track_u_l2 and u_ref is not None:
            # solver.py:491-494 (device-side table lookup, no host sync)
            err = (-lax.stop_gradient(Z32)
                   - u_ref(X_new, n).astype(f32))
            u_l2 = u_l2 + jnp.sum(err * err, axis=-1) * dt

        return (X_new, Y_new, Z_sum, u_l2, add_loss), None

    if cfg.remat:
        step = jax.checkpoint(step, prevent_cse=False)

    zeros = jnp.zeros((K,), dtype=f32)
    carry0 = (X0, Y0.astype(f32), zeros, zeros, zeros)
    (X, Y, Z_sum, u_l2, add_loss) = _remat_scan(
        step, carry0, cfg.N, cfg.remat)
    return HJBRolloutOut(X, Y, Z_sum, u_l2, add_loss)


def hjb_rollout_dk(
    cfg: HJBRolloutConfig,
    problem,
    control_T_fn: Callable,   # (params, XT (d, K), n, t) -> ZT (d, K)
    params: Any,
    X0T: jnp.ndarray,         # (d, K)
    Y0: jnp.ndarray,          # (K,)
    key: jax.Array,
    u_tab: Optional[jnp.ndarray] = None,  # (N, d) state-indep. reference
    noise_layout: str = "dk",
) -> HJBRolloutOut:
    """Transposed (d, K) variant of :func:`hjb_rollout`.

    The path state is carried as (d, K) COLUMNS so every net matmul puts
    the huge path axis in the minor dimension (ansatz/transposed.py
    layout note).  Whether that is faster than the row-major engine on
    the GPU is not measured yet.  Semantics are identical to
    :func:`hjb_rollout` step-for-step (solver.py:449-494 order).

    Requirements (asserted): control mode, no burgers drift, problem
    implements the transposed-coefficient protocol (base.py: b_T / h_T /
    f_T), and u-L2 tracking only via a state-independent table ``u_tab``.

    ``noise_layout='kd'`` draws the exact fold_in noise stream of
    :func:`hjb_rollout` (a (K, d) draw transposed per step — one extra
    relayout per step, for bitwise equivalence tests); the default 'dk'
    draws (d, K) directly (statistically identical, bitwise different).

    Returns X in the standard (K, d) row layout (one terminal transpose).
    """
    assert not cfg.value_mode and not cfg.burgers_drift
    d, K = X0T.shape
    x_dtype = X0T.dtype
    dt = jnp.float32(cfg.delta_t)
    sq_dt = jnp.sqrt(dt)
    f32 = jnp.float32
    sig = problem.sigma_struct

    def step(carry, n):
        XT, Y, Z_sum, u_l2 = carry
        t = n.astype(f32) * dt

        ZT = control_T_fn(params, XT, n, t)
        if cfg.repa_phase is not None and cfg.repa_phase == 0:
            Z_used = lax.stop_gradient(ZT)
        else:
            Z_used = ZT

        c = -ZT if cfg.adaptive_forward else jnp.zeros_like(XT)
        if cfg.detach_forward or (cfg.repa_phase is not None
                                  and cfg.repa_phase == 1):
            c = lax.stop_gradient(c)

        if cfg.antithetic:
            # mirrored pairs along the path axis (cf. hjb_rollout)
            if noise_layout == "kd":
                xi_h = jax.random.normal(jax.random.fold_in(key, n),
                                         (K // 2, d), dtype=f32).T
            else:
                xi_h = jax.random.normal(jax.random.fold_in(key, n),
                                         (d, K // 2), dtype=f32)
            xi = jnp.concatenate([xi_h, -xi_h], axis=1)
        elif noise_layout == "kd":
            xi = jax.random.normal(jax.random.fold_in(key, n), (K, d),
                                   dtype=f32).T
        else:
            xi = jax.random.normal(jax.random.fold_in(key, n), (d, K),
                                   dtype=f32)

        XT_new = (XT + (problem.b_T(XT) + sig.apply_cols(c)) * dt
                  + sig.apply_cols(xi) * sq_dt).astype(x_dtype)
        if cfg.detach_forward:
            XT_new = lax.stop_gradient(XT_new)

        Z32 = Z_used.astype(f32)
        Zc = jnp.sum(Z32 * c.astype(f32), axis=0)
        Zxi = jnp.sum(Z32 * xi, axis=0)
        Y_new = (Y + (-problem.h_T(t, XT_new, Y, Z_used).astype(f32)
                      + Zc) * dt
                 + Zxi * sq_dt)

        if cfg.reparametrization:
            v = lax.stop_gradient(-ZT).astype(f32)
            Z_sum = Z_sum + (-0.5 * jnp.sum(v * v, axis=0) * dt
                             + jnp.sum(v * c.astype(f32), axis=0) * dt
                             + jnp.sum(v * xi, axis=0) * sq_dt)
        if cfg.accumulate_kl:
            Z_sum = Z_sum + (0.5 * jnp.sum(Z32 * Z32, axis=0)
                             + problem.f_T(XT_new, t).astype(f32)) * dt
            if cfg.kl_ito_term:
                Z_sum = Z_sum - Zxi * sq_dt

        if cfg.track_u_l2 and u_tab is not None:
            err = -lax.stop_gradient(Z32) - u_tab[n][:, None]
            u_l2 = u_l2 + jnp.sum(err * err, axis=0) * dt

        return (XT_new, Y_new, Z_sum, u_l2), None

    if cfg.remat:
        step = jax.checkpoint(step, prevent_cse=False)

    zeros = jnp.zeros((K,), dtype=f32)
    carry0 = (X0T, Y0.astype(f32), zeros, zeros)
    (XT, Y, Z_sum, u_l2) = _remat_scan(step, carry0, cfg.N, cfg.remat)
    return HJBRolloutOut(XT.T, Y, Z_sum, u_l2, jnp.zeros_like(Y))


# Stored-carry budget on a device that reports no memory limit (the host
# CPU): 8 GiB.
HOST_CARRY_BUDGET_BYTES = 8 << 30


def carry_budget_bytes() -> int:
    """Bytes the stored scan carries may take before :func:`_remat_scan`
    switches to its sqrt schedule: half the first local device's memory
    limit (``memory_stats()['bytes_limit']``, what the JAX process may
    allocate), leaving the other half for the step's other buffers; the
    host constant where the device reports no limit."""
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 2 if limit else HOST_CARRY_BUDGET_BYTES


def _remat_scan(step, carry0, N: int, remat: bool, threshold: int = 2048):
    """Run ``lax.scan(step, carry0, arange(N))`` — but for long
    rematerialized horizons, as a sqrt-schedule scan-of-scans.

    Reverse-mode over a length-N scan stores the CARRY at every step
    (~N*K*d floats — 9 GB at the reference's N=200,000 BSDE config,
    notebook cell 14) regardless of per-step checkpointing, which only
    trims within-step intermediates.  Chunking with the inner
    ~sqrt(N)-step scan rematerialized stores only the ~sqrt(N) outer
    carries and recomputes each chunk on the backward pass: memory
    O(sqrt(N)*K*d), compute ~2x forward.  Steps beyond N (grid padding)
    are masked to no-ops, so outputs and gradients are bitwise the plain
    scan's (tests/test_remat.py).

    The schedule engages when remat is on and EITHER the horizon is long
    (N > threshold) or the stored-carry stack alone would exceed
    :func:`carry_budget_bytes` (f32 estimate)
    — e.g. the d=1000, K=1e5, N=200 ensemble (BASELINE config 5) stores
    an 80 GB f32 X stack under the plain scan, more than one 80 GB card
    holds, but about 6 GB under the sqrt schedule."""
    carry_bytes = sum(
        math.prod(jnp.shape(x)) * jnp.result_type(x).itemsize
        for x in jax.tree.leaves(carry0))
    if not (remat and (N > threshold
                       or N * carry_bytes > carry_budget_bytes())):
        out, _ = lax.scan(step, carry0, jnp.arange(N))
        return out

    inner = int(math.isqrt(N - 1)) + 1
    outer = -(-N // inner)

    def inner_chunk(carry, ns):
        def gated(c, n):
            c_new, _ = step(c, n)
            c_new = jax.tree.map(
                lambda a, b: jnp.where(n < N, a, b), c_new, c)
            return c_new, None
        carry, _ = lax.scan(gated, carry, ns)
        return carry, None

    inner_chunk = jax.checkpoint(inner_chunk, prevent_cse=False)
    ns = jnp.arange(outer * inner).reshape(outer, inner)
    out, _ = lax.scan(inner_chunk, carry0, ns)
    return out


def hjb_rollout_batched_grad(
    cfg: HJBRolloutConfig,
    problem,
    control_fn: Callable,
    params: Any,
    X0: jnp.ndarray,
    Y0: jnp.ndarray,
    key: jax.Array,
    u_ref: Optional[Callable] = None,
) -> HJBRolloutOut:
    """Fast path for the detached-forward control-mode rollout.

    When ``detach_forward=True`` and h does not depend on y, the X path
    carries NO parameter gradient, and Y decomposes into per-step terms
    Y = Y_0 + sum_n a(t_n, X_{n+1}, Z_n, xi_n) that depend on the
    parameters only through Z_n = z_theta(t_n, X_n).  So instead of
    backpropagating through the sequential scan (N small backward
    kernels), we: (1) run a lean gradient-free scan that materializes the
    X path, then (2) evaluate the control network ONCE on the flattened
    (N*K, d) batch — a single large matmul stack whose backward is
    equally batched.  Identical outputs to
    :func:`hjb_rollout` (same per-step noise keys).

    Requirements (asserted): control mode, detach_forward, no value mode,
    no repa phase, h independent of y (problem.h ignores its y argument,
    true for the quadratic-cost HJB family).
    """
    assert cfg.detach_forward and not cfg.value_mode
    assert cfg.repa_phase is None and not cfg.burgers_drift
    K, d = X0.shape
    N = cfg.N
    dt = jnp.float32(cfg.delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct

    # ---- phase 1: parameter-free forward path (collect X_pre, X_post, xi)
    frozen = lax.stop_gradient(params)

    def fwd_step(X, n):
        t = n.astype(jnp.float32) * dt
        Z, _ = control_fn(frozen, X, n, t)
        c = -Z if cfg.adaptive_forward else jnp.zeros_like(X)
        if cfg.antithetic:
            xi_h = jax.random.normal(jax.random.fold_in(key, n),
                                     (K // 2, d), dtype=X.dtype)
            xi = jnp.concatenate([xi_h, -xi_h], axis=0)
        else:
            xi = jax.random.normal(jax.random.fold_in(key, n), (K, d),
                                   dtype=X.dtype)
        X_new = X + (problem.b(X) + sig.apply(c)) * dt + sig.apply(xi) * sq_dt
        return X_new, (X, X_new, xi)

    X_final, (X_pre, X_post, xis) = lax.scan(fwd_step, X0, jnp.arange(N))
    return _assemble_hjb_from_path(cfg, problem, control_fn, params, Y0,
                                   X_pre, X_post, X_final, xis,
                                   u_ref=u_ref)


def _assemble_hjb_from_path(cfg, problem, control_fn, params, Y0,
                            X_pre, X_post, X_final, xis,
                            u_ref=None) -> HJBRolloutOut:
    """Phases 2-3 of the batched-gradient rollout: given the (N, K, d)
    parameter-free path and its driving noise, evaluate the control ONCE
    on the flattened batch and assemble Y / Z_sum / u_l2."""
    N, K, d = X_pre.shape
    dt = jnp.float32(cfg.delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct

    # ---- phase 2: one batched, differentiable control evaluation -------
    ns = jnp.arange(N)
    ts = ns.astype(jnp.float32) * dt
    # control_fn consumes (K, d) batches per step; vmap over the step axis
    # keeps 'outer' per-step parameter stacks correct while XLA fuses the
    # N x K rows into large matmuls.
    Z_all, _ = jax.vmap(
        lambda X, n, t: control_fn(params, X, n, t))(X_pre, ns, ts)

    c_all = lax.stop_gradient(-Z_all) if cfg.adaptive_forward \
        else jnp.zeros_like(Z_all)
    Zc = jnp.sum(Z_all * c_all, axis=-1)          # (N, K)
    Zxi = jnp.sum(Z_all * xis, axis=-1)
    h_all = jax.vmap(
        lambda t, Xn, Z: problem.h(t, Xn, jnp.zeros((K,), X_pre.dtype), Z))(
        ts, X_post, Z_all)
    Y = Y0 + jnp.sum((-h_all + Zc) * dt + Zxi * sq_dt, axis=0)

    Z_sum = jnp.zeros((K,), dtype=X_pre.dtype)
    if cfg.reparametrization:
        v_all = lax.stop_gradient(-Z_all)
        Z_sum = Z_sum + jnp.sum(
            -0.5 * jnp.sum(v_all * v_all, -1) * dt
            + jnp.sum(v_all * c_all, -1) * dt
            + jnp.sum(v_all * xis, -1) * sq_dt, axis=0)
    if cfg.accumulate_kl:
        f_all = jax.vmap(lambda Xn, t: problem.f(Xn, t))(X_post, ts)
        Z_sum = Z_sum + jnp.sum(
            (0.5 * jnp.sum(Z_all * Z_all, -1) + f_all) * dt, axis=0)
        if cfg.kl_ito_term:
            Z_sum = Z_sum - jnp.sum(Zxi, axis=0) * sq_dt

    u_l2 = jnp.zeros((K,), dtype=X_pre.dtype)
    if cfg.track_u_l2 and u_ref is not None:
        err = jax.vmap(lambda Z, Xn, n: -Z - u_ref(Xn, n))(
            lax.stop_gradient(Z_all), X_post, ns)
        u_l2 = jnp.sum(jnp.sum(err * err, -1) * dt, axis=0)

    return HJBRolloutOut(X_final, Y, Z_sum, u_l2,
                         jnp.zeros((K,), dtype=X_pre.dtype))


class StoppedRolloutOut(NamedTuple):
    X: jnp.ndarray          # (K, d) state at stopping (or final) time
    Y: jnp.ndarray          # (K,) accumulated value increments
    t: jnp.ndarray          # (K,) per-path elapsed time (general solver)
    stopped: jnp.ndarray    # (K,) bool
    hitting: jnp.ndarray    # (K,) number of active steps taken
    v_l2: jnp.ndarray       # (K,) accumulated V-vs-reference L2 error
    step_loss: jnp.ndarray  # () accumulated per-step losses (BSDE-2/3)
    active_count: jnp.ndarray  # () total active path-steps (K_log)


@dataclasses.dataclass(frozen=True)
class StoppedRolloutConfig:
    N: int
    delta_t: float
    adaptive_forward: bool = False
    detach_forward: bool = True
    recursive_y_in_h: bool = False   # BSDE-2 / BSDE-4: h sees recursive Y
    step_loss: Optional[str] = None  # None | 'BSDE-2' | 'BSDE-3'
    time_stopping: bool = False      # general solver: stop when t + dt > T
    no_y_update: bool = False        # solve_linear_L2_projection flag
    remat: bool = False
    alpha0: float = 1.0


def stopped_rollout(
    cfg: StoppedRolloutConfig,
    problem,
    value_grad_fn: Callable,  # (params, X, t) -> (V, Z) with Z = sigma^T grad V
    params: Any,
    X0: jnp.ndarray,
    Y0: jnp.ndarray,
    t0: jnp.ndarray,          # (K,) start times (zeros for elliptic)
    key: jax.Array,
    inside_fn: Callable,      # (X, X_proposal) -> (K,) bool domain test
    v_ref: Optional[Callable] = None,   # (X,) -> (K,) elliptic reference
) -> StoppedRolloutOut:
    """Fixed-length rollout with stopped-path masking (solver.py:723-785).

    Masking algebra mirrors the reference exactly: the exit test produces
    ``new_selection``; Y only advances on ``new_selection & ~stopped``; X
    freezes once a path leaves the domain (or exhausts the time horizon in
    the general-solver case, solver.py:1131).
    """
    K, d = X0.shape
    dt = jnp.float32(cfg.delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct
    T = problem.T if cfg.time_stopping else None

    def step(carry, n):
        X, Y, t, stopped, hitting, v_l2, step_loss, active_count = carry
        active = ~stopped

        V_here, Z = value_grad_fn(params, X, t)

        if v_ref is not None:
            err = (lax.stop_gradient(V_here) - v_ref(X)) ** 2
            v_l2 = v_l2 + jnp.where(active, err, 0.0) * dt

        if cfg.adaptive_forward:
            c = -Z
        else:
            c = jnp.zeros_like(X)
        if cfg.detach_forward:
            c = lax.stop_gradient(c)

        xi = jax.random.normal(jax.random.fold_in(key, n), (K, d),
                               dtype=X.dtype)
        drift = (problem.b(X) + sig.apply(c)) * dt + sig.apply(xi) * sq_dt
        X_prop = X + drift * active[:, None].astype(X.dtype)

        new_sel = inside_fn(X, X_prop)
        if cfg.time_stopping:
            new_sel = new_sel & ((t + dt) <= T)
        adv = new_sel & active
        advf = adv.astype(X.dtype)

        hitting = hitting + active.astype(X.dtype)

        if cfg.step_loss == "BSDE-2":
            # solver.py:762-763
            step_loss = step_loss + cfg.alpha0 * jnp.mean(
                (V_here - Y) ** 2 * advf)

        if cfg.no_y_update:
            # solve_linear_L2_projection (solver.py:1099, 1136): Y stays at
            # its initial value V(X_0, t_0)
            Y_new = Y
            h_val = jnp.zeros_like(Y)
        else:
            y_in_h = Y if cfg.recursive_y_in_h else V_here
            h_val = _call_h(problem, t, X, y_in_h, Z)
            dY = ((-h_val + jnp.sum(Z * c, axis=-1)) * dt
                  + jnp.sum(Z * xi, axis=-1) * sq_dt)
            Y_new = Y + dY * advf

        X_new = jnp.where(adv[:, None], X_prop, X)
        t_new = t + dt * advf if cfg.time_stopping else t

        if cfg.step_loss == "BSDE-3":
            # one-step residual, solver.py:782-785
            V_next, _ = value_grad_fn(params, X_new, t_new)
            resid = (V_next - V_here
                     + (h_val - jnp.sum(Z * c, axis=-1)) * dt
                     - jnp.sum(Z * xi, axis=-1) * sq_dt)
            step_loss = step_loss + cfg.alpha0 * jnp.mean(resid ** 2 * advf)

        active_count = active_count + jnp.sum(advf)
        stopped_new = stopped | ~new_sel

        return (X_new, Y_new, t_new, stopped_new, hitting, v_l2, step_loss,
                active_count), None

    if cfg.remat:
        step = jax.checkpoint(step, prevent_cse=False)

    zeros = jnp.zeros((K,), dtype=X0.dtype)
    carry0 = (X0, Y0, t0, jnp.zeros((K,), dtype=bool), zeros, zeros,
              jnp.float32(0.0), jnp.float32(0.0))
    out = _remat_scan(step, carry0, cfg.N, cfg.remat)
    return StoppedRolloutOut(*out)


def stopped_rollout_dk(
    cfg: StoppedRolloutConfig,
    problem,
    value_grad_fn_T: Callable,  # (params, XT (d,K), t) -> (V (K,), ZT (d,K))
    params: Any,
    X0T: jnp.ndarray,         # (d, K)
    Y0: jnp.ndarray,
    t0: jnp.ndarray,          # (K,)
    key: jax.Array,
    inside_fn_T: Callable,    # (XT, XT_prop) -> (K,) bool domain test
    v_ref_T: Optional[Callable] = None,   # (XT,) -> (K,)
    noise_layout: str = "dk",
) -> StoppedRolloutOut:
    """Transposed (d, K) variant of :func:`stopped_rollout`.

    The path state is carried as (d, K) COLUMNS so the value-net matmuls
    — including the per-step vjp that computes Z = sigma^T grad V
    (solver.py:725-729) — run with the path axis as the minor dimension
    (ansatz/transposed.py layout note).  Masking algebra is
    step-for-step :func:`stopped_rollout` (solver.py:723-785), with every
    per-path mask a (K,) row vector broadcast over columns.

    Requirements: problem implements the transposed-coefficient protocol
    (base.py: b_T / h_T), ``inside_fn_T`` from
    rollout/sampling.py: inside_fn_cols, and a column-layout
    ``value_grad_fn_T`` (solvers build it from ansatz/transposed.py:
    transposed_apply).  ``noise_layout='kd'`` draws the exact fold_in
    noise stream of :func:`stopped_rollout` (one extra relayout per step;
    bitwise equivalence tests); the default 'dk' draws (d, K) directly.

    Returns X in the standard (K, d) row layout (one terminal transpose).
    """
    d, K = X0T.shape
    dt = jnp.float32(cfg.delta_t)
    sq_dt = jnp.sqrt(dt)
    sig = problem.sigma_struct
    T = problem.T if cfg.time_stopping else None

    def step(carry, n):
        XT, Y, t, stopped, hitting, v_l2, step_loss, active_count = carry
        active = ~stopped

        V_here, ZT = value_grad_fn_T(params, XT, t)

        if v_ref_T is not None:
            err = (lax.stop_gradient(V_here) - v_ref_T(XT)) ** 2
            v_l2 = v_l2 + jnp.where(active, err, 0.0) * dt

        if cfg.adaptive_forward:
            c = -ZT
        else:
            c = jnp.zeros_like(XT)
        if cfg.detach_forward:
            c = lax.stop_gradient(c)

        if noise_layout == "kd":
            xi = jax.random.normal(jax.random.fold_in(key, n), (K, d),
                                   dtype=XT.dtype).T
        else:
            xi = jax.random.normal(jax.random.fold_in(key, n), (d, K),
                                   dtype=XT.dtype)
        drift = (problem.b_T(XT) + sig.apply_cols(c)) * dt \
            + sig.apply_cols(xi) * sq_dt
        XT_prop = XT + drift * active[None, :].astype(XT.dtype)

        new_sel = inside_fn_T(XT, XT_prop)
        if cfg.time_stopping:
            new_sel = new_sel & ((t + dt) <= T)
        adv = new_sel & active
        advf = adv.astype(XT.dtype)

        hitting = hitting + active.astype(XT.dtype)

        if cfg.step_loss == "BSDE-2":
            step_loss = step_loss + cfg.alpha0 * jnp.mean(
                (V_here - Y) ** 2 * advf)

        if cfg.no_y_update:
            Y_new = Y
            h_val = jnp.zeros_like(Y)
        else:
            y_in_h = Y if cfg.recursive_y_in_h else V_here
            h_val = _call_h_T(problem, t, XT, y_in_h, ZT)
            dY = ((-h_val + jnp.sum(ZT * c, axis=0)) * dt
                  + jnp.sum(ZT * xi, axis=0) * sq_dt)
            Y_new = Y + dY * advf

        XT_new = jnp.where(adv[None, :], XT_prop, XT)
        t_new = t + dt * advf if cfg.time_stopping else t

        if cfg.step_loss == "BSDE-3":
            V_next, _ = value_grad_fn_T(params, XT_new, t_new)
            resid = (V_next - V_here
                     + (h_val - jnp.sum(ZT * c, axis=0)) * dt
                     - jnp.sum(ZT * xi, axis=0) * sq_dt)
            step_loss = step_loss + cfg.alpha0 * jnp.mean(resid ** 2 * advf)

        active_count = active_count + jnp.sum(advf)
        stopped_new = stopped | ~new_sel

        return (XT_new, Y_new, t_new, stopped_new, hitting, v_l2, step_loss,
                active_count), None

    if cfg.remat:
        step = jax.checkpoint(step, prevent_cse=False)

    zeros = jnp.zeros((K,), dtype=X0T.dtype)
    carry0 = (X0T, Y0, t0, jnp.zeros((K,), dtype=bool), zeros, zeros,
              jnp.float32(0.0), jnp.float32(0.0))
    out = _remat_scan(step, carry0, cfg.N, cfg.remat)
    return StoppedRolloutOut(out[0].T, *out[1:])


def _call_h(problem, t, x, y, z):
    """Dispatch the reference's two h signatures: elliptic h(x, y, z)
    (problems.py:985) vs parabolic h(t, x, y, z) (problems.py:45)."""
    if getattr(problem, "T", None) is None:
        return problem.h(x, y, z)
    return problem.h(t, x, y, z)


def _call_h_T(problem, t, xT, y, zT):
    """Column-layout dispatch of :func:`_call_h` (h_T protocol, base.py)."""
    if getattr(problem, "T", None) is None:
        return problem.h_T(xT, y, zT)
    return problem.h_T(t, xT, y, zT)
