"""Plotting & experiment-log persistence (rebuilds utilities.py:17-225,
400-437, 475-490).

Matplotlib is optional at import time (headless machines may lack it);
every plot function imports it lazily.
"""

from __future__ import annotations

import json
import os
from datetime import date

import jax
import jax.numpy as jnp
import numpy as np

COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
          "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan"]


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_loss_logs(experiment_name, models):
    """Loss / u-L2 / IS-relative-error triptych (utilities.py:17-46)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 3, figsize=(15, 3))
    fig.suptitle("%s, d = %d" % (experiment_name, models[0].d))
    variance_log = all(len(m.IS_rel_log) > 0 for m in models)
    for m in models:
        losses = np.array(m.loss_log)
        if "entropy" in m.loss_method:
            ax[0].plot(losses - losses.min(), label=m.name)
        else:
            ax[0].plot(losses, label=m.name)
        ax[1].plot(m.u_L2_loss, label=m.name)
        if variance_log:
            ax[2].plot(m.IS_rel_log)
    for a in ax:
        a.set_yscale("log")
    ax[0].legend()
    ax[0].set_title("loss")
    ax[1].set_title(r"$\mathbb{E}[\|u - u^*\|^2_{L_2}]$")
    ax[2].set_title("IS relative error")
    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    return fig


def plot_loss_logs_extended(experiment_name, models):
    """Loss / V-L2 / rel-abs test / L2-test quadriptych
    (utilities.py:49-81)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 4, figsize=(15, 3.5))
    fig.suptitle(r"%s, $d = %d$" % (experiment_name, models[0].problem.d))
    for m in models:
        ax[0].plot(m.loss_log, label=m.name)
        ax[1].plot(m.V_L2_log)
        ax[2].plot(m.V_test_rel_abs)
        ax[3].plot(m.V_test_L2)
    for a in ax:
        a.set_yscale("log")
        a.set_xlabel("iterations")
    ax[0].legend()
    ax[0].set_title("loss")
    ax[1].set_title(r"$L^2$ error $V$")
    ax[2].set_title("relative absolute test error")
    ax[3].set_title(r"$L^2$ test error")
    fig.tight_layout(rect=[0, 0.03, 1, 0.93])
    return fig


def plot_moving_average(experiment_name, models, moving_span=400):
    """Moving-average test-error curves (utilities.py:84-105)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 3, figsize=(15, 3.5))
    ax[0].set_title("test error")
    for m in models:
        ax[0].plot(m.V_test_L2, label=m.name)
    ax[1].set_title("moving average relative absolute test error")
    ax[2].set_title(r"moving average $L^2$ test error")
    for m in models:
        n = len(m.V_test_rel_abs) - moving_span
        if n > 0:
            ax[1].plot([np.mean(m.V_test_rel_abs[i:i + moving_span])
                        for i in range(n)], label=m.name)
            ax[2].plot([np.mean(m.V_test_L2[i:i + moving_span])
                        for i in range(n)], label=m.name)
    for a in ax:
        a.set_yscale("log")
        a.legend()
    return fig


def plot_solution(model, x, t, components, ylims=None):
    """Control (and value) slices vs reference at fixed t and fixed x
    (utilities.py:108-173).  ``model`` is an HJBSolver."""
    plt = _plt()
    n = int(np.ceil(t / model.delta_t))
    t_range = np.linspace(0, model.problem.T, model.N)
    x_val = np.linspace(-3, 3, 100, dtype=np.float32)
    X_grid = jnp.asarray(np.repeat(x_val[:, None], model.d, axis=1))

    value_mode = model.approx_method == "value_function"
    fig, ax = plt.subplots(1, 4 if value_mode else 2,
                           figsize=(15 if value_mode else 10, 4))
    fig.suptitle(model.name)

    have_ref = model._u_ref is not None
    u_approx = np.asarray(-model.Z_n(X_grid, t))
    ax[0].set_title("control, t = %.2f" % t)
    for j in components:
        if have_ref:
            u_ref = np.asarray(model._u_ref(X_grid, min(n, model.N - 1)))
            ax[0].plot(x_val, u_ref[:, j], label=r"true $x_%d$" % (j + 1),
                       color=COLORS[j])
        ax[0].plot(x_val, u_approx[:, j], "--",
                   label=r"approx $x_%d$" % (j + 1), color=COLORS[j])
    ax[0].legend()

    X_pt = jnp.full((1, model.d), float(x))
    ax[1].set_title("control, x = %.2f" % x)
    for j in components:
        if have_ref:
            ax[1].plot(t_range,
                       [float(model._u_ref(X_pt, k)[0, j])
                        for k in range(model.N)],
                       label=r"true $x_%d$" % (j + 1), color=COLORS[j])
        ax[1].plot(t_range, [float(-model.Z_n(X_pt, tt)[0, j])
                             for tt in t_range], "--",
                   label=r"approx $x_%d$" % (j + 1), color=COLORS[j])
    if value_mode:
        have_v = model.problem is not None and hasattr(model.problem,
                                                       "v_ref_fn")
        v_ref = model.problem.v_ref_fn(t_range) if have_v else None
        ax[2].set_title("value function, t = %.2f" % t)
        if v_ref is not None:
            ax[2].plot(x_val, np.asarray(
                v_ref(X_grid, min(n, model.N - 1))))
        ax[2].plot(x_val, np.asarray(model.Y_n(X_grid, t)), "--")
        ax[3].set_title("value function, x = %.2f" % x)
        if v_ref is not None:
            ax[3].plot(t_range, [float(v_ref(X_pt, k)[0])
                                 for k in range(model.N)])
        ax[3].plot(t_range, [float(model.Y_n(X_pt, tt)[0])
                             for tt in t_range], "--")

    if ylims is not None:
        for a, yl in zip(ax, ylims):
            a.set_ylim(*yl)
    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    return fig


def plot_control_for_DoubleWell1d(model, fig_file_name_prefix,
                                  plot_ref_control_flag=True):
    """(t, x) heatmap of control vs FD reference + 1-d slices
    (utilities.py:176-225)."""
    plt = _plt()
    from matplotlib import cm
    xb = 2.0
    x_val = np.linspace(-xb, xb, 200, dtype=np.float32)
    X = jnp.asarray(x_val[:, None])
    Z = np.array([np.asarray(-model.Z_n(X, n * model.delta_t)).squeeze()
                  for n in range(model.N)])
    u_min, u_max = -1.0, 4.0
    ncols = 2 if plot_ref_control_flag else 1
    fig_1, ax_1 = plt.subplots(1, ncols, figsize=(15, 6), squeeze=False)
    ax_1[0][0].imshow(Z, cmap=cm.jet, extent=[-xb, xb, 0, model.problem.T],
                      vmin=u_min, vmax=u_max, origin="lower",
                      interpolation="none")
    if plot_ref_control_flag:
        Zr = np.array([np.asarray(model._u_ref(X, n)).squeeze()
                       for n in range(model.N)])
        ax_1[0][1].imshow(Zr, cmap=cm.jet,
                          extent=[-xb, xb, 0, model.problem.T],
                          vmin=u_min, vmax=u_max, origin="lower",
                          interpolation="none")
    fig_1.savefig("%s-2d.eps" % fig_file_name_prefix)

    fig_2, ax_2 = plt.subplots(1, 1, figsize=(10, 6))
    lc = ["r", "k", "b", "g", "c", "y"]
    for idx, tv in enumerate([0.0, 0.2, 0.5, 0.7, 0.97]):
        n = min(int(np.ceil(tv / model.delta_t)), model.N - 1)
        ax_2.plot(x_val, np.asarray(-model.Z_n(X, tv)).squeeze(), "-",
                  color=lc[idx], label=r"$t=%.2f$" % tv)
        if plot_ref_control_flag:
            ax_2.plot(x_val, np.asarray(model._u_ref(X, n)).squeeze(), "--",
                      color=lc[idx])
    ax_2.set_ylim(u_min, u_max)
    ax_2.legend()
    ax_2.set_title(r"Control $u$")
    fig_2.savefig("%s-1d.eps" % fig_file_name_prefix)
    return fig_1, fig_2


def plot_path_ensemble(problem, model, K, fig_file_name_prefix=None,
                       control="zero", delta_t=0.01, how_often=10,
                       key=None):
    """Simulate + plot a controlled path ensemble, reporting the
    barrier-crossing count (utilities.py:400-437; 1-d double well)."""
    plt = _plt()
    if key is None:
        key = jax.random.PRNGKey(0)
    N = int(np.ceil(problem.T / delta_t))
    sig = problem.sigma_struct
    d = problem.d
    if control == "approx":
        from .importance_sampling import _control_closure
        u_fn = _control_closure(model, delta_t, N)
    elif control == "true":
        ur = problem.u_ref_fn(np.arange(N) * delta_t)
        u_fn = lambda X, n: ur(X, n)
    else:
        u_fn = lambda X, n: jnp.zeros_like(X)

    def step(X, n):
        xi = jax.random.normal(jax.random.fold_in(key, n), (K, d))
        ut = u_fn(X, n)
        X = (X + (problem.b(X) + sig.apply(ut)) * delta_t
             + sig.apply(xi) * np.sqrt(delta_t))
        return X, X[:, 0]

    X0 = jnp.broadcast_to(problem.X_0, (K, d))
    _, path = jax.lax.scan(step, X0, jnp.arange(N))
    path = np.asarray(path[::how_often]).T  # (K, N_out)
    tvec = np.arange(path.shape[1]) * delta_t * how_often

    crossed = int((path.max(axis=1) > 0.0).sum())
    print("\nAmong %d paths, %d paths have crossed the barrier "
          "(ratio=%.2f)." % (K, crossed, crossed / K))

    fig, ax = plt.subplots(1, 1, figsize=(10, 6))
    ax.plot(tvec, path.T, "-", color="k", linewidth=0.5)
    ax.set_ylim(-2, 2)
    ax.set_title("path ensemble")
    if fig_file_name_prefix is not None:
        fig.savefig("%s_%s.eps" % (fig_file_name_prefix, control))
    return fig, crossed


def save_exp_logs(models, name, log_dir="logs"):
    """JSON dump of per-model loss/u_L2/IS logs (utilities.py:475-484)."""
    os.makedirs(log_dir, exist_ok=True)
    exp_log = {}
    for m in models:
        entry = {"loss": m.loss_log}
        # HJB solvers log u-L2/IS; elliptic/general/eigen log V-based
        # metrics (solver.py:613-626) — save whichever exists.
        for attr in ("u_L2_loss", "IS_rel_log", "V_L2_log", "V_test_L2",
                     "V_test_abs", "V_test_rel_abs", "lambda_log"):
            if getattr(m, attr, None):
                entry[attr] = getattr(m, attr)
        exp_log[m.name] = entry
    filename = "%s_%s.json" % (name, date.today().strftime("%Y-%m-%d"))
    with open(os.path.join(log_dir, filename), "w") as f:
        json.dump(exp_log, f)
    return os.path.join(log_dir, filename)


def load_exp_logs(filename, log_dir="logs"):
    with open(os.path.join(log_dir, filename)) as f:
        return json.load(f)
