"""Post-processing figures (counterpart of cfd_julia_tpu/utils/plotting.py):
the rebuild of the reference's per-chapter PyPlot scripts, reading the
text outputs the runner writes (utils.io).

Figure catalogue (reference source in parens):
* heat_final          exact-vs-numerical + error (01_.../plotting2.jl)
* burgers_history     time-series overlay of snapshots (05_.../plotting2.jl)
* sod_profiles        4-panel rho/u/e/p, low-res vs high-res 'True'
                      (09_.../plotting.jl:33-91)
* field_contours      filled contours of 2D fields, e.g. vorticity +
                      streamfunction (18_.../plotting.jl:43-71)
* residual_comparison GS-vs-CG-vs-MG semilogy (17_.../res_plotting.jl)
* convergence_order   error-vs-N loglog with slope guides
                      (06_.../order.jl:76-98, 13_.../order.jl:37-66)
* observed_orders     the grid-pair orders (numpy only)

The drawing functions take file paths or arrays and save a PNG; they
import matplotlib (Agg backend, no display) when called, never at module
import, so a machine without matplotlib computes and writes its text
outputs all the same (`have_matplotlib()` says whether it can draw).
"""
from __future__ import annotations

import importlib.util

import numpy as np


def have_matplotlib() -> bool:
    """True where matplotlib is installed (the drawing functions need it)."""
    try:
        return importlib.util.find_spec("matplotlib") is not None
    except ValueError:      # sys.modules holds a matplotlib without a spec
        return False


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def heat_final(field_csv: str, out: str):
    """Exact vs numerical + error from field_final.csv (x ue un uerror)."""
    plt = _pyplot()
    data = np.loadtxt(field_csv, skiprows=1, ndmin=2)
    x, ue, un, err = data.T
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
    a1.plot(x, ue, "k-", label="exact")
    a1.plot(x, un, "r--", label="numerical")
    a1.set_xlabel("x"), a1.set_ylabel("u"), a1.legend()
    a2.plot(x, err, "b-")
    a2.set_xlabel("x"), a2.set_ylabel("error")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def burgers_history(solution_txt: str, out: str):
    """Overlay of the ns stored snapshots (05_.../plotting2.jl:14-23)."""
    plt = _pyplot()
    data = np.loadtxt(solution_txt, ndmin=2)
    x = data[:, 0]
    fig, ax = plt.subplots(figsize=(7, 4))
    for k in range(1, data.shape[1]):
        ax.plot(x, data[:, k], lw=1)
    ax.set_xlabel("x"), ax.set_ylabel("u")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def sod_profiles(outdir: str, out: str, true_dir: str | None = None,
                 gamma: float = 1.4):
    """4-panel rho / velocity / energy / pressure profiles; optionally
    overlays a high-resolution run as 'True' (09_.../plotting.jl:33-91)."""
    plt = _pyplot()
    import os

    def load(d):
        rho = np.loadtxt(os.path.join(d, "solution_d.txt"))
        vel = np.loadtxt(os.path.join(d, "solution_v.txt"))
        en = np.loadtxt(os.path.join(d, "solution_e.txt"))
        x = rho[:, 0]
        r, v, e = rho[:, -1], vel[:, -1], en[:, -1]
        p = (gamma - 1.0) * r * (e - 0.5 * v**2)
        return x, r, v, e, p

    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    labels = ["density", "velocity", "energy", "pressure"]
    series = load(outdir)
    truth = load(true_dir) if true_dir else None
    for ax, lab, ys, yt in zip(
        axes.flat, labels, series[1:],
        (truth[1:] if truth else [None] * 4),
    ):
        if yt is not None:
            ax.plot(truth[0], yt, "k-", lw=1, label="True")
        ax.plot(series[0], ys, "ro", ms=2, label="numerical")
        ax.set_title(lab), ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def field_contours(field_txt: str, out: str, n_fields: int = 2,
                   titles=("vorticity", "streamfunction")):
    """Filled contours from an 'x y f1 f2 ...' dump (18_.../plotting.jl)."""
    plt = _pyplot()
    data = np.loadtxt(field_txt)
    x = np.unique(data[:, 0])
    y = np.unique(data[:, 1])
    nx, ny = len(x), len(y)
    fig, axes = plt.subplots(1, n_fields, figsize=(5.5 * n_fields, 4.5))
    if n_fields == 1:
        axes = [axes]
    for k, ax in enumerate(axes):
        # file is j-major; contourf wants (len(y), len(x)) = exactly
        # the j-major reshape (the old .T ... .T round trip cancelled)
        ff = data[:, 2 + k].reshape(ny, nx)
        cs = ax.contourf(x, y, ff, levels=30, cmap="RdBu_r")
        fig.colorbar(cs, ax=ax)
        if k < len(titles):
            ax.set_title(titles[k])
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def residual_comparison(histories: dict, out: str):
    """Semilogy rms/rms0 vs iteration for several solvers
    (17_.../res_plotting.jl:19-50). histories: {label: path-or-(it, rel)}."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, h in histories.items():
        if isinstance(h, str):
            data = np.loadtxt(h, ndmin=2)
            it, rel = data[:, 0], data[:, 2]
        else:
            it, rel = h
        ax.semilogy(it, rel, label=label)
    ax.set_xlabel("iteration"), ax.set_ylabel("rms / rms0")
    ax.legend(), ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def convergence_order(ns, errors, out: str, slope_guides=(2,),
                      labels=None):
    """Error-vs-N loglog with slope triangles (06_.../order.jl:76-98).
    errors: array or dict {label: errors}."""
    plt = _pyplot()
    if not isinstance(errors, dict):
        errors = {"error": errors}
    ns = np.asarray(ns, float)
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    for lab, errs in errors.items():
        ax.loglog(ns, errs, "o-", label=lab)
    e0 = next(iter(errors.values()))[0]
    for p in slope_guides:
        ax.loglog(ns, e0 * (ns[0] / ns) ** p, "k--", lw=0.8,
                  label=f"slope -{p}")
    ax.set_xlabel("N"), ax.set_ylabel("L2 error")
    ax.legend(), ax.grid(alpha=0.3, which="both")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def observed_orders(ns, errors):
    """Grid-pair observed order p = log(e1/e2)/log(n2/n1)
    (06_.../order.jl:53-75)."""
    ns = np.asarray(ns, float)
    e = np.asarray(errors, float)
    return np.log(e[:-1] / e[1:]) / np.log(ns[1:] / ns[:-1])
