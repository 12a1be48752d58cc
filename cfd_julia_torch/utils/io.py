"""Reference-compatible text writers + structured metrics (counterpart of
cfd_julia_tpu/utils/io.py; same formats).

`output.txt` error and residual reports (ftcs.jl:48-52,
gauss_seidel.jl:50-52), residual histories "(it, rms, rms/rms0)"
(gauss_seidel.jl:41-47), 2D field dumps "x y w s"
(lid_driven_cavity.jl:205-210), 1D snapshot histories "x u(t1) u(t2) ..."
(weno_dirichlet.jl:171-180) and column files, written once after the
run; `write_metrics` emits a JSON record per run.  Inputs are numpy arrays
or tensors on any device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _np64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _ensure_dir(path):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)


def write_error_report(path, l2, linf, extra=None):
    """`output.txt` error report (ftcs.jl:48-52)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write("Error details:\n")
        f.write(f"L-2 Norm={float(l2)}\n")
        f.write(f"Maximum Norm={float(linf)}\n")
        for k, v in (extra or {}).items():
            f.write(f"{k}={v}\n")


def write_residual_report(path, rms, linf, iterations):
    """Iterative-solver `output.txt` (gauss_seidel.jl:50-52)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write("Residual details:\n")
        f.write(f"L-2 Norm={float(rms)}\n")
        f.write(f"Maximum Norm={float(linf)}\n")
        f.write(f"Iterations={int(iterations)}\n")


def write_solution_history(path, x, snapshots):
    """`solution_*.txt`: each row `x u(t1) u(t2) ...`
    (weno_dirichlet.jl:171-180).  snapshots: (ns, n)."""
    _ensure_dir(path)
    mat = np.column_stack([_np64(x), _np64(snapshots).T])
    with open(path, "w") as f:
        np.savetxt(f, mat, fmt="%.17g", delimiter=" ")


def write_residual_history(path, history, n_records=None):
    """`*_residual.txt`: `it rms rms/rms0` lines (gauss_seidel.jl:44);
    history is the solver's NaN-padded (max_records, 3) buffer."""
    _ensure_dir(path)
    h = _np64(history)
    if n_records is not None:
        h = h[: int(n_records)]
    h = h[~np.isnan(h[:, 0])]
    with open(path, "w") as f:
        for it, rms, rel in h:
            f.write(f"{int(it)} {float(rms)!r} {float(rel)!r}\n")


def _write_rows(f, arrays):
    """Vectorized row formatting; repr-precision floats, space-separated."""
    mat = np.column_stack([_np64(a).ravel() for a in arrays])
    np.savetxt(f, mat, fmt="%.17g", delimiter=" ")


def write_field_csv(path, header: str, *columns):
    """Space-separated columns with a header line."""
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write(header + "\n")
        _write_rows(f, columns)


def write_field2d(path, x, y, *fields, header=None):
    """2D field dump: `x y f1 f2 ...` per node, j-major inner loop over i
    (lid_driven_cavity.jl:205-210)."""
    _ensure_dir(path)
    x = _np64(x)
    y = _np64(y)
    fs = [_np64(f) for f in fields]
    # j-major: rows ordered (j, i) with i fastest, like the reference loops
    X = np.tile(x, len(y))
    Y = np.repeat(y, len(x))
    cols = [X, Y] + [ff.T.ravel() for ff in fs]
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        _write_rows(f, cols)


def write_metrics(path, metrics: dict):
    """Structured per-run JSON metrics record."""
    _ensure_dir(path)

    def conv(v):
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return v.item()
        return v

    with open(path, "w") as f:
        json.dump({k: conv(v) for k, v in metrics.items()}, f, indent=2)
        f.write("\n")
