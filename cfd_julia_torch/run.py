"""Preset runner: solve + write the reference-compatible output files
(counterpart of cfd_julia_tpu/run.py, same files and formats).

`run_preset(name, outdir, device=...)` is what
`python -m cfd_julia_torch run <preset>` calls.
"""
from __future__ import annotations

import os
import time

import torch

from cfd_julia_torch import presets as presets_lib
from cfd_julia_torch.core import precision
from cfd_julia_torch.models import cavity as cavity_model
from cfd_julia_torch.models import euler1d, poisson2d, vortex
from cfd_julia_torch.poisson import iterative
from cfd_julia_torch.utils import io


def run_preset(name: str, outdir: str = ".", dtype=None, device="cuda",
               **overrides):
    """Run a named preset on `device`; writes its output files and
    metrics.json into outdir and returns the metrics dict."""
    preset = presets_lib.with_overrides(presets_lib.get(name), **overrides)
    device = precision.resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    metrics = _RUNNERS[preset.family](preset, outdir, dtype, device)
    metrics["wall_time_s"] = time.perf_counter() - t0
    metrics["preset"] = name
    metrics["reference"] = preset.reference
    metrics["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    io.write_metrics(os.path.join(outdir, "metrics.json"), metrics)
    return metrics


def _run_euler(preset, outdir, dtype, device):
    cfg = preset.cfg
    res = euler1d.solve(cfg, dtype, device)
    rho_f, _, p_f, _ = euler1d.primitives_from_result(res, cfg.gamma)
    mins = torch.stack([rho_f.min(), p_f.min()])
    # the run's one host transfer of the snapshots
    snaps = res.snapshots.cpu().numpy()
    x = res.x.cpu().numpy()
    # solution_{d,v,e}.txt: density / velocity / total specific energy
    # histories of snapshots 1..ns (euler_roe.jl:187-205)
    rho = snaps[:, 0]
    for tag, arr in (("d", rho), ("v", snaps[:, 1] / rho),
                     ("e", snaps[:, 2] / rho)):
        io.write_solution_history(
            os.path.join(outdir, f"solution_{tag}.txt"), x, arr[1:])
    rho_min, p_min = mins.cpu().tolist()
    return {"rho_min": rho_min, "p_min": p_min}


def _run_poisson(preset, outdir, dtype, device):
    cfg = preset.cfg
    res = poisson2d.solve(cfg, dtype, device)
    m = {"l2_error": float(res.l2_error),
         "linf_error": float(res.linf_error)}
    if res.iterations is not None:
        # the reference's 'Maximum Norm' is max |RESIDUAL|
        # (gauss_seidel.jl:51 maximum(abs.(r))), not the solution error
        mask = iterative.interior_mask(cfg.nx, cfg.ny, res.u.dtype, device)
        r = iterative.residual_full(res.f, res.u, cfg.dx, cfg.dy, mask)
        io.write_residual_report(os.path.join(outdir, "output.txt"), res.rms,
                                 r.abs().max(), res.iterations)
        io.write_residual_history(
            os.path.join(outdir, f"{cfg.solver}_residual.txt"), res.history)
        m["iterations"] = res.iterations
        m["rms_final"] = float(res.rms)
    else:   # a direct solve: no iterations, history or rms
        io.write_error_report(os.path.join(outdir, f"output_{cfg.nx}.txt"),
                              res.l2_error, res.linf_error)
    io.write_field2d(os.path.join(outdir, "field_final.txt"), res.x, res.y,
                     res.f, res.u, res.u_exact)
    return m


def _run_cavity(preset, outdir, dtype, device):
    cfg = preset.cfg
    res = cavity_model.solve(cfg, dtype, device)
    rms = res.rms_history.cpu().numpy()   # the run's one host transfer
    with open(os.path.join(outdir, "res_plot.txt"), "w") as f:
        for n, v in enumerate(rms, start=1):
            f.write(f"{n} {float(v)!r}\n")
    io.write_field2d(os.path.join(outdir, "field_final.txt"),
                     res.x, res.y, res.w, res.s)
    u, v = cavity_model.centerline_velocities(res, cfg)
    if cfg.nx == cfg.ny:
        io.write_field_csv(os.path.join(outdir, "centerlines.txt"),
                           "y u_centerline x v_centerline",
                           res.y, u, res.x, v)
    else:  # rectangular grid: centerlines have different lengths
        io.write_field_csv(os.path.join(outdir, "centerline_u.txt"),
                           "y u_centerline", res.y, u)
        io.write_field_csv(os.path.join(outdir, "centerline_v.txt"),
                           "x v_centerline", res.x, v)
    return {"steady_rms": float(rms[-1]),
            "psi_min": float(res.s.min())}


def _run_vortex(preset, outdir, dtype, device):
    cfg = preset.cfg
    res = vortex.solve(cfg, dtype, device)
    io.write_vortex_snapshots(outdir, res.x, res.y, res.snapshots)
    m = {"wmax_final": float(res.w.abs().max())}
    if cfg.ic == "tgv":
        l2, linf = vortex.tgv_error(cfg, res)
        io.write_error_report(os.path.join(outdir, "output.txt"), l2, linf)
        m["l2_error"] = float(l2)
        m["linf_error"] = float(linf)
    return m


_RUNNERS = {
    "euler": _run_euler,
    "cavity": _run_cavity,
    "poisson": _run_poisson,
    "vortex": _run_vortex,
}
