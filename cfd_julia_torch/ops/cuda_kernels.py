"""Hand-written CUDA kernels for the hot stencil paths, with their plain
PyTorch twins (counterpart of cfd_julia_tpu/ops/pallas_kernels.py).

Each wrapper takes the plain twin for tensors on the CPU; for CUDA tensors
it launches its kernel (csrc/, built by ops/_cuda_build.py) on the current
stream or raises — it never falls back.  `LAUNCHES` counts kernel launches
per wrapper, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from cfd_julia_torch.ops import _cuda_build, arakawa

LAUNCHES = {"arakawa_rhs": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def arakawa_rhs_fused_plain(w, s, dx: float, dy: float, re: float):
    """Plain twin of arakawa_rhs_fused: ops.arakawa.vorticity_rhs."""
    return arakawa.vorticity_rhs(w, s, dx, dy, re)


def arakawa_rhs_fused(w, s, dx: float, dy: float, re: float):
    """Periodic vorticity RHS -J(w,s) + lap(w)/re over the whole (n_rows,
    n_cols) array, in one kernel pass (csrc/arakawa_rhs.cu); matches
    ops.arakawa.vorticity_rhs.  w, s: contiguous fp32 or fp64 tensors of
    one shape on one device, n_rows >= 3."""
    if w.dtype not in (torch.float32, torch.float64) or s.dtype != w.dtype:
        raise TypeError(
            f"arakawa_rhs_fused takes two fp32 or two fp64 tensors, got "
            f"{w.dtype} and {s.dtype}")
    if w.dim() != 2 or s.shape != w.shape:
        raise ValueError(
            f"arakawa_rhs_fused takes two 2-D tensors of one shape, got "
            f"{tuple(w.shape)} and {tuple(s.shape)}")
    if w.device != s.device:
        raise ValueError(
            f"w and s lie on different devices: {w.device} and {s.device}")
    n_rows, n_cols = w.shape
    if n_rows < 3:
        raise ValueError(f"arakawa_rhs_fused needs >= 3 rows, got {n_rows}")
    if w.device.type == "cpu":
        return arakawa_rhs_fused_plain(w, s, dx, dy, re)
    if w.device.type != "cuda":
        raise ValueError(f"arakawa_rhs_fused runs on cpu or cuda, not "
                         f"{w.device}")
    if not (w.is_contiguous() and s.is_contiguous()):
        raise ValueError("arakawa_rhs_fused takes contiguous tensors")
    if w.numel() >= 2**31:
        raise ValueError(f"{w.numel()} points exceed the kernel's int index")

    lib = _cuda_build.load_library()
    fn = lib.arakawa_rhs_f32 if w.dtype == torch.float32 else lib.arakawa_rhs_f64
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(w.data_ptr(), s.data_ptr(), out.data_ptr(), n_rows, n_cols,
                 float(dx), float(dy), float(re), stream)
    if err != 0:
        msg = lib.cfd_cuda_error_string(err).decode()
        raise RuntimeError(f"arakawa_rhs launch failed: CUDA error {err} "
                           f"({msg}) at shape {(n_rows, n_cols)}")
    LAUNCHES["arakawa_rhs"] += 1
    return out
