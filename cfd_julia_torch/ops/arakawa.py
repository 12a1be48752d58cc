"""Arakawa's energy/enstrophy-conserving Jacobian + viscous Laplacian —
the vorticity-streamfunction RHS core (counterpart of
cfd_julia_tpu/ops/arakawa.py; reference Common.jl:148-181).

Whole-array shifted expressions with periodic wrap; bounded domains use
the interior block, where the shifts never wrap.  This module is also the
plain twin of the CUDA kernel in csrc/arakawa_rhs.cu (see
ops/cuda_kernels.py).

Array convention: field[..., i, j], axis -2 = x, axis -1 = y; leading
axes are a batch (the members of an ensemble), each member periodic on
its own.
"""
from __future__ import annotations

import torch


def _sh(u, di: int, dj: int):
    """u_{i+di, j+dj} with periodic wrap over the last two axes."""
    return torch.roll(u, (-di, -dj), (-2, -1))


def members(re):
    """re as it divides a (..., nr, nc) field: a float or a 0-d tensor as
    it is, a tensor of the batch's shape (one Re a member) with two unit
    axes appended."""
    if isinstance(re, torch.Tensor) and re.dim() > 0:
        return re[..., None, None]
    return re


def jacobian(w, s, dx: float, dy: float):
    """Arakawa J(w, s) = w_x s_y - w_y s_x, second order, conserving.

    Returns the full-array periodic evaluation; slice [1:-1, 1:-1] for
    non-periodic interior use."""
    gg = 1.0 / (4.0 * dx * dy)
    wE, wW = _sh(w, 1, 0), _sh(w, -1, 0)
    wN, wS = _sh(w, 0, 1), _sh(w, 0, -1)
    sE, sW = _sh(s, 1, 0), _sh(s, -1, 0)
    sN, sS = _sh(s, 0, 1), _sh(s, 0, -1)
    wNE, wSW = _sh(w, 1, 1), _sh(w, -1, -1)
    wNW, wSE = _sh(w, -1, 1), _sh(w, 1, -1)
    sNE, sSW = _sh(s, 1, 1), _sh(s, -1, -1)
    sNW, sSE = _sh(s, -1, 1), _sh(s, 1, -1)

    j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW)
    j2 = (
        wE * (sNE - sSE) - wW * (sNW - sSW)
        - wN * (sNE - sNW) + wS * (sSE - sSW)
    )
    j3 = (
        wNE * (sN - sE) - wSW * (sW - sS)
        - wNW * (sN - sW) + wSE * (sE - sS)
    )
    return gg * (j1 + j2 + j3) / 3.0


def laplacian(w, dx: float, dy: float):
    """5-point periodic Laplacian (full array)."""
    return (
        (_sh(w, 1, 0) - 2 * w + _sh(w, -1, 0)) / dx**2
        + (_sh(w, 0, 1) - 2 * w + _sh(w, 0, -1)) / dy**2
    )


def vorticity_rhs(w, s, dx: float, dy: float, re):
    """r = -J(w, s) + (1/re) laplacian(w), periodic; slice the interior
    for bounded domains.  re: a float, a 0-d tensor, or one value a member
    of w's leading axes (`members`)."""
    return -jacobian(w, s, dx, dy) + laplacian(w, dx, dy) / members(re)
