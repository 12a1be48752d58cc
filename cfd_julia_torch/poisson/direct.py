"""Direct (transform-based) Dirichlet Poisson solve on node-centred grids
(counterpart of cfd_julia_tpu/poisson/direct.py; reference fft_d.jl:7-23).

The DST-I solve is four dense sine-matrix products, which on the GPU are
plain large GEMMs (torch.matmul).  PyTorch runs eagerly, so the sine
matrices and the eigenvalue denominator are built once by
`make_fst_matmul_interior` and reused by every solve, where JAX built them
once at trace time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sine_matrix(n: int, size: int, dtype, device=None):
    """(size, size) zero-extended DST-I matrix: S[r, c] = sin(pi r c / n)
    for r, c < n and 0 elsewhere.  The argument is reduced by sin's period
    before the float cast (see _sine_entries)."""
    ri = torch.arange(size, dtype=torch.int32, device=device)[:, None]
    ci = torch.arange(size, dtype=torch.int32, device=device)[None, :]
    s = _sine_entries(ri, ci, n, dtype)
    return torch.where((ri < n) & (ci < n), s,
                       torch.zeros((), dtype=dtype, device=device))


def _sine_entries(ri, ci, n: int, dtype):
    """sin(pi * (ri*ci mod 2n) / n) with the product period-reduced in
    int32 BEFORE the float cast, so an fp32 argument stays <= 2 pi and the
    entries are accurate to ~3e-7 instead of the ~3e-4 an unreduced fp32
    pi*r*c/n carries at n=1024.  ri*ci is exact in int32 while the largest
    index is below ~46k."""
    m = (ri * ci) % (2 * n)
    return torch.sin(math.pi * m.to(dtype) / n)


def make_fst_matmul_interior(nx: int, ny: int, dx: float, dy: float,
                             dtype, device=None):
    """Build the Dirichlet Poisson solve lap(u) = f on an (nx+1, ny+1) grid
    as four dense matmuls; returns solve(f) -> u.

    solve reads only f's interior (1..nx-1, 1..ny-1) and returns u with an
    exactly-zero boundary ring.  With S the unscaled interior sine matrix,
    u = S((S g S) / den) S * 4/(nx ny): S^2 = (n/2) I on the interior, and
    FFTW's RODFT00 pair scales by 2nx * 2ny."""
    def sine_interior(n):
        k = torch.arange(1, n, dtype=torch.int32, device=device)
        return _sine_entries(k[:, None], k[None, :], n, dtype)

    sx = sine_interior(nx)
    sy = sine_interior(ny)
    kx = torch.arange(1, nx, dtype=dtype, device=device)
    ky = torch.arange(1, ny, dtype=dtype, device=device)
    den = (2.0 / dx**2) * (torch.cos(math.pi * kx[:, None] / nx) - 1.0) + (
        2.0 / dy**2
    ) * (torch.cos(math.pi * ky[None, :] / ny) - 1.0)
    scale = 4.0 / (nx * ny)

    def solve(f):
        g = f[1:nx, 1:ny]
        coeff = torch.matmul(torch.matmul(sx, g), sy) / den
        u = torch.matmul(torch.matmul(sx, coeff), sy) * scale
        return F.pad(u, (1, 1, 1, 1))

    return solve


def solve_fst_matmul_interior(f, nx: int, ny: int, dx: float, dy: float):
    """One-off form of make_fst_matmul_interior (builds the matrices for
    this call); f: (nx+1, ny+1)."""
    return make_fst_matmul_interior(nx, ny, dx, dy, f.dtype, f.device)(f)
