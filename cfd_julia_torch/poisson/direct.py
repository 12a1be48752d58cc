"""Direct (transform-based) Poisson solvers on node-centred grids
(counterpart of cfd_julia_tpu/poisson/direct.py).

Wraps ops.spectral with the reference's full-grid conventions:
* the periodic FFT solvers take/return (nx+1, ny+1) node grids, solving on
  the nx x ny unique nodes and wrapping the duplicated boundary
  (fft_p.jl:92-104, fft_s.jl);
* the FST solver takes the full grid, solves the (nx-1)x(ny-1) interior
  with homogeneous Dirichlet boundaries and zero-fills the boundary ring
  (fft_d.jl:70-76);
* the sine-matmul solver is the same DST-I solve as four dense
  sine-matrix products, which on the GPU are plain large GEMMs
  (torch.matmul).

PyTorch runs eagerly, so each `make_*` builds its eigenvalue denominator
(and the sine matrices or transform weights) once and returns the solve
that reuses them, where JAX built them once at trace time; `solve_*` are
the one-off forms.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cfd_julia_torch.ops import spectral


def make_fft(nx: int, ny: int, dx: float, dy: float, dtype, device=None,
             eigen: str = "fdm"):
    """Build the periodic Poisson solve on an (nx+1, ny+1) node grid with
    wrapped edges; returns solve(f) -> u of the same shape."""
    inner = spectral.make_fft_poisson_periodic(nx, ny, dx, dy, dtype, device,
                                               eigen)

    def solve(f):
        # circular pad: the duplicated last row and column repeat the first
        return F.pad(inner(f[:-1, :-1])[None], (0, 1, 0, 1),
                     mode="circular")[0]

    return solve


def solve_fft(f, dx: float, dy: float, eigen: str = "fdm"):
    """Periodic Poisson solve; f, result: (nx+1, ny+1) with wrapped edges."""
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    return make_fft(nx, ny, dx, dy, f.dtype, f.device, eigen)(f)


def make_fst(nx: int, ny: int, dx: float, dy: float, dtype, device=None,
             impl: str = "rfft"):
    """Build the homogeneous-Dirichlet Poisson solve via DST-I on the
    interior of an (nx+1, ny+1) grid (impl: rfft | half, ops.spectral.dst1);
    returns solve(f) -> u with an exactly-zero boundary ring."""
    inner = spectral.make_fst_poisson_dirichlet(nx - 1, ny - 1, dx, dy, dtype,
                                                device, impl)
    return lambda f: F.pad(inner(f[1:-1, 1:-1]), (1, 1, 1, 1))


def solve_fst(f, dx: float, dy: float, impl: str = "rfft"):
    """One-off form of make_fst; f: (nx+1, ny+1)."""
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    return make_fst(nx, ny, dx, dy, f.dtype, f.device, impl)(f)


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
