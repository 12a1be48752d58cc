"""Error norms and residuals (counterpart of cfd_julia_tpu/ops/norms.py).

Reference parity: Common.jl:224-246 (`compute_l2norm`, `compute_l2norm_bnds`,
`compute_residual`).  The reference RMS norms sum over *interior* nodes
only (Julia ranges 2:nx / 2:nx,2:ny) and divide by the interior count.
"""
from __future__ import annotations

import torch


def l2norm_interior(r):
    """RMS over interior nodes of a node-centred field.

    1D: sqrt(sum(r[1:nx]^2) / (nx-1)) for r of shape (nx+1,)
    2D: sqrt(sum(r[1:nx,1:ny]^2) / ((nx-1)(ny-1))) for r of shape (nx+1, ny+1)
    Matches Common.jl:224-232.
    """
    if r.dim() == 1:
        nx = r.shape[0] - 1
        return torch.sqrt(torch.sum(r[1:nx] ** 2) / (nx - 1))
    if r.dim() == 2:
        nx, ny = r.shape[0] - 1, r.shape[1] - 1
        return torch.sqrt(torch.sum(r[1:nx, 1:ny] ** 2) / ((nx - 1) * (ny - 1)))
    raise ValueError(f"expected 1D or 2D field, got ndim={r.dim()}")


def l2norm_bounds(r):
    """RMS over all nodes including boundaries (Common.jl:234-237)."""
    return torch.sqrt(torch.mean(r ** 2))


def linf(r):
    """Maximum norm."""
    return torch.max(torch.abs(r))


def residual_poisson(f, u, dx: float, dy: float):
    """r = f - laplacian(u) on interior nodes, zero on the boundary ring.

    5-point Laplacian; matches Common.jl:239-246 (interior-only residual).
    f, u: (nx+1, ny+1) node-centred.
    """
    lap = (
        (u[2:, 1:-1] - 2 * u[1:-1, 1:-1] + u[:-2, 1:-1]) / dx**2
        + (u[1:-1, 2:] - 2 * u[1:-1, 1:-1] + u[1:-1, :-2]) / dy**2
    )
    r = torch.zeros_like(u)
    r[1:-1, 1:-1] = f[1:-1, 1:-1] - lap
    return r
