"""Shift / stencil primitives shared by the finite-difference solvers
(counterpart of cfd_julia_tpu/ops/stencil.py).

`shift(u, k, axis)` is u_{i+k} with periodic wrap (torch.roll); the
Laplacians return interior-sized tensors for Dirichlet-style updates.
"""
from __future__ import annotations

import torch


def shift(u, k: int, axis: int = -1):
    """u_{i+k} along `axis`, periodic wrap; k > 0 looks forward (+x)."""
    return torch.roll(u, -k, dims=axis)


def laplacian_1d(u, dx: float):
    """(u[i+1] - 2u[i] + u[i-1]) / dx^2 on interior nodes: (n,) -> (n-2,)."""
    return (u[2:] - 2 * u[1:-1] + u[:-2]) / dx**2


def laplacian_2d(u, dx: float, dy: float):
    """5-point Laplacian on the interior nodes of a (nx+1, ny+1) field ->
    (nx-1, ny-1)."""
    return (
        (u[2:, 1:-1] - 2 * u[1:-1, 1:-1] + u[:-2, 1:-1]) / dx**2
        + (u[1:-1, 2:] - 2 * u[1:-1, 1:-1] + u[1:-1, :-2]) / dy**2
    )


def laplacian_periodic(u, dx: float, dy: float):
    """5-point Laplacian with periodic wrap, same shape as u (nx, ny)."""
    return (
        (shift(u, 1, 0) - 2 * u + shift(u, -1, 0)) / dx**2
        + (shift(u, 1, 1) - 2 * u + shift(u, -1, 1)) / dy**2
    )


def central_diff_1d_periodic(u, dx: float):
    """(u_{i+1} - u_{i-1}) / (2 dx), periodic."""
    return (shift(u, 1) - shift(u, -1)) / (2 * dx)
