"""Structured-grid containers (counterpart of cfd_julia_tpu/core/grid.py).

The reference hardcodes `nx, dx, x = dx*(0:nx)` in every script (e.g.
01_Heat_Equation_FTCS/ftcs.jl:12-21); here grids are small frozen
dataclasses.  Node-centred grids carry nx+1 points x_0..x_nx including both
boundaries; cell-centred grids (the flux-splitting Burgers solver) carry nx
midpoints.  Coordinates are built on `device` (torch's default when None)
in `dtype` (the default dtype when None).
"""
from __future__ import annotations

import dataclasses

import torch

from cfd_julia_torch.core import precision


def _linspace(a: float, b: float, n: int, dtype, device):
    return torch.linspace(a, b, n, dtype=dtype or precision.default_dtype(),
                          device=device)


@dataclasses.dataclass(frozen=True)
class Grid1D:
    """1D uniform grid on [x0, x1] with nx cells (nx+1 nodes)."""

    nx: int
    x0: float = 0.0
    x1: float = 1.0

    @property
    def dx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    def nodes(self, dtype=None, device=None):
        """nx+1 node coordinates, including both boundaries."""
        return _linspace(self.x0, self.x1, self.nx + 1, dtype, device)

    def centers(self, dtype=None, device=None):
        """nx cell-centre coordinates x0 + (i-1/2)dx, i=1..nx."""
        dx = self.dx
        return self.x0 + dx / 2 + dx * torch.arange(
            self.nx, dtype=dtype or precision.default_dtype(), device=device)


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """2D uniform grid on [x0,x1]x[y0,y1] with nx*ny cells ((nx+1)*(ny+1)
    nodes)."""

    nx: int
    ny: int
    x0: float = 0.0
    x1: float = 1.0
    y0: float = 0.0
    y1: float = 1.0

    @property
    def dx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    @property
    def dy(self) -> float:
        return (self.y1 - self.y0) / self.ny

    def nodes(self, dtype=None, device=None):
        """(x, y) 1D node coordinate tensors (nx+1 and ny+1 points)."""
        return (_linspace(self.x0, self.x1, self.nx + 1, dtype, device),
                _linspace(self.y0, self.y1, self.ny + 1, dtype, device))

    def mesh(self, dtype=None, device=None):
        """(X, Y) meshgrid over the nodes, 'ij' indexing (rows = x)."""
        x, y = self.nodes(dtype, device)
        return torch.meshgrid(x, y, indexing="ij")

    def periodic_nodes(self, dtype=None, device=None):
        """First nx / ny nodes only (periodic wrap: x_nx == x_0)."""
        x, y = self.nodes(dtype, device)
        return x[: self.nx], y[: self.ny]

    def coarsen(self) -> "Grid2D":
        """Next-coarser multigrid level (half the cells per dimension)."""
        if self.nx % 2 or self.ny % 2:
            raise ValueError(f"grid {(self.nx, self.ny)} is not coarsenable")
        return dataclasses.replace(self, nx=self.nx // 2, ny=self.ny // 2)
