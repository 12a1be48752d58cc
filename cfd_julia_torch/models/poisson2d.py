"""2D Poisson problem definitions + unified solver front-end (reference
ch. 12-17; counterpart of cfd_julia_tpu/models/poisson2d.py).

Manufactured problems (exact solutions for validation):
* ``sine32``  ue = sin(2 pi x) sin(2 pi y) + (1/256) sin(32 pi x) sin(32 pi y)
              (km=16 in fft_p.jl:67-82; also the FST chapter fft_d.jl:46-63).
* ``poly``    ue = (x^2-1)(y^2-1), f = -2(2-x^2-y^2): the ipr=1 problem of
              the iterative chapters (gauss_seidel.jl:96-111), inhomogeneous
              Dirichlet boundaries taken from ue.
* ``sine16``  ue = sin(2 pi x) sin(2 pi y) + (1/256) sin(16 pi x) sin(16 pi y)
              (ipr=2, gauss_seidel.jl:97-109).

Solvers ported: jacobi (= reference ch. 15 "gauss_seidel"), redblack (true
parallel GS), cg, multigrid (N-level V-cycle) and mgcg.  fft, fft_spectral
and fst need the FFT/DST solves, which are not ported yet (ROADMAP A.2).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import norms
from cfd_julia_torch.poisson import iterative, multigrid


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    nx: int = 128
    ny: int = 128
    solver: str = "fft"      # fft | fft_spectral | fst (not ported) |
                             # jacobi | redblack | cg | multigrid | mgcg
    problem: str = "sine32"  # sine32 | poly | sine16
    tol: float = 1e-9
    max_iter: int = 100_000
    freq: int = 100
    mg: multigrid.MGConfig = multigrid.MGConfig()

    @property
    def dx(self) -> float:
        return 1.0 / self.nx

    @property
    def dy(self) -> float:
        return 1.0 / self.ny


@dataclasses.dataclass
class PoissonResult:
    x: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    u_exact: torch.Tensor
    f: torch.Tensor
    l2_error: torch.Tensor
    linf_error: torch.Tensor
    iterations: int | None = None
    history: torch.Tensor | None = None
    rms: torch.Tensor | None = None
    rms0: torch.Tensor | None = None


def build_problem(cfg: PoissonConfig, dtype, device="cpu"):
    """(x, y, X, Y, ue, f) on the (nx+1, ny+1) node grid."""
    x = torch.linspace(0.0, 1.0, cfg.nx + 1, dtype=dtype, device=device)
    y = torch.linspace(0.0, 1.0, cfg.ny + 1, dtype=dtype, device=device)
    X, Y = torch.meshgrid(x, y, indexing="ij")
    pi = math.pi
    if cfg.problem == "sine32":
        km = 16.0
        c1 = (1.0 / km) ** 2
        c2 = -8.0 * pi**2
        ue = torch.sin(2 * pi * X) * torch.sin(2 * pi * Y) + c1 * torch.sin(
            km * 2 * pi * X
        ) * torch.sin(km * 2 * pi * Y)
        f = c2 * torch.sin(2 * pi * X) * torch.sin(2 * pi * Y) + c2 * torch.sin(
            km * 2 * pi * X
        ) * torch.sin(km * 2 * pi * Y)
    elif cfg.problem == "poly":
        ue = (X**2 - 1.0) * (Y**2 - 1.0)
        f = -2.0 * (2.0 - X**2 - Y**2)
    elif cfg.problem == "sine16":
        c1 = (1.0 / 16.0) ** 2
        c2 = -2.0 * pi**2
        ue = torch.sin(2 * pi * X) * torch.sin(2 * pi * Y) + c1 * torch.sin(
            16 * pi * X
        ) * torch.sin(16 * pi * Y)
        f = 4 * c2 * torch.sin(2 * pi * X) * torch.sin(2 * pi * Y) + c2 * torch.sin(
            16 * pi * X
        ) * torch.sin(16 * pi * Y)
    else:
        raise ValueError(f"unknown problem {cfg.problem!r}")
    return x, y, X, Y, ue, f


def solve(cfg: PoissonConfig, dtype=None, device="cuda") -> PoissonResult:
    """Build the problem on `device` and solve it with cfg.solver; the
    result's tensors stay on `device`."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    x, y, X, Y, ue, f = build_problem(cfg, dtype, device)

    if cfg.solver in ("fft", "fft_spectral", "fst"):
        raise NotImplementedError(
            f"solver {cfg.solver!r} needs the FFT/DST Poisson solves, which "
            "are not ported yet (ROADMAP A.2)")
    u0 = _dirichlet_init(ue)
    if cfg.solver in ("jacobi", "redblack"):
        it_res = iterative.relax_solve(
            f, u0, cfg.dx, cfg.dy, tol=cfg.tol, max_iter=cfg.max_iter,
            freq=cfg.freq, method=cfg.solver)
    elif cfg.solver == "cg":
        it_res = iterative.cg_solve(
            f, u0, cfg.dx, cfg.dy, tol=cfg.tol, max_iter=cfg.max_iter,
            freq=cfg.freq)
    elif cfg.solver == "multigrid":
        it_res = multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=cfg.mg)
    elif cfg.solver == "mgcg":
        # beyond the reference: V-cycle-preconditioned flexible CG
        it_res = iterative.mgcg_solve(
            f, u0, cfg.dx, cfg.dy, tol=cfg.tol, max_iter=cfg.max_iter,
            mg_cfg=cfg.mg)
    else:
        raise ValueError(f"unknown solver {cfg.solver!r}")

    err = it_res.u - ue
    return PoissonResult(
        x=x, y=y, u=it_res.u, u_exact=ue, f=f,
        l2_error=norms.l2norm_interior(err), linf_error=norms.linf(err),
        iterations=it_res.iterations, history=it_res.history,
        rms=it_res.rms, rms0=it_res.rms0)


def _dirichlet_init(ue):
    """Zero interior, exact boundary values (gauss_seidel.jl:113-119)."""
    u0 = torch.zeros_like(ue)
    u0[0, :] = ue[0, :]
    u0[-1, :] = ue[-1, :]
    u0[:, 0] = ue[:, 0]
    u0[:, -1] = ue[:, -1]
    return u0
