"""1D inviscid Burgers u_t + u u_x = 0 (reference ch. 05-08; counterpart of
cfd_julia_tpu/models/burgers1d.py).

Five solvers, all SSP-RK3 in time, u0 = sin(2 pi x) on [0, 1]:

* ``weno``        non-conservative upwind form, WENO-5; Dirichlet
                  (extrapolated ghosts) or periodic
                  (05_.../weno_dirichlet.jl, weno_periodic.jl)
* ``crweno``      the same with compact CRWENO-5 (tridiagonal solves);
                  Dirichlet or periodic (06_.../crweno_*.jl)
* ``central``     the 2nd-order central baseline, Dirichlet only
                  (05_.../weno_trial.jl)
* ``flux_split``  Lax-Friedrichs flux splitting on periodic cell centres,
                  f+- = (f +- ps u)/2, ps the 5-point max |u|
                  (07_.../burgers_flux_splitting.jl)
* ``rusanov``     WENO states and the Rusanov flux on periodic cell centres
                  (08_.../burgers_riemann.jl)

No TPU kernel carries these: every step is plain PyTorch, run through
stepping/loop.py's CUDA graphs on a GPU.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import crweno, weno
from cfd_julia_torch.ops.stencil import shift
from cfd_julia_torch.stepping import loop, ssprk3


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    nx: int = 200
    solver: str = "weno"        # weno | crweno | central | flux_split | rusanov
    bc: str = "periodic"        # dirichlet | periodic (node solvers only)
    dt: float = 1e-4
    t_final: float = 0.25
    ns: int = 10                # number of snapshots
    tridiag_method: str = "pcr"

    @property
    def dx(self) -> float:
        return 1.0 / self.nx

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)


@dataclasses.dataclass
class BurgersResult:
    x: torch.Tensor
    u: torch.Tensor          # final field
    snapshots: torch.Tensor  # (ns+1, n) including the initial condition


# ------------------------------------------------------- non-conservative

def _rhs_upwind_dirichlet(u, dx: float, recon_l, recon_r):
    """r_i = -u_i times the one-sided derivative, interior nodes only
    (weno_dirichlet.jl:62-70); u: (N+1,) nodes."""
    uL = recon_l(u)   # (N,) at x_{j+1/2} centred u_j
    uR = recon_r(u)   # (N,) at x_{j+1/2} centred u_{j+1}
    ui = u[1:-1]
    dpos = (uL[1:] - uL[:-1]) / dx
    dneg = (uR[1:] - uR[:-1]) / dx
    return F.pad(-ui * torch.where(ui >= 0.0, dpos, dneg), (1, 1))


def _rhs_upwind_periodic(u, dx: float, recon_l, recon_r):
    """The periodic upwind form (weno_periodic.jl:58-68); u: (n,) unique
    nodes, uL[j] at x_{j+1/2} centred u_j, uR[j] at x_{j-1/2} centred u_j."""
    uL = recon_l(u)
    uR = recon_r(u)
    dpos = (uL - shift(uL, -1)) / dx          # uL_j - uL_{j-1}
    dneg = (shift(uR, 1) - uR) / dx           # uR_{j+1} - uR_j
    return -u * torch.where(u >= 0.0, dpos, dneg)


def _rhs_central(u, dx: float):
    """The central-difference baseline on Dirichlet nodes
    (weno_trial.jl:62-67)."""
    return F.pad(-u[1:-1] * (u[2:] - u[:-2]) / (2.0 * dx), (1, 1))


# ----------------------------------------------------------- conservative

def _rhs_flux_split(u, dx: float):
    """Lax-Friedrichs flux splitting on periodic cell centres
    (burgers_flux_splitting.jl:63-103): F+ at x_{i+1/2} by upwind WENO on
    f+ (centred u_i), F- by downwind WENO on f- (centred u_{i+1})."""
    f = 0.5 * u * u
    ps = torch.maximum(
        torch.maximum(torch.abs(shift(u, -2)), torch.abs(shift(u, -1))),
        torch.maximum(
            torch.abs(u),
            torch.maximum(torch.abs(shift(u, 1)), torch.abs(shift(u, 2)))))
    fP = 0.5 * (f + ps * u)
    fN = 0.5 * (f - ps * u)
    fL = weno.reconstruct_left(fP, "periodic")              # F+_{i+1/2}
    fR = shift(weno.reconstruct_right(fN, "periodic"), 1)   # F-_{i+1/2}
    return -(fL - shift(fL, -1)) / dx - (fR - shift(fR, -1)) / dx


def _rhs_rusanov(u, dx: float):
    """WENO states and the Rusanov flux on periodic cell centres
    (burgers_riemann.jl:66-97)."""
    uL = weno.reconstruct_left(u, "periodic")              # x_{i+1/2}-
    uR = shift(weno.reconstruct_right(u, "periodic"), 1)   # x_{i+1/2}+
    fL = 0.5 * uL * uL
    fR = 0.5 * uR * uR
    ps = torch.maximum(torch.abs(u), torch.abs(shift(u, 1)))
    flux = 0.5 * (fL + fR) - 0.5 * ps * (uR - uL)          # F_{i+1/2}
    return -(flux - shift(flux, -1)) / dx


# ------------------------------------------------------------ entry points

def make_rhs(cfg: BurgersConfig):
    """u -> du/dt of cfg.solver under cfg.bc."""
    dx = cfg.dx
    m = cfg.tridiag_method
    if cfg.bc not in ("dirichlet", "periodic"):
        raise ValueError(f"unknown bc {cfg.bc!r} (dirichlet | periodic)")
    if m not in ("pcr", "thomas"):
        raise ValueError(f"unknown tridiagonal method {m!r} (pcr | thomas)")
    if cfg.solver == "central":
        if cfg.bc != "dirichlet":
            raise ValueError("solver='central' supports bc='dirichlet' "
                             "only (05_.../weno_trial.jl)")
        return lambda u: _rhs_central(u, dx)
    if cfg.solver == "flux_split":
        return lambda u: _rhs_flux_split(u, dx)
    if cfg.solver == "rusanov":
        return lambda u: _rhs_rusanov(u, dx)
    if cfg.solver == "weno":
        if cfg.bc == "dirichlet":
            rl = lambda u: weno.reconstruct_left(u, "extrapolate")
            rr = lambda u: weno.reconstruct_right(u, "extrapolate")
            return lambda u: _rhs_upwind_dirichlet(u, dx, rl, rr)
        rl = lambda u: weno.reconstruct_left(u, "periodic")
        rr = lambda u: weno.reconstruct_right(u, "periodic")
        return lambda u: _rhs_upwind_periodic(u, dx, rl, rr)
    if cfg.solver == "crweno":
        if cfg.bc == "dirichlet":
            rl = lambda u: crweno.reconstruct_dirichlet_L(u, method=m)
            rr = lambda u: crweno.reconstruct_dirichlet_R(u, method=m)
            return lambda u: _rhs_upwind_dirichlet(u, dx, rl, rr)
        rl = lambda u: crweno.reconstruct_periodic(u, "L", method=m)
        rr = lambda u: crweno.reconstruct_periodic(u, "R", method=m)
        return lambda u: _rhs_upwind_periodic(u, dx, rl, rr)
    raise ValueError(f"unknown Burgers solver {cfg.solver!r}")


def grid_coords(cfg: BurgersConfig, dtype=None, device="cuda"):
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    if cfg.solver in ("flux_split", "rusanov"):
        # cell centres x_i = (i + 1/2) dx (burgers_riemann.jl:28)
        return (torch.arange(cfg.nx, dtype=dtype, device=device) + 0.5) * cfg.dx
    if cfg.bc == "periodic" and cfg.solver in ("weno", "crweno"):
        return torch.arange(cfg.nx, dtype=dtype, device=device) * cfg.dx
    return torch.linspace(0.0, 1.0, cfg.nx + 1, dtype=dtype, device=device)


def initial_condition(cfg: BurgersConfig, dtype=None, device="cuda"):
    """(x, u0): sin(2 pi x), zero at both ends of a Dirichlet node line."""
    x = grid_coords(cfg, dtype, device)
    u0 = torch.sin(2 * math.pi * x)
    if cfg.solver in ("weno", "crweno", "central") and cfg.bc == "dirichlet":
        u0 = F.pad(u0[1:-1], (1, 1))
    return x, u0


def make_step_fn(cfg: BurgersConfig):
    """u -> u after one SSP-RK3 step."""
    rhs = make_rhs(cfg)
    return lambda u: ssprk3.ssprk3_step(rhs, u, cfg.dt)


def solve(cfg: BurgersConfig, dtype=None, device="cuda") -> BurgersResult:
    """Integrate nt steps on `device`, with ns snapshots besides u0."""
    device = precision.resolve_device(device)
    x, u0 = initial_condition(cfg, dtype, device)
    final, snaps = loop.run_steps_with_snapshots(
        make_step_fn(cfg), u0, cfg.nt, max(1, cfg.nt // cfg.ns))
    return BurgersResult(x=x, u=final,
                         snapshots=torch.cat([u0[None], snaps], dim=0))
