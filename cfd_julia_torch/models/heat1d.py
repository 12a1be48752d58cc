"""1D heat equation u_t = alpha u_xx, four schemes (reference ch. 01-04;
counterpart of cfd_julia_tpu/models/heat1d.py).

The problem of all four reference scripts (e.g. ftcs.jl:9-27): x in
[-1, 1], u(+-1) = 0, alpha = 1/pi^2, u(x, 0) = -sin(pi x), exact
u(x, t) = -exp(-t) sin(pi x); nx = 80, dt = 0.0025, t_final = 1.

* ``ftcs``  explicit forward-time centred-space       (ftcs.jl:35-40)
* ``rk3``   SSP-RK3 with the central second difference (rk3.jl:14-58)
* ``cn``    Crank-Nicolson, a tridiagonal solve a step (cn.jl:8-26)
* ``icp``   implicit compact Pade, 4th order in space  (icp.jl:8-29)

The implicit schemes' constant tridiagonal rows are built once; a step is
one batched PCR solve (ops.tridiag; `tridiag_method="thomas"` is the
sequential cross-check).  The time loop is stepping/loop.py's, graphed on a
CUDA device.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import norms, tridiag
from cfd_julia_torch.stepping import loop, ssprk3


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    nx: int = 80
    x0: float = -1.0
    x1: float = 1.0
    dt: float = 0.0025
    t_final: float = 1.0
    alpha: float = 1.0 / math.pi**2
    scheme: str = "ftcs"  # ftcs | rk3 | cn | icp
    tridiag_method: str = "pcr"

    @property
    def dx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)


@dataclasses.dataclass
class HeatResult:
    x: torch.Tensor
    u: torch.Tensor
    u_exact: torch.Tensor
    l2_error: torch.Tensor
    linf_error: torch.Tensor
    history: torch.Tensor | None = None  # (nt+1, nx+1) when requested


def _zero_ends(inner):
    """The interior values with Dirichlet zeros at both ends."""
    return F.pad(inner, (1, 1))


def initial_condition(cfg: HeatConfig, dtype, device="cuda"):
    device = precision.resolve_device(device)
    x = torch.linspace(cfg.x0, cfg.x1, cfg.nx + 1, dtype=dtype,
                       device=device)
    return x, _zero_ends(-torch.sin(math.pi * x)[1:-1])


def exact_solution(x, t: float):
    return -math.exp(-t) * torch.sin(math.pi * x)


# ---------------------------------------------------------------- explicit

def ftcs_step(u, beta: float):
    """u[i] += beta (u[i+1] - 2u[i] + u[i-1]) on the interior."""
    return _zero_ends(u[1:-1] + beta * (u[2:] - 2 * u[1:-1] + u[:-2]))


def _central_rhs(u, alpha: float, dx: float):
    return _zero_ends(alpha * (u[2:] - 2 * u[1:-1] + u[:-2]) / dx**2)


def rk3_step(u, alpha: float, dx: float, dt: float):
    un = ssprk3.ssprk3_step(lambda v: _central_rhs(v, alpha, dx), u, dt)
    return _zero_ends(un[1:-1])


# ---------------------------------------------------------------- implicit

def _rows(n: int, off: float, dia: float, dtype, device):
    """Constant tridiagonal rows with identity boundary rows."""
    a = _zero_ends(torch.full((n - 2,), off, dtype=dtype, device=device))
    b = F.pad(torch.full((n - 2,), dia, dtype=dtype, device=device), (1, 1),
              value=1.0)
    return a, b, a.clone()


def cn_system(cfg: HeatConfig, dtype, device="cpu"):
    """Crank-Nicolson's constant diagonals (cn.jl:14-24): (a, b, c,
    rhs_fn)."""
    a1 = cfg.alpha * cfg.dt / (2 * cfg.dx**2)
    a, b, c = _rows(cfg.nx + 1, -a1, 1 + 2 * a1, dtype, device)

    def rhs(u):
        return _zero_ends(a1 * u[2:] + (1 - 2 * a1) * u[1:-1] + a1 * u[:-2])

    return a, b, c, rhs


def icp_system(cfg: HeatConfig, dtype, device="cpu"):
    """Implicit compact Pade, 4th order: the (1, 10, 1)/12-type mass stencil
    on both sides (icp.jl:14-24): (a, b, c, rhs_fn)."""
    dx2 = cfg.dx**2
    adt = cfg.alpha * cfg.dt
    off = 12.0 / dx2 - 2.0 / adt
    dia = -24.0 / dx2 - 20.0 / adt
    a, b, c = _rows(cfg.nx + 1, off, dia, dtype, device)

    def rhs(u):
        return _zero_ends(-2.0 / adt * (u[2:] + 10 * u[1:-1] + u[:-2])
                          - 12.0 / dx2 * (u[2:] - 2 * u[1:-1] + u[:-2]))

    return a, b, c, rhs


# ------------------------------------------------------------ entry points

def make_step_fn(cfg: HeatConfig, dtype=None, device="cuda"):
    """u -> u after one step of cfg.scheme, on `device`."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    if cfg.scheme == "ftcs":
        beta = cfg.alpha * cfg.dt / cfg.dx**2
        return lambda u: ftcs_step(u, beta)
    if cfg.scheme == "rk3":
        return lambda u: rk3_step(u, cfg.alpha, cfg.dx, cfg.dt)
    if cfg.scheme in ("cn", "icp"):
        if cfg.tridiag_method not in ("pcr", "thomas"):
            raise ValueError(f"unknown tridiagonal method "
                             f"{cfg.tridiag_method!r} (pcr | thomas)")
        build = cn_system if cfg.scheme == "cn" else icp_system
        a, b, c, rhs = build(cfg, dtype, device)

        def step(u):
            un = tridiag.solve(a, b, c, rhs(u), method=cfg.tridiag_method)
            return _zero_ends(un[1:-1])

        return step
    raise ValueError(f"unknown heat scheme {cfg.scheme!r}")


def solve(cfg: HeatConfig, dtype=None, device="cuda",
          keep_history: bool = False) -> HeatResult:
    """Integrate nt steps from the initial condition; errors against the
    exact solution.  keep_history=True also returns the (nt+1, nx+1) time
    history (the reference's `un` storage, ftcs.jl:21), on the device."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    x, u0 = initial_condition(cfg, dtype, device)
    step = make_step_fn(cfg, dtype, device)
    history = None
    if keep_history:
        u, hist = loop.run_steps_with_snapshots(step, u0, cfg.nt, 1)
        history = torch.cat([u0[None], hist], dim=0)
    else:
        u = loop.advance(step, u0, cfg.nt)
    ue = exact_solution(x, cfg.t_final)
    err = u - ue
    return HeatResult(x=x, u=u, u_exact=ue,
                      l2_error=norms.l2norm_interior(err),
                      linf_error=norms.linf(err), history=history)
