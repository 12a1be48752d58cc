"""1D Euler equations — Sod shock tube with Roe / HLLC / Rusanov fluxes
(reference ch. 09-11; counterpart of cfd_julia_tpu/models/euler1d.py).

Per SSP-RK3 stage (euler_roe.jl:86-102, identical in ch. 10/11): WENO-5
mirror-boundary reconstruction of the conservative state to both sides of
each interface -> Euler fluxes of the reconstructed states -> pointwise
Riemann flux -> conservative flux divergence.  On a CUDA device that whole
RHS is one launch of the kernel csrc/euler_rhs.cu; on the CPU it is the
plain twin (ops/weno.py + ops/riemann.py).

Layout: q is component-major (3, nx).  Reference configs: Roe nx=256,
dt=1e-4; HLLC/Rusanov nx=8192, dt=5e-5; t_final=0.2, gamma=1.4, Sod states
(1,0,1) | (0.125,0,0.1), diaphragm x=0.5, cell centres x_i = (i+1/2)dx on
[0,1] (euler_roe.jl:27-45).
"""
from __future__ import annotations

import dataclasses

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import cuda_kernels, riemann
from cfd_julia_torch.stepping import loop, ssprk3


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    nx: int = 256
    solver: str = "roe"          # roe | hllc | rusanov
    rhs_impl: str = "auto"       # auto (kernel on a CUDA device, torch on
                                 # the CPU) | kernel (csrc/euler_rhs.cu;
                                 # CUDA only) | torch (ops.weno +
                                 # ops.riemann, any device)
    dt: float = 1e-4
    t_final: float = 0.2
    ns: int = 20
    gamma: float = 1.4
    rusanov_wavespeed: str = "roe"   # roe | spectral (wavespeed2)
    # Sod states
    rho_l: float = 1.0
    u_l: float = 0.0
    p_l: float = 1.0
    rho_r: float = 0.125
    u_r: float = 0.0
    p_r: float = 0.1
    x_diaphragm: float = 0.5

    @property
    def dx(self) -> float:
        return 1.0 / self.nx

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)


@dataclasses.dataclass
class EulerResult:
    x: torch.Tensor
    q: torch.Tensor          # (3, nx) final conservative state
    snapshots: torch.Tensor  # (ns+1, 3, nx), the initial state first


def sod_initial_state(cfg: EulerConfig, dtype=None, device="cuda"):
    """(x, q0): cell centres and the Sod state of `dtype` on `device`."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    x = (torch.arange(cfg.nx, dtype=dtype, device=device) + 0.5) * cfg.dx
    right = x > cfg.x_diaphragm
    one = torch.ones((), dtype=dtype, device=device)
    rho = torch.where(right, cfg.rho_r * one, cfg.rho_l * one)
    u = torch.where(right, cfg.u_r * one, cfg.u_l * one)
    p = torch.where(right, cfg.p_r * one, cfg.p_l * one)
    e = p / (rho * (cfg.gamma - 1.0)) + 0.5 * u**2
    q = torch.stack([rho, rho * u, rho * e])
    return x, q


def make_rhs(cfg: EulerConfig, device="cuda"):
    """q (3, nx) -> dq/dt on `device`: the CUDA kernel or its plain twin."""
    device = precision.resolve_device(device)
    impl = precision.resolve_rhs_impl(cfg.rhs_impl, device)
    cuda_kernels.check_euler_variant(cfg.solver, cfg.rusanov_wavespeed)
    fn = (cuda_kernels.euler_rhs_fused if impl == "kernel"
          else cuda_kernels.euler_rhs_fused_plain)
    gamma, dx = cfg.gamma, cfg.dx
    return lambda q: fn(q, gamma, dx, cfg.solver, cfg.rusanov_wavespeed)


def solve(cfg: EulerConfig, dtype=None, device="cuda") -> EulerResult:
    """Integrate nt SSP-RK3 steps from the Sod state, snapshots after every
    max(1, nt // ns) steps; every tensor of the result stays on `device`."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    x, q0 = sod_initial_state(cfg, dtype, device)
    rhs = make_rhs(cfg, device)
    final, snaps = loop.run_steps_with_snapshots(
        lambda q: ssprk3.ssprk3_step(rhs, q, cfg.dt), q0, cfg.nt,
        max(1, cfg.nt // cfg.ns))
    return EulerResult(x=x, q=final,
                       snapshots=torch.cat([q0[None], snaps], dim=0))


def primitives_from_result(res: EulerResult, gamma: float = 1.4):
    """(rho, u, p, E_total_specific) — the reference output columns
    (euler_roe.jl:187-205).  E = q3/rho is the TOTAL specific energy
    (internal + kinetic), the reference's plotted column."""
    rho, u, e, p, _ = riemann.primitives(res.q, gamma)
    return rho, u, p, e
