"""Lid-driven cavity — 2D incompressible NS in vorticity-streamfunction
form (reference ch. 18, lid_driven_cavity.jl; counterpart of
cfd_julia_tpu/models/cavity.py).

Per SSP-RK3 stage (lid_driven_cavity.jl:72-110):
  1. r = -J(w, psi) + (1/Re) lap(w)   (Arakawa, interior nodes) — the
     CUDA kernel csrc/arakawa_rhs.cu on the GPU, its plain twin on the CPU
  2. stage-combine w on the interior
  3. vorticity wall BCs from the current psi (Hoffmann 1st-order or
     Jensen 2nd-order; the moving lid adds -2/dy or -3/dy on the top wall)
  4. psi = DST-I Poisson solve of lap(psi) = -w (poisson/direct.py): four
     dense sine-matrix products ("matmul"), or the fast sine transform
     through rfft ("fst", and "fst_half" at half the transform length)

This is the full-grid step of the JAX package with poisson="matmul", "fst"
or "fst_half" and rhs_impl="pallas".  Domain [0,1]^2; the lid moves in +x
at the top wall (j = ny).
"""
from __future__ import annotations

import dataclasses

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import arakawa, cuda_kernels
from cfd_julia_torch.poisson import direct
from cfd_julia_torch.stepping import loop


@dataclasses.dataclass(frozen=True)
class CavityConfig:
    nx: int = 64
    ny: int = 64
    dt: float = 1e-3
    t_final: float = 10.0
    re: float = 100.0
    bc_order: int = 2        # 1 = Hoffmann, 2 = Jensen (reference default)
    poisson: str = "auto"    # auto (= matmul on every device) | matmul
                             # (interior sine-matmul DST-I solve) | fst
                             # (odd-extension rfft DST-I) | fst_half
                             # (half-length rfft DST-I)
    rhs_impl: str = "auto"   # auto (kernel on a CUDA device, torch on the
                             # CPU) | kernel (csrc/arakawa_rhs.cu; CUDA
                             # only) | torch (ops.arakawa, any device)

    @property
    def dx(self) -> float:
        return 1.0 / self.nx

    @property
    def dy(self) -> float:
        return 1.0 / self.ny

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)


@dataclasses.dataclass
class CavityResult:
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor             # vorticity (nx+1, ny+1)
    s: torch.Tensor             # streamfunction
    rms_history: torch.Tensor   # ||psi^n - psi^{n-1}|| per step (nt,)


def assemble_with_wall_bc(w_interior, s, dx: float, dy: float,
                          order: int = 2):
    """Assemble the full (nx+1, ny+1) vorticity field from its interior
    block and the wall boundary conditions derived from the streamfunction
    (lid_driven_cavity.jl:24-51).  Top wall (j=ny) is the moving lid; the
    y-wall columns own the corners (the reference writes them last)."""
    if order == 1:
        row_lo = -2.0 * s[1, 1:-1] / dx**2            # x=0 wall
        row_hi = -2.0 * s[-2, 1:-1] / dx**2           # x=1 wall
        col_lo = -2.0 * s[:, 1] / dy**2               # y=0 wall
        col_hi = -2.0 * s[:, -2] / dy**2 - 2.0 / dy   # moving lid
    elif order == 2:
        row_lo = (-4.0 * s[1, 1:-1] + 0.5 * s[2, 1:-1]) / dx**2
        row_hi = (-4.0 * s[-2, 1:-1] + 0.5 * s[-3, 1:-1]) / dx**2
        col_lo = (-4.0 * s[:, 1] + 0.5 * s[:, 2]) / dy**2
        col_hi = (-4.0 * s[:, -2] + 0.5 * s[:, -3]) / dy**2 - 3.0 / dy
    else:
        raise ValueError("bc_order must be 1 or 2")
    mid = torch.cat([row_lo[None, :], w_interior, row_hi[None, :]], 0)
    return torch.cat([col_lo[:, None], mid, col_hi[:, None]], 1)


def make_step_fn(cfg: CavityConfig, dtype=None, device="cuda"):
    """Cavity step on state (w, s, rms) of (nx+1, ny+1) tensors of `dtype`
    on `device`; the Poisson solve's constants are built here, once."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    dx, dy, dt, re = cfg.dx, cfg.dy, cfg.dt, cfg.re
    rhs_impl = precision.resolve_rhs_impl(cfg.rhs_impl, device)
    if cfg.poisson not in ("auto", "matmul", "fst", "fst_half"):
        # a typo'd variant name must never silently run the default solver
        raise ValueError(f"unknown poisson solver {cfg.poisson!r} "
                         "(auto | matmul | fst | fst_half)")
    if cfg.bc_order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")

    if rhs_impl == "kernel":
        def rhs_interior(w, s):
            return cuda_kernels.arakawa_rhs_fused(w, s, dx, dy, re)[1:-1, 1:-1]
    else:
        def rhs_interior(w, s):
            return arakawa.vorticity_rhs(w, s, dx, dy, re)[1:-1, 1:-1]

    if cfg.poisson in ("fst", "fst_half"):
        solve = direct.make_fst(
            cfg.nx, cfg.ny, dx, dy, dtype, device,
            impl="half" if cfg.poisson == "fst_half" else "rfft")
    else:
        solve = direct.make_fst_matmul_interior(cfg.nx, cfg.ny, dx, dy,
                                                dtype, device)

    def stage_close(wt_interior, s_prev):
        """Assemble with wall BCs from the pre-stage psi, then fresh psi."""
        wt = assemble_with_wall_bc(wt_interior, s_prev, dx, dy, cfg.bc_order)
        return wt, solve(-wt)

    def step(state):
        w, s, _ = state
        sp = s

        r = rhs_interior(w, s)
        wt, s = stage_close(w[1:-1, 1:-1] + dt * r, s)

        r = rhs_interior(wt, s)
        wt, s = stage_close(
            0.75 * w[1:-1, 1:-1] + 0.25 * wt[1:-1, 1:-1] + 0.25 * dt * r, s
        )

        r = rhs_interior(wt, s)
        wn, s = stage_close(
            (w[1:-1, 1:-1] + 2.0 * wt[1:-1, 1:-1] + 2.0 * dt * r) / 3.0, s
        )

        rms = torch.sqrt(torch.mean((s - sp) ** 2))
        return (wn, s, rms)

    return step


def initial_state(cfg: CavityConfig, dtype=None, device="cuda"):
    """Fluid at rest: (w, s, rms) all zero."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    w = torch.zeros((cfg.nx + 1, cfg.ny + 1), dtype=dtype, device=device)
    return (w, torch.zeros_like(w), torch.zeros((), dtype=dtype,
                                                device=device))


def solve(cfg: CavityConfig, dtype=None, device="cuda") -> CavityResult:
    """Integrate nt steps from rest (lid_driven_cavity.jl:58-118).  The
    result's tensors, rms history included, stay on `device`."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    step = make_step_fn(cfg, dtype, device)
    (w, s, _), rms = loop.run_steps(step, initial_state(cfg, dtype, device),
                                    cfg.nt)
    x = torch.linspace(0.0, 1.0, cfg.nx + 1, dtype=dtype, device=device)
    y = torch.linspace(0.0, 1.0, cfg.ny + 1, dtype=dtype, device=device)
    return CavityResult(x=x, y=y, w=w, s=s, rms_history=rms)


def centerline_velocities(res: CavityResult, cfg: CavityConfig):
    """u(y) on the vertical centerline x=0.5 and v(x) on the horizontal
    centerline y=0.5 (u = d psi/dy, v = -d psi/dx, central differences) —
    the Ghia et al. (1982) benchmark quantities."""
    s = res.s
    i = cfg.nx // 2
    j = cfg.ny // 2
    u = s.new_zeros(cfg.ny + 1)
    u[1:-1] = (s[i, 2:] - s[i, :-2]) / (2 * cfg.dy)
    u[-1] = 1.0  # lid
    v = s.new_zeros(cfg.nx + 1)
    v[1:-1] = -(s[2:, j] - s[:-2, j]) / (2 * cfg.dx)
    return u, v
