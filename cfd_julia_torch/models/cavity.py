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
or "fst_half" and rhs_impl="pallas".  poisson="fused" is the packed,
interior-padded step of models/cavity_fused.py, which `solve` routes (pack,
run, decode).  Domain [0,1]^2; the lid moves in +x at the top wall (j = ny).

The precision tiers matmul_bf16x3 / matmul_bf16x1 and fused_bf16x3 /
fused_bf16x1 are the JAX package's TPU configurations: the sine-matrix
products split fp32 operands into bf16 parts (3 passes, XLA's bf16_3x; or
one bf16 pass) with fp32 accumulation, through csrc/tier_gemm.cu on the
GPU and its plain twin on the CPU.  So a tier computes the TPU's arithmetic
on every device (JAX's CPU backend ignores the precision and runs fp32).
A tier takes fp32 states only and raises for any other dtype.

Every formulation is differentiable with torch.autograd through the eager
loop, in a tensor Re (the `re` of make_step_fn, or of
cavity_fused.make_fused_step_fn for the packed step) and in the state, as
the JAX package's are with jax.grad: kernel 1 and kernel 7 through their
backward kernels, a tier's products through the tier product of the
cotangent (the transpose of a dot at its precision, as JAX takes it).
"""
from __future__ import annotations

import dataclasses

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.models import cavity_fused
from cfd_julia_torch.ops import arakawa, cuda_kernels
from cfd_julia_torch.poisson import direct
from cfd_julia_torch.stepping import loop
from cfd_julia_torch.utils import checkpoint


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
                             # (half-length rfft DST-I) | fused (the packed
                             # step of models/cavity_fused; solve only) |
                             # the bf16 tiers matmul_bf16x3, matmul_bf16x1,
                             # fused_bf16x3, fused_bf16x1 (fp32 only)
    rhs_impl: str = "auto"   # auto (kernel on a CUDA device, torch on the
                             # CPU) | kernel (csrc/arakawa_rhs.cu, or
                             # csrc/cavity_stage.cu under fused; CUDA
                             # only) | torch (plain PyTorch, any device)

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


def apply_wall_bc(w, s, dx: float, dy: float, order: int = 2):
    """Wall-BC fill of an existing full (nx+1, ny+1) field, its interior
    kept (cfd_julia_tpu/models/cavity.py:170)."""
    return assemble_with_wall_bc(w[1:-1, 1:-1], s, dx, dy, order)


def _wall_bc_fields(s, dx: float, dy: float, order: int, halo: int = 0):
    """Full-shape wall-BC candidate fields from shifts of psi, each valid on
    its own wall line (i=0, i=nx, j=0, j=ny) and selected there by a mask
    (cfd_julia_tpu/models/cavity.py:175-197).  s: the whole padded field,
    whose shifts are periodic rolls (halo=0), or a rank's block with a
    frame of `halo` >= 2 nodes from its periodic neighbours, whose shifts
    are slices of the framed block (the same values)."""
    if order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")

    def at(di, dj):
        """s[i + di, j + dj]"""
        if halo == 0:
            return torch.roll(s, (-di, -dj), (-2, -1))
        n, m = s.shape[-2] - 2 * halo, s.shape[-1] - 2 * halo
        return s[..., halo + di:halo + di + n, halo + dj:halo + dj + m]

    if order == 1:
        return (-2.0 * at(1, 0) / dx**2,
                -2.0 * at(-1, 0) / dx**2,
                -2.0 * at(0, 1) / dy**2,
                -2.0 * at(0, -1) / dy**2 - 2.0 / dy)
    return ((-4.0 * at(1, 0) + 0.5 * at(2, 0)) / dx**2,
            (-4.0 * at(-1, 0) + 0.5 * at(-2, 0)) / dx**2,
            (-4.0 * at(0, 1) + 0.5 * at(0, 2)) / dy**2,
            (-4.0 * at(0, -1) + 0.5 * at(0, -2)) / dy**2 - 3.0 / dy)


def periodic_rhs(cfg: CavityConfig, device):
    """rhs(w, s, re=cfg.re): the periodic vorticity RHS over a field's
    last two axes, kernel 1 (cuda_kernels.arakawa_rhs_fused) or its twin
    by cfg.rhs_impl resolved on `device`.  re: a float, or a 0-d tensor,
    which kernel 1 reads from device memory and differentiates in."""
    if precision.resolve_rhs_impl(cfg.rhs_impl, device) == "kernel":
        return lambda w, s, re=cfg.re: cuda_kernels.arakawa_rhs_fused(
            w, s, cfg.dx, cfg.dy, re)
    return lambda w, s, re=cfg.re: arakawa.vorticity_rhs(
        w, s, cfg.dx, cfg.dy, re)


def padded_step(cfg: CavityConfig, i, j, frame, solve, total):
    """The padded cavity step on a (block of a) (P, Q) field; the one body
    of make_padded_step_fn and parallel/sharded.make_sharded_cavity_step.
    i, j: the global row and column indices of the block, (n, 1) and
    (1, m) integer tensors; frame(w, s) -> (r, s_framed, halo): the
    periodic RHS on the block, and psi with its `halo`-node frame for
    _wall_bc_fields; solve: the padded Poisson solve on the block; total:
    the sum of a block's tensor over the whole field."""
    nx, ny = cfg.nx, cfg.ny
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    interior = (i >= 1) & (i <= nx - 1) & (j >= 1) & (j <= ny - 1)
    logical = (i <= nx) & (j <= ny)
    n_nodes = float((nx + 1) * (ny + 1))

    def close(wt_raw, s_framed, halo):
        """Mask in the wall BCs (the y-walls own the corners: applied last,
        the reference's write order), zero the padding, fresh psi."""
        bx_lo, bx_hi, by_lo, by_hi = _wall_bc_fields(s_framed, dx, dy,
                                                     cfg.bc_order, halo)
        wt = torch.where(interior, wt_raw, 0.0)
        wt = torch.where(i == 0, bx_lo, wt)
        wt = torch.where(i == nx, bx_hi, wt)
        wt = torch.where(j == 0, by_lo, wt)
        wt = torch.where(j == ny, by_hi, wt)
        wt = torch.where(logical, wt, 0.0)
        return wt, solve(-wt)

    def step(state):
        w, s, _ = state
        sp = s
        r, sf, h = frame(w, s)
        wt, s = close(w + dt * r, sf, h)
        r, sf, h = frame(wt, s)
        wt, s = close(0.75 * w + 0.25 * wt + 0.25 * dt * r, sf, h)
        r, sf, h = frame(wt, s)
        wn, s = close((w + 2.0 * wt + 2.0 * dt * r) / 3.0, sf, h)
        rms = torch.sqrt(
            total(torch.where(logical, (s - sp) ** 2, 0.0)) / n_nodes)
        return (wn, s, rms)

    return step


def make_padded_step_fn(cfg: CavityConfig, padded_shape, dtype=None,
                        device="cuda"):
    """Cavity step on mesh-divisible padded (P, Q) fields, the multi-device
    formulation on one device (cfd_julia_tpu/models/cavity.py:199-246):
    the same math as make_step_fn, with masks for the RHS and BC assembly
    and the zero-extended sine-matmul solve
    (direct.make_fst_matmul_padded).  The RHS is kernel 1 over the whole
    (P, Q) field (periodic; the interior mask keeps what the walls need).

    State: (w, s, rms) with w, s of shape padded_shape; the logical field
    lives at [0..nx, 0..ny], the padding stays exactly zero."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    if cfg.bc_order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")
    P, Q = padded_shape
    rhs = periodic_rhs(cfg, device)
    solve = direct.make_fst_matmul_padded(cfg.nx, cfg.ny, cfg.dx, cfg.dy,
                                          padded_shape, dtype, device)
    return padded_step(cfg, torch.arange(P, device=device)[:, None],
                       torch.arange(Q, device=device)[None, :],
                       lambda w, s: (rhs(w, s), s, 0), solve, torch.sum)


POISSON = ("auto", "matmul", "matmul_bf16x3", "matmul_bf16x1", "fst",
           "fst_half", "fused", "fused_bf16x3", "fused_bf16x1")
# the packed step's names (models/cavity_fused), which solve() routes
FUSED = ("fused", "fused_bf16x3", "fused_bf16x1")


def _check_poisson(name: str, dtype) -> None:
    """Raise for a Poisson solve the port does not run: an unknown name (a
    typo must never silently run the default solver), or a bf16 tier with
    a state that is not fp32 (a tier never runs at another precision)."""
    if name not in POISSON:
        raise ValueError(f"unknown poisson solver {name!r} "
                         f"({' | '.join(POISSON)})")
    if direct.tier_of(name) is not None and dtype != torch.float32:
        raise ValueError(
            f"poisson={name!r} is a bf16 precision tier of fp32 states (its "
            f"products split fp32 operands into bf16 parts); got a {dtype} "
            "state")


def make_step_fn(cfg: CavityConfig, dtype=None, device="cuda", re=None,
                 mesh=None):
    """Cavity step on state (w, s, rms) of (nx+1, ny+1) tensors of `dtype`
    on `device`; the Poisson solve's constants are built here, once.

    With a mesh (cfd_julia_tpu/models/cavity.py:290-341): poisson="fst" or
    "fst_half" only, the pencil DST-I; the state is this rank's blocks of
    the (nx+1, ny+1) fields zero-padded to mesh multiples
    (parallel/sharded.make_sharded_cavity_step, whose "matmul" form is the
    JAX package's make_padded_step_fn).  A tensor re there is every
    rank's alike (halo.replicate): after
    halo.all_reduce_sum(local_loss).backward() on every rank, re.grad
    holds the global gradient and each rank's initial blocks theirs.

    `re` overrides cfg.re: a float, or a 0-d tensor on `device` (the JAX
    package's traced re), which the kernel RHS reads from device memory.
    The step is then differentiable in re, and in the state, with
    torch.autograd (run it eagerly: loop.advance(..., graph=False)); the
    kernel RHS differentiates through its backward kernel, the "matmul"
    and "fst*" solves through cuBLAS and cuFFT, the bf16 tiers' solves
    through the tier product of the cotangent (kernel 8 on the GPU, its
    twin on the CPU; cuda_kernels.TierPlan)."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    if mesh is not None:
        if cfg.poisson not in ("fst", "fst_half"):
            raise ValueError(
                f"poisson={cfg.poisson!r} is single-device only; the mesh "
                "step uses poisson='fst'/'fst_half' (pencil DST) or "
                "parallel/sharded.make_sharded_cavity_step (matmul DST on "
                "padded blocks)")
        from cfd_julia_torch.parallel import sharded

        return sharded.make_sharded_cavity_step(cfg, mesh, dtype, device, re)
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    re = cfg.re if re is None else re
    rhs_impl = precision.resolve_rhs_impl(cfg.rhs_impl, device)
    _check_poisson(cfg.poisson, dtype)
    if cfg.poisson in FUSED:
        raise ValueError(
            f"poisson={cfg.poisson!r} selects the interior-padded fused step "
            "(models.cavity_fused), which carries a packed state and so "
            "cannot be built by make_step_fn; use cavity.solve (which "
            "routes it) or cavity_fused.make_fused_step_fn directly")
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
        solve = direct.make_fst_matmul_interior(
            cfg.nx, cfg.ny, dx, dy, dtype, device,
            tier=direct.tier_of(cfg.poisson))

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


def solve(cfg: CavityConfig, dtype=None, device="cuda",
          checkpoint_every: int = 0, checkpoint_path: str | None = None,
          resume: bool = False) -> CavityResult:
    """Integrate nt steps from rest (lid_driven_cavity.jl:58-118).  The
    result's tensors, rms history included, stay on `device`.

    checkpoint_every/checkpoint_path: save a resumable checkpoint (w, s,
    the rms history so far, the absolute step count) every N steps, the
    one host sync of each N steps.  resume: continue from checkpoint_path
    if it exists, bit for bit the uninterrupted run (each step is the same
    function of (w, s); its rms is that step's psi change, so the rms
    entry of the state is never read).

    poisson="fused" (and its tiers fused_bf16x3 / fused_bf16x1) runs the
    packed step (models/cavity_fused.py) as the JAX package's solve does:
    pack the full-grid state, run the steps, decode; once a run, or once a
    checkpoint interval, so checkpoints keep the full-grid format."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    if (checkpoint_every or resume) and not checkpoint_path:
        raise ValueError("checkpointing requires checkpoint_path")
    _check_poisson(cfg.poisson, dtype)
    if cfg.poisson in FUSED:
        fused = cavity_fused.make_fused_step_fn(cfg, dtype, device)

        def advance(state, n):
            packed, rms = loop.run_steps(
                fused, cavity_fused.pack_state(cfg, state[0], state[1]), n)
            return (*cavity_fused.decode_state(cfg, packed), packed[-1]), rms
    else:
        step = make_step_fn(cfg, dtype, device)

        def advance(state, n):
            return loop.run_steps(step, state, n)
    state = initial_state(cfg, dtype, device)
    done, parts = 0, []
    if resume and checkpoint.exists(checkpoint_path):
        (w, s, h), done = checkpoint.load_state(
            checkpoint_path, (state[0], state[1], state[2].new_empty(0)))
        if done is None or len(h) != done:
            raise ValueError(
                f"checkpoint {checkpoint_path} has no/inconsistent step "
                f"record (step={done}, rms entries={len(h)})")
        if done > cfg.nt:
            raise ValueError(
                f"checkpoint at step {done} is beyond this run's "
                f"nt={cfg.nt}; restart without --resume")
        state, parts = (w, s, state[2]), [h]
    while done < cfg.nt:
        n = cfg.nt - done
        if checkpoint_every:
            n = min(checkpoint_every, n)
        state, rms = advance(state, n)
        parts.append(rms)
        done += n
        if checkpoint_every:
            checkpoint.save_state(checkpoint_path,
                                  (state[0], state[1], torch.cat(parts)),
                                  step=done)
    w, s, _ = state
    x = torch.linspace(0.0, 1.0, cfg.nx + 1, dtype=dtype, device=device)
    y = torch.linspace(0.0, 1.0, cfg.ny + 1, dtype=dtype, device=device)
    hist = torch.cat(parts) if parts else state[2].new_empty(0)
    return CavityResult(x=x, y=y, w=w, s=s, rms_history=hist)


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
