"""Lid-driven cavity on a packed, interior-padded state (counterpart of
cfd_julia_tpu/models/cavity_fused.py; same math as models/cavity.py's
full-grid step, reference ch. 18, lid_driven_cavity.jl:58-118).

* The state holds the (nx-1, ny-1) interior of w and psi in (P, Q) buffers,
  P rounded up to a multiple of 8 and Q of 128 (`padded_extents`, as in the
  JAX package, so both packages' states have one shape): 1024 x 1024 at the
  1024^2 cavity, whose rows are 16-byte aligned and whose sine-matrix
  products are 1024^3 GEMMs.  The padding is exactly zero.
* The wall vorticity is carried as four vectors beside the interior; they
  lag psi by one solve, as the full-grid step's walls do (the reference
  assembles them from the pre-solve psi).
* A stage is one launch of the CUDA kernel csrc/cavity_stage.cu (its plain
  twin on the CPU): the RHS with the wall vectors, the SSP-RK3 combine, the
  validity mask and the next stage's wall vectors.  The Poisson solve is
  four matrix products with the zero-extended sine matrices, so a step is 3
  stage launches, 12 GEMMs, the scalings and the rms.  The products are
  fp32 (or fp64) under poisson="fused" and split-bf16 under the precision
  tiers "fused_bf16x3" / "fused_bf16x1" (JAX's mm_precision "high" /
  "default"; poisson/direct.sine_solve: csrc/tier_gemm.cu on the GPU, the
  sine matrices split once when the step is built, each GEMM writing the
  next one's split operand with / den and * scale folded in, so a step
  is 3 splits and 12 GEMMs; its twin on the CPU, fp32 states only).
* The step is differentiable with torch.autograd in the state and in a
  tensor Re (make_fused_step_fn's `re`), as the JAX package's packed step
  is with jax.grad: a stage through the kernel's backward kernel
  (cuda_kernels.cavity_fused_stage_backward) on the GPU and autograd of
  its twin on the CPU, a tier's products through the tier product of the
  cotangent.

The state is the flat tuple (w, s, rl, rh, cl, ch, rms), rms last, as the
loop layer records state[-1]; the JAX package nests the walls,
(w, s, (rl, rh, cl, ch), rms) (interop.cavity_fused_state_from_numpy maps
one to the other).  rl / rh run over columns (the walls i = 0 / nx), cl / ch
over rows (j = 0 / ny, the lid), in interior index space, 0 past the
logical interior.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.poisson import direct


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def padded_extents(nx: int, ny: int) -> tuple[int, int]:
    """Interior (nx-1, ny-1) padded to multiples of (8, 128)."""
    return _round_up(nx - 1, 8), _round_up(ny - 1, 128)


def _check(cfg) -> None:
    if cfg.bc_order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")
    if cfg.nx < 3 or cfg.ny < 3:
        raise ValueError(f"the packed cavity needs nx, ny >= 3, got "
                         f"{(cfg.nx, cfg.ny)}")


def make_solve_neg(cfg, dtype, device):
    """The step's Poisson solve on the packed (P, Q) buffers: wt -> psi
    with lap(psi) = -wt on the interior (walls and padding zero), four
    products with the zero-extended sine matrices built here
    (direct.sine_solve), in cfg.poisson's precision tier."""
    nx, ny, dx, dy = cfg.nx, cfg.ny, cfg.dx, cfg.dy
    m, n = nx - 1, ny - 1
    P, Q = padded_extents(nx, ny)

    def sine_padded(nn, size):
        k = torch.arange(size, dtype=torch.int32, device=device)
        s = direct._sine_entries(k[:, None] + 1, k[None, :] + 1, nn, dtype)
        inside = (k[:, None] < nn - 1) & (k[None, :] < nn - 1)
        return torch.where(inside, s, 0.0)

    sx, sy = sine_padded(nx, P), sine_padded(ny, Q)
    ai = torch.arange(P, device=device)[:, None]
    bj = torch.arange(Q, device=device)[None, :]
    kx, ky = (ai + 1).to(dtype), (bj + 1).to(dtype)
    den = (2.0 / dx**2) * (torch.cos(math.pi * kx / nx) - 1.0) + (
        2.0 / dy**2) * (torch.cos(math.pi * ky / ny) - 1.0)
    neg_den = -torch.where((ai < m) & (bj < n), den, 1.0)
    return direct.sine_solve(direct.tier_of(cfg.poisson), sx, sy, neg_den,
                             4.0 / (nx * ny), (P, Q))


def make_fused_step_fn(cfg, dtype=None, device="cuda", re=None):
    """Step on the packed state (w, s, rl, rh, cl, ch, rms) of `dtype` on
    `device`; the matrices are built here, once.  cfg.rhs_impl picks the
    stage: auto (the kernel on a CUDA device, the twin on the CPU), kernel
    or torch (the twin, any device).  cfg.poisson picks the products:
    fused_bf16x3 / fused_bf16x1 their tier, any other name full precision
    (TF32 stays off: the JAX package's mm_precision="highest").

    `re` overrides cfg.re, as in cavity.make_step_fn: a float, or a 0-d
    tensor (the JAX package's traced cfg.re), whose value is read on the
    host once, here (the stage kernel takes a host Re); a step raises if
    the tensor has been written in place since, and under a CUDA graph
    capture (a replay would keep the value read here after the tensor
    changes: run such a step with graph=False).  The step is
    differentiable in re and in the state with torch.autograd (run it
    eagerly: loop.advance(..., graph=False)): the stage kernel through its
    backward kernel, a tier's solve through the chained tier products of
    the cotangent (cuda_kernels.TierSolve), the fp32 / fp64 ones through
    cuBLAS."""
    _check(cfg)
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    kernel = precision.resolve_rhs_impl(cfg.rhs_impl, device) == "kernel"
    nx, ny = cfg.nx, cfg.ny
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    re_t = re if isinstance(re, torch.Tensor) else None
    if re_t is not None:
        if re_t.dim() != 0 or not re_t.is_floating_point():
            raise ValueError(f"re must be a float or a 0-d floating tensor, "
                             f"got {re_t.dtype} of shape "
                             f"{tuple(re_t.shape)}")
        re_value, re_version = float(re_t.detach()), re_t._version
    else:
        re_value = cfg.re if re is None else float(re)
    m, n = nx - 1, ny - 1
    n_nodes = float((nx + 1) * (ny + 1))
    solve_neg = make_solve_neg(cfg, dtype, device)

    def stage(k, w, wt, s, walls):
        if kernel:
            wt, walls = cuda_kernels.cavity_fused_stage(
                w, wt, s, walls, k, dt, dx, dy, re_value, m, n, cfg.bc_order,
                re_t=re_t)
        else:
            wt, walls = cuda_kernels.cavity_fused_stage_plain(
                w, wt, s, walls, k, dt, dx, dy,
                re_value if re_t is None else re_t, m, n, cfg.bc_order)
        return wt, solve_neg(wt), walls

    def step(state):
        if re_t is not None:
            if re_t._version != re_version:
                raise ValueError(
                    "the Re tensor of this packed cavity step was written in "
                    "place after the step was built, which read its value "
                    f"({re_value!r}) once; rebuild the step with "
                    "make_fused_step_fn(..., re=...)")
            if state[0].is_cuda and torch.cuda.is_current_stream_capturing():
                raise ValueError(
                    "a packed cavity step built with an Re tensor reads its "
                    "value once, on the host, and a CUDA graph would replay "
                    "it after the tensor changes: run the step with "
                    "graph=False, or build it with a float Re")
        w, s, *walls, _ = state
        sp = s
        wt, s, walls = stage(1, w, w, s, tuple(walls))
        wt, s, walls = stage(2, w, wt, s, walls)
        wn, s, walls = stage(3, w, wt, s, walls)
        rms = torch.sqrt(torch.sum((s - sp) ** 2) / n_nodes)
        return (wn, s, *walls, rms)

    return step


def init_state(cfg, dtype=None, device="cuda"):
    """The packed state at rest: w = psi = 0 and zero wall vectors (the
    full-grid step's first RHS also sees the all-zero w0)."""
    _check(cfg)
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    P, Q = padded_extents(cfg.nx, cfg.ny)
    z = torch.zeros((P, Q), dtype=dtype, device=device)
    return (z, torch.zeros_like(z), z.new_zeros(Q), z.new_zeros(Q),
            z.new_zeros(P), z.new_zeros(P), z.new_zeros(()))


def pack_state(cfg, w_full, s_full):
    """Full-grid (w, s) -> packed state, the walls taken from w_full."""
    m, n = cfg.nx - 1, cfg.ny - 1
    P, Q = padded_extents(cfg.nx, cfg.ny)
    pad = (0, Q - n, 0, P - m)
    return (F.pad(w_full[1:-1, 1:-1], pad), F.pad(s_full[1:-1, 1:-1], pad),
            F.pad(w_full[0, 1:-1], (0, Q - n)),
            F.pad(w_full[-1, 1:-1], (0, Q - n)),
            F.pad(w_full[1:-1, 0], (0, P - m)),
            F.pad(w_full[1:-1, -1], (0, P - m)), w_full.new_zeros(()))


def decode_state(cfg, state):
    """Packed state -> full-grid (w, s): the walls re-attached from the
    vectors, the lid corners from the y-walls (0 while the walls are all
    zero, so the state at rest decodes to zero), psi's walls zero."""
    w, s, rl, rh, cl, ch, _ = state
    m, n = cfg.nx - 1, cfg.ny - 1
    zero = w.new_zeros(1)
    lid = w.new_full((1,), cuda_kernels._lid(cfg.dy, cfg.bc_order))
    corner = torch.where(ch[:m].any(), lid, zero)
    mid = torch.cat([rl[None, :n], w[:m, :n], rh[None, :n]], 0)
    col_lo = torch.cat([zero, cl[:m], zero])
    col_hi = torch.cat([corner, ch[:m], corner])
    w_full = torch.cat([col_lo[:, None], mid, col_hi[:, None]], 1)
    return w_full, F.pad(s[:m, :n], (1, 1, 1, 1))
