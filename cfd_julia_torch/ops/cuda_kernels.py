"""Hand-written CUDA kernels for the hot stencil paths, with their plain
PyTorch twins (counterpart of cfd_julia_tpu/ops/pallas_kernels.py).

Each wrapper takes the plain twin for tensors on the CPU; for CUDA tensors
it launches its kernel (csrc/, built by ops/_cuda_build.py) on the current
stream or raises — it never falls back.  `LAUNCHES[name]` counts the
wrapper's CUDA calls, one per call of the TPU function it replaces, so a
run can show that its main path went through the kernels; under a CUDA
graph the loop layer (stepping/loop.Graph) keeps it counting the kernels
that ran: a capture's calls are taken back and added once per replay.  A
level-edge call is one `__global__` launch for up to K = 3 sweeps (plus
the residual sum's one-block reduction), one more a further K sweeps; a
smoother call is one launch for any sweeps on a level that fits one
block's shared memory, else as a level edge's.  CPU calls count nothing.
Under utils.debug.nan_guard each CUDA call also checks its outputs and
raises FloatingPointError naming the kernel at a NaN; outside it that
check is one flag test on the host and nothing on the device.

Kernels (csrc/ file; TPU function replaced):
  arakawa_rhs_fused               arakawa_rhs.cu; arakawa_rhs_fused (any
                                  batch, one Re a member from device
                                  memory: the vmapped XLA RHS of
                                  models/ensemble.py)
  arakawa_rhs_backward            arakawa_rhs.cu; none (the JAX package
                                  differentiates its XLA RHS): the adjoint
                                  of arakawa_rhs_fused, its autograd
                                  backward; the Re gradient's sum folded
                                  into its last block (one launch)
  redblack_sweeps_fused           multigrid.cu;   redblack_sweeps_fused
  smooth_residual_restrict_fused  multigrid.cu;   smooth_residual_restrict_fused
  residual_restrict_fused         multigrid.cu;   residual_restrict_fused
  prolong_correct_smooth_fused    multigrid.cu;   prolong_correct_smooth_fused
  residual_ssq                    multigrid.cu;   none: the XLA-fused
                                  residual_full + sum of r^2 of the JAX
                                  multigrid solve (its rms0, an unfused
                                  cycle's check, fmg_start's g)
  euler_rhs_fused                 euler_rhs.cu;   euler_rhs_fused
  cavity_fused_stage              cavity_stage.cu; the XLA-fused stage of
                                  models/cavity_fused.py:153-215 (not a
                                  Pallas kernel)
  cavity_stage_backward           cavity_stage.cu; none (the JAX package
                                  differentiates its XLA stage): the
                                  adjoint of cavity_fused_stage, its
                                  autograd backward; the Re gradient's sum
                                  folded into its last block (one launch)
  vortex_derivs_half,             vortex_stage.cu; the XLA-fused stage math
  vortex_product,                 of the half-spectrum vortex step
  vortex_cn_combine,              (cfd_julia_tpu/models/vortex.py:392; not
  vortex_truncate_32              a Pallas kernel): the derivative spectra
                                  (also written into the step's cuFFT
                                  layout, ops/fft_plans.py), the physical
                                  product, the Crank-Nicolson combine,
                                  ps32's truncation; their backward is
                                  torch ops

ops/fft_plans.py counts its cuFFT executions here too, under fft_c2c and
fft_c2r.
  tier_split, tier_matmul,        tier_gemm.cu;   XLA's bf16_3x / default
  TierPlan, TierSolve             dot of the precision tiers (direct.py:99-
                                  102, cavity_fused.py:120; not a Pallas
                                  kernel): the operand split and the GEMM,
                                  whose epilogue can write op(C) as the
                                  next product's bf16 planes (a solve's
                                  chained products: one split, four GEMMs);
                                  also their backward, the same kernels on
                                  the cotangent

The multigrid kernels take bf16, fp32 or fp64 fields; bf16 computes in
fp32 and rounds once, at the output store (the TPU kernels' `_c32`
contract), and so do the bf16 twins.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from cfd_julia_torch.ops import _cuda_build, arakawa, riemann, weno
from cfd_julia_torch.poisson import iterative

LAUNCHES = {"arakawa_rhs": 0, "arakawa_rhs_backward": 0,
            "redblack_sweeps": 0,
            "smooth_residual_restrict": 0, "residual_restrict": 0,
            "prolong_correct_smooth": 0, "residual_ssq": 0,
            "euler_rhs": 0,
            "cavity_fused_stage": 0, "cavity_stage_backward": 0,
            "tier_split": 0, "tier_gemm": 0,
            "vortex_derivs_half": 0, "vortex_product": 0,
            "vortex_cn_combine": 0, "vortex_truncate_32": 0,
            "fft_c2c": 0, "fft_c2r": 0}

# set by utils.debug.nan_guard: every launch checks its outputs for NaNs,
# and the loop layer and the multigrid solve run eagerly (a check syncs,
# which a CUDA graph capture forbids)
CHECK_NAN = False

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_MG_DTYPES = tuple(_SUFFIX)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(name: str, *tensors, any_order=()) -> bool:
    """True for CPU tensors (take the twin); checks a CUDA call's
    preconditions: `tensors` contiguous, `any_order` on the same device
    (their layout the caller's to check); raises for any other device."""
    every = (*tensors, *any_order)
    dev = every[0].device
    if any(t.device != dev for t in every):
        raise ValueError(f"{name}: tensors lie on different devices: "
                         f"{[str(t.device) for t in every]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if every[0].numel() >= 2**31:
        raise ValueError(f"{every[0].numel()} points exceed the kernel's "
                         "int index")
    return False


def _launch(name: str, symbol: str, device, *args, outputs=()) -> None:
    """Call a C launcher of the kernel library on `device`'s current
    stream; raise on a launch error; count the call.  Under
    utils.debug.nan_guard (CHECK_NAN), raise FloatingPointError naming the
    kernel if one of `outputs` holds a NaN (a device sync a call)."""
    lib = _cuda_build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        msg = lib.cfd_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    if CHECK_NAN and any(bool(torch.isnan(t).any()) for t in outputs
                         if t is not None):
        raise FloatingPointError(
            f"NaN in the output of the {name} kernel ({symbol})")


# the Re gradient's completion counters of the backward kernels, one
# buffer a (device, stream): see _fold_counters
_FOLD_COUNTERS: dict = {}


def _fold_counters(device):
    """The completion counters of the backward kernels' Re-gradient fold
    (csrc/arakawa.cuh fold_re_grad: a batch's member b counts its blocks on
    counter b mod their number) for `device`'s current stream: unsigned
    ints in device memory, made and zeroed once (their one memset), then
    left at 0 by every launch (the last block of a member resets its
    counter), so no call, and no replay of a CUDA graph that captured one,
    needs a memset.  Calls on one stream run one after another and share
    them; calls on two streams at once would take each other's tickets, so
    each stream has its own buffer.  A graph keeps the buffer of the stream
    it was captured on."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    counters = _FOLD_COUNTERS.get(key)
    if counters is None:
        n = _cuda_build.load_library().arakawa_rhs_backward_constant(6)
        with torch.cuda.device(device):
            counters = torch.zeros(n, dtype=torch.int32, device=device)
        _FOLD_COUNTERS[key] = counters
    return counters


# ------------------------------------------------------- Arakawa RHS

def arakawa_rhs_fused_plain(w, s, dx: float, dy: float, re):
    """Plain twin of arakawa_rhs_fused: ops.arakawa.vorticity_rhs."""
    return arakawa.vorticity_rhs(w, s, dx, dy, re)


def arakawa_rhs_backward_plain(w, s, g, dx: float, dy: float, re):
    """Plain twin of arakawa_rhs_backward: the adjoint of the RHS by the
    Jacobian's antisymmetry on the periodic grid (csrc/arakawa_rhs.cu),
    on the twin's jacobian and laplacian:
      gw = -J(s, g) + lap(g)/re,  gs = -J(g, w),
      gre = -sum g lap(w) / re^2 over each member's last two axes."""
    gw = -arakawa.jacobian(s, g, dx, dy) + \
        arakawa.laplacian(g, dx, dy) / arakawa.members(re)
    gs = -arakawa.jacobian(g, w, dx, dy)
    gre = -(g * arakawa.laplacian(w, dx, dy)).sum((-2, -1)) / re**2
    return gw, gs, gre


def _check_arakawa(name: str, w, s, re) -> None:
    if w.dtype not in (torch.float32, torch.float64) or s.dtype != w.dtype:
        raise TypeError(f"{name} takes two fp32 or two fp64 tensors, got "
                        f"{w.dtype} and {s.dtype}")
    if w.dim() < 2 or s.shape != w.shape:
        raise ValueError(f"{name} takes two (..., n_rows, n_cols) tensors of "
                         f"one shape, got {tuple(w.shape)} and "
                         f"{tuple(s.shape)}")
    if w.shape[-2] < 3:
        raise ValueError(f"{name} needs >= 3 rows, got {w.shape[-2]}")
    if isinstance(re, torch.Tensor):
        if re.device != w.device or not re.is_floating_point():
            raise ValueError(f"{name}: re must be a floating tensor on "
                             f"{w.device}, got {re.dtype} on {re.device}")
        try:
            fits = torch.broadcast_shapes(re.shape, w.shape[:-2]) == \
                w.shape[:-2]
        except RuntimeError:
            fits = False
        if not fits:
            raise ValueError(f"{name}: re of shape {tuple(re.shape)} does "
                             f"not broadcast to the batch "
                             f"{tuple(w.shape[:-2])}")


def _member_re(re, w):
    """A (members,) tensor of w's dtype, contiguous, from a tensor re that
    broadcasts over w's leading axes; differentiable."""
    lead = w.shape[:-2]
    re = re.to(w.dtype)
    if tuple(re.shape) != tuple(lead):
        re = re.expand(lead)
    return re.reshape(-1).contiguous()


def _batch_re(re, w3):
    """A (B,) device tensor of w3's dtype: re's members, or a float re
    filled in (the kernels take a batch's Re from device memory)."""
    if isinstance(re, torch.Tensor):
        return re
    return torch.full((w3.shape[0],), float(re), dtype=w3.dtype,
                      device=w3.device)


def _arakawa_launch(w, s, dx: float, dy: float, re):
    """Kernel 1 on contiguous (B, nr, nc) CUDA fields: the 2-D entry for a
    float re and B = 1, else the batched entry, each member's Re read from
    device memory (re a (B,) tensor, or a float filled into one)."""
    batch, nr, nc = w.shape
    out = torch.empty_like(w)
    sfx = _SUFFIX[w.dtype]
    if batch == 1 and not isinstance(re, torch.Tensor):
        _launch("arakawa_rhs", f"arakawa_rhs_{sfx}", w.device, w.data_ptr(),
                s.data_ptr(), out.data_ptr(), nr, nc, float(dx), float(dy),
                float(re), outputs=(out,))
    else:
        _launch("arakawa_rhs", f"arakawa_rhs_batched_{sfx}", w.device,
                w.data_ptr(), s.data_ptr(), out.data_ptr(),
                _batch_re(re, w).data_ptr(), batch, nr, nc, float(dx),
                float(dy), outputs=(out,))
    return out


class _ArakawaRHS(torch.autograd.Function):
    """Kernel 1 with its backward kernel: forward arakawa_rhs, backward
    arakawa_rhs_backward, on (B, nr, nc) CUDA fields; re a float (no
    gradient) or a (B,) tensor."""

    @staticmethod
    def forward(ctx, w, s, re, dx, dy):
        ctx.dx, ctx.dy = dx, dy
        ctx.re = None if isinstance(re, torch.Tensor) else re
        ctx.save_for_backward(w, s, *((re,) if ctx.re is None else ()))
        return _arakawa_launch(w, s, dx, dy, re)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        w, s, *re = ctx.saved_tensors
        re = re[0] if re else ctx.re
        want_re = ctx.re is None and ctx.needs_input_grad[2]
        gw, gs, gre = arakawa_rhs_backward(w, s, g.contiguous(), ctx.dx,
                                           ctx.dy, re, re_grad=want_re)
        return gw, gs, gre, None, None


def arakawa_rhs_fused(w, s, dx: float, dy: float, re):
    """Periodic vorticity RHS -J(w,s) + lap(w)/re over the last two axes
    of (..., n_rows, n_cols) fields, in one kernel pass
    (csrc/arakawa_rhs.cu) for any batch; matches ops.arakawa.vorticity_rhs.
    w, s: fp32 or fp64 tensors of one shape on one device, n_rows >= 3.
    re: a float, or a tensor on w's device broadcast over the leading axes
    (a 0-d tensor, or one Re a member), read by the kernel from device
    memory (so a CUDA graph may capture the call and the values change
    between replays).  Differentiable on the GPU through the backward
    kernel (arakawa_rhs_backward) in w, s and a tensor re; on the CPU
    autograd differentiates the twin."""
    _check_arakawa("arakawa_rhs_fused", w, s, re)
    if _on_cpu("arakawa_rhs_fused", w, s):
        return arakawa_rhs_fused_plain(w, s, dx, dy, re)
    shape = w.shape
    w3, s3 = w.reshape(-1, *shape[-2:]), s.reshape(-1, *shape[-2:])
    if isinstance(re, torch.Tensor):
        re = _member_re(re, w)
    tracked = torch.is_grad_enabled() and (
        w.requires_grad or s.requires_grad
        or (isinstance(re, torch.Tensor) and re.requires_grad))
    if tracked:
        out = _ArakawaRHS.apply(w3, s3, re, dx, dy)
    else:
        out = _arakawa_launch(w3, s3, dx, dy, re)
    return out.reshape(shape)


def arakawa_rhs_backward(w, s, g, dx: float, dy: float, re,
                         re_grad: bool = True):
    """The adjoint of arakawa_rhs_fused for upstream gradient g: (gw, gs,
    gre), gw = -J(s, g) + lap(g)/re, gs = -J(g, w) (ops.arakawa's J and
    lap), gre = -sum g lap(w) / re^2 over each member's last two axes (of
    shape w.shape[:-2]), or None with re_grad=False.  One launch of the
    backward kernel (csrc/arakawa_rhs.cu), counted under
    arakawa_rhs_backward, with or without gre: its blocks write fp64
    partial sums, and the last block to finish adds each member's in a
    fixed order (no atomics on a value: the same result every run) and
    resets its member's completion counter (_fold_counters; concurrent
    calls on two streams use two buffers of them).  16-byte-aligned rows take
    the kernel's 16-byte lanes, others its one-column lanes.  re: a float
    or a tensor broadcast over the leading axes.  Matches
    arakawa_rhs_backward_plain."""
    _check_arakawa("arakawa_rhs_backward", w, s, re)
    if g.shape != w.shape or g.dtype != w.dtype:
        raise ValueError(f"arakawa_rhs_backward: g of {g.dtype} "
                         f"{tuple(g.shape)}, want {w.dtype} "
                         f"{tuple(w.shape)}")
    if _on_cpu("arakawa_rhs_backward", w, s, g):
        gw, gs, gre = arakawa_rhs_backward_plain(w, s, g, dx, dy, re)
        return gw, gs, gre if re_grad else None
    shape = w.shape
    nr, nc = shape[-2:]
    w3, s3, g3 = (t.reshape(-1, nr, nc) for t in (w, s, g))
    batch = w3.shape[0]
    re_b = _batch_re(_member_re(re, w) if isinstance(re, torch.Tensor)
                     else re, w3)
    gw, gs = torch.empty_like(w3), torch.empty_like(w3)
    partials = counters = gre = None
    if re_grad:
        n = _cuda_build.load_library().arakawa_rhs_backward_partials(nr, nc)
        partials = torch.empty(batch * n, dtype=torch.float64,
                               device=w.device)
        counters = _fold_counters(w.device)
        gre = torch.empty(batch, dtype=w.dtype, device=w.device)
    _launch("arakawa_rhs_backward",
            f"arakawa_rhs_backward_{_SUFFIX[w.dtype]}", w.device,
            *(t.data_ptr() for t in (w3, s3, g3, re_b, gw, gs)),
            *(_ptr(t) for t in (partials, counters, gre)), batch, nr, nc,
            float(dx), float(dy), outputs=(gw, gs, gre))
    return (gw.reshape(shape), gs.reshape(shape),
            None if gre is None else gre.reshape(shape[:-2]))


# ------------------------------------------------------- multigrid

def _check_level(name: str, u, f, uc=None, sweeps: int = 0,
                 node_centred: bool = True) -> None:
    """dtype, shape and sweep-count checks of the multigrid wrappers."""
    if u.dtype not in _MG_DTYPES or f.dtype != u.dtype or (
            uc is not None and uc.dtype != u.dtype):
        raise TypeError(
            f"{name} takes fields of one dtype (bf16, fp32 or fp64), got "
            f"{[str(t.dtype) for t in (u, f, uc) if t is not None]}")
    if u.dim() != 2 or f.shape != u.shape:
        raise ValueError(f"{name} takes u and f of one 2-D shape, got "
                         f"{tuple(u.shape)} and {tuple(f.shape)}")
    nr, nc = u.shape
    if nr < 3 or nc < 3:
        raise ValueError(f"{name} needs >= 3 points a side, got {(nr, nc)}")
    if node_centred and (nr % 2 == 0 or nc % 2 == 0):
        raise ValueError(f"{name} takes node-centred (2m+1)-point axes, "
                         f"got {(nr, nc)}")
    if uc is not None:
        want = ((nr - 1) // 2 + 1, (nc - 1) // 2 + 1)
        if tuple(uc.shape) != want:
            raise ValueError(f"{name}: coarse field of shape "
                             f"{tuple(uc.shape)}, expected {want}")
    if sweeps < 0:
        raise ValueError(f"{name}: sweeps must be >= 0, got {sweeps}")


def _compute(t):
    """bf16 computes in fp32 (the `_c32` contract); others as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _compute_dtype(u):
    return torch.float64 if u.dtype == torch.float64 else torch.float32


def edge_sweeps_per_pass() -> int:
    """K: the sweeps a level-edge kernel runs in one pass over its
    shared-memory tiles (csrc/multigrid.cu); builds the CUDA library."""
    return _cuda_build.load_library().mg_edge_sweeps_per_pass()


def _pass_work(u, sweeps: int):
    """Compute-type state between the passes of a level-edge or tiled
    smoother call with more sweeps than one pass runs (K,
    csrc/multigrid.cu), else None."""
    fields = _cuda_build.load_library().mg_edge_work_fields(sweeps)
    if fields == 0:
        return None
    return torch.empty((fields, *u.shape), dtype=_compute_dtype(u),
                       device=u.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sweeps_plain(u, f, dx: float, dy: float, iters: int):
    nx, ny = u.shape[0] - 1, u.shape[1] - 1
    mr, mb = iterative.color_masks(nx, ny, u.dtype, u.device)
    for _ in range(iters):
        u = iterative.redblack_sweep(u, f, dx, dy, mr, mb)
    return u


def _residual_restrict_plain(u, f, dx: float, dy: float):
    from cfd_julia_torch.poisson import multigrid

    mask = iterative.interior_mask(u.shape[0] - 1, u.shape[1] - 1, u.dtype,
                                   u.device)
    return multigrid.restriction_reshape(
        iterative.residual_full(f, u, dx, dy, mask))


def redblack_sweeps_fused_plain(u, f, dx: float, dy: float, iters: int = 1):
    """Plain twin of redblack_sweeps_fused: `iters` masked red-black
    sweeps (poisson.iterative.redblack_sweep)."""
    return _sweeps_plain(_compute(u), _compute(f), dx, dy, iters).to(u.dtype)


def redblack_sweeps_fused(u, f, dx: float, dy: float, iters: int = 1):
    """`iters` full red-black Gauss-Seidel sweeps of the 5-point operator
    (red = (i+j) even first, interior nodes only) on an (n_rows, n_cols)
    field; a new tensor, u is not modified (csrc/multigrid.cu,
    mg_rb_sweeps_*: one launch on a level that fits one block's shared
    memory, else one pass over shared-memory tiles for up to 3 sweeps)."""
    _check_level("redblack_sweeps_fused", u, f, sweeps=iters,
                 node_centred=False)
    if _on_cpu("redblack_sweeps_fused", u, f):
        return redblack_sweeps_fused_plain(u, f, dx, dy, iters)
    out = torch.empty_like(u)
    work = _pass_work(u, iters)
    _launch("redblack_sweeps", f"mg_rb_sweeps_{_SUFFIX[u.dtype]}", u.device,
            u.data_ptr(), f.data_ptr(), out.data_ptr(), _ptr(work),
            *u.shape, 1.0 / dx**2, 1.0 / dy**2, iters, outputs=(out,))
    return out


def smooth_residual_restrict_fused_plain(u, f, dx: float, dy: float,
                                         sweeps: int):
    """Plain twin of smooth_residual_restrict_fused: the sweeps, then the
    reshape restriction of the masked residual."""
    uc, fc = _compute(u), _compute(f)
    us = _sweeps_plain(uc, fc, dx, dy, sweeps)
    return (us.to(u.dtype),
            _residual_restrict_plain(us, fc, dx, dy).to(u.dtype))


def smooth_residual_restrict_fused(u, f, dx: float, dy: float, sweeps: int):
    """The V-cycle descend edge (mg_N.jl:74-92): `sweeps` red-black
    sweeps, the 5-point residual, full-weighting restriction.  Returns
    (u_smoothed, f_coarse) == (smooth(u, f, sweeps),
    restriction(residual_full(f, smooth(u, f, sweeps)))), the coarse
    boundary ring 0 (csrc/multigrid.cu, mg_smooth_residual_restrict_*:
    one pass over shared-memory tiles for up to 3 sweeps)."""
    _check_level("smooth_residual_restrict_fused", u, f, sweeps=sweeps)
    if _on_cpu("smooth_residual_restrict_fused", u, f):
        return smooth_residual_restrict_fused_plain(u, f, dx, dy, sweeps)
    nr, nc = u.shape
    out = torch.empty_like(u)
    fc = u.new_empty(((nr - 1) // 2 + 1, (nc - 1) // 2 + 1))
    work = _pass_work(u, sweeps)
    _launch("smooth_residual_restrict",
            f"mg_smooth_residual_restrict_{_SUFFIX[u.dtype]}", u.device,
            u.data_ptr(), f.data_ptr(), out.data_ptr(), fc.data_ptr(),
            _ptr(work), nr, nc, 1.0 / dx**2, 1.0 / dy**2, sweeps,
            outputs=(out, fc))
    return out, fc


def residual_restrict_fused_plain(u, f, dx: float, dy: float):
    """Plain twin of residual_restrict_fused."""
    return _residual_restrict_plain(_compute(u), _compute(f), dx,
                                    dy).to(u.dtype)


def residual_restrict_fused(u, f, dx: float, dy: float):
    """restriction(residual_full(f, u)) on node-centred grids, the coarse
    boundary ring 0 (csrc/multigrid.cu, mg_residual_restrict_*)."""
    _check_level("residual_restrict_fused", u, f)
    if _on_cpu("residual_restrict_fused", u, f):
        return residual_restrict_fused_plain(u, f, dx, dy)
    nr, nc = u.shape
    fc = u.new_empty(((nr - 1) // 2 + 1, (nc - 1) // 2 + 1))
    _launch("residual_restrict", f"mg_residual_restrict_{_SUFFIX[u.dtype]}",
            u.device, u.data_ptr(), f.data_ptr(), fc.data_ptr(), nr, nc,
            1.0 / dx**2, 1.0 / dy**2, outputs=(fc,))
    return fc


def _span(t) -> tuple[int, int]:
    """The bytes [first, last) a tensor's elements occupy."""
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def _check_out(name: str, out, like, *inputs) -> None:
    """An `out=` tensor must be a contiguous tensor of like's shape, dtype
    and device that shares no byte with `inputs`."""
    if out.dtype != like.dtype:
        raise TypeError(f"{name}: out of {out.dtype}, want {like.dtype}")
    if out.shape != like.shape or out.device != like.device:
        raise ValueError(f"{name}: out of shape {tuple(out.shape)} on "
                         f"{out.device}, want {tuple(like.shape)} on "
                         f"{like.device}")
    if not out.is_contiguous():
        raise ValueError(f"{name} writes a contiguous out")
    a0, a1 = _span(out)
    for t in inputs:
        b0, b1 = _span(t)
        if a0 < b1 and b0 < a1:
            raise ValueError(f"{name}: out overlaps an input")


def prolong_correct_smooth_fused_plain(u, f, uc, dx: float, dy: float,
                                       sweeps: int, want_rms: bool = False,
                                       out=None):
    """Plain twin of prolong_correct_smooth_fused: reshape prolongation,
    masked add, the sweeps, and sum(r^2) of the result in the compute
    dtype; the result copied into `out` when given."""
    from cfd_julia_torch.poisson import multigrid

    u32, f32 = _compute(u), _compute(f)
    mask = iterative.interior_mask(u.shape[0] - 1, u.shape[1] - 1,
                                   u32.dtype, u.device)
    v = u32 + multigrid.prolongation_reshape(_compute(uc)) * mask
    v = _sweeps_plain(v, f32, dx, dy, sweeps)
    res = v.to(u.dtype) if out is None else out.copy_(v)
    if not want_rms:
        return res
    r = iterative.residual_full(f32, v, dx, dy, mask)
    return res, torch.sum(r * r)


def prolong_correct_smooth_fused(u, f, uc, dx: float, dy: float,
                                 sweeps: int, want_rms: bool = False,
                                 out=None):
    """The V-cycle ascend edge (mg_N.jl:94-105): bilinear prolongation of
    the coarse correction uc, added at interior nodes, then `sweeps`
    red-black sweeps; == smooth(u + prolongation(uc) * imask, f, sweeps).
    want_rms=True also returns sum(residual(f, u_out)^2) over the interior
    as a 0-d fp32 tensor (fp64 for fp64 fields), summed in a fixed order
    (csrc/multigrid.cu, mg_prolong_correct_smooth_*: one pass over
    shared-memory tiles for up to 3 sweeps, and with the sum one
    one-block reduction).  out: a contiguous tensor like u, sharing no
    memory with u, f or uc, that the result is written into (a captured
    V-cycle's static u); a new tensor when None."""
    _check_level("prolong_correct_smooth_fused", u, f, uc, sweeps)
    if out is not None:
        _check_out("prolong_correct_smooth_fused", out, u, u, f, uc)
    if _on_cpu("prolong_correct_smooth_fused", u, f, uc):
        return prolong_correct_smooth_fused_plain(u, f, uc, dx, dy, sweeps,
                                                  want_rms, out)
    nr, nc = u.shape
    out = torch.empty_like(u) if out is None else out
    work = _pass_work(u, sweeps)
    partials = ssq = None
    if want_rms:
        cdt = _compute_dtype(u)
        n = getattr(_cuda_build.load_library(),
                    f"mg_ssq_partials_{_SUFFIX[u.dtype]}")(nr, nc, sweeps)
        partials = torch.empty(n, dtype=cdt, device=u.device)
        ssq = torch.empty((), dtype=cdt, device=u.device)
    _launch("prolong_correct_smooth",
            f"mg_prolong_correct_smooth_{_SUFFIX[u.dtype]}", u.device,
            u.data_ptr(), f.data_ptr(), uc.data_ptr(), out.data_ptr(),
            _ptr(work), _ptr(partials), _ptr(ssq), nr, nc, 1.0 / dx**2,
            1.0 / dy**2, sweeps, outputs=(out, ssq))
    return (out, ssq) if want_rms else out


def residual_ssq_plain(u, f, dx: float, dy: float, want_r: bool = False):
    """Plain twin of residual_ssq: r = iterative.residual_full(f, u, dx,
    dy, interior mask) in the compute dtype, and (sum(r * r), r or None)."""
    u32, f32 = _compute(u), _compute(f)
    mask = iterative.interior_mask(u.shape[0] - 1, u.shape[1] - 1,
                                   u32.dtype, u.device)
    r = iterative.residual_full(f32, u32, dx, dy, mask)
    return torch.sum(r * r), (r.to(u.dtype) if want_r else None)


def residual_ssq(u, f, dx: float, dy: float, want_r: bool = False):
    """(ssq, r): the sum of the squared 5-point residual f - lap(u) over
    the interior of an (n_rows, n_cols) level, >= 3 a side, as a 0-d
    tensor in the compute dtype (fp32, fp64 for fp64 fields), summed in a
    fixed order; with want_r the residual itself (0 on the boundary ring,
    u's dtype), else None (csrc/multigrid.cu, mg_residual_ssq_*: one
    streaming pass and a one-block reduction of its partials)."""
    _check_level("residual_ssq", u, f, node_centred=False)
    if _on_cpu("residual_ssq", u, f):
        return residual_ssq_plain(u, f, dx, dy, want_r)
    nr, nc = u.shape
    cdt = _compute_dtype(u)
    n = _cuda_build.load_library().mg_residual_ssq_partials(nr, nc)
    partials = torch.empty(n, dtype=cdt, device=u.device)
    ssq = torch.empty((), dtype=cdt, device=u.device)
    r = torch.empty_like(u) if want_r else None
    _launch("residual_ssq", f"mg_residual_ssq_{_SUFFIX[u.dtype]}", u.device,
            u.data_ptr(), f.data_ptr(), _ptr(r), partials.data_ptr(),
            ssq.data_ptr(), nr, nc, 1.0 / dx**2, 1.0 / dy**2,
            outputs=(ssq, r))
    return ssq, r


# ------------------------------------------------------- Euler RHS

# solver and wavespeed codes of csrc/euler_rhs.cu
_EULER_SOLVER = {"roe": 0, "hllc": 1, "rusanov": 2}
_EULER_WS = {"roe": 0, "spectral": 1}
_RIEMANN = {"roe": riemann.roe, "hllc": riemann.hllc,
            "rusanov": riemann.rusanov}


def check_euler_variant(solver: str, rusanov_wavespeed: str) -> None:
    """Raise for a flux or wavespeed name the RHS does not have."""
    if solver not in _EULER_SOLVER:
        raise ValueError(f"unknown solver {solver!r} "
                         f"({' | '.join(_EULER_SOLVER)})")
    if rusanov_wavespeed not in _EULER_WS:
        raise ValueError(f"unknown wavespeed {rusanov_wavespeed!r} "
                         f"({' | '.join(_EULER_WS)})")


def euler_rhs_fused_plain(q, gamma: float, dx: float, solver: str = "hllc",
                          rusanov_wavespeed: str = "roe"):
    """Plain twin of euler_rhs_fused, and the torch RHS of
    models.euler1d.make_rhs: mirror WENO-5 states (ops.weno), Euler fluxes,
    the Riemann flux (ops.riemann), divergence."""
    qL = weno.reconstruct_left(q, "mirror")    # (3, nx+1)
    qR = weno.reconstruct_right(q, "mirror")   # (3, nx+1)
    fL = riemann.flux(qL, gamma)
    fR = riemann.flux(qR, gamma)
    extra = {}
    if solver == "rusanov":
        extra["wavespeed"] = rusanov_wavespeed
        if rusanov_wavespeed == "spectral":
            # wavespeed2 parity: the reference evaluates the spectral
            # radius at CELL centres, not the reconstructed interfaces
            extra["ps"] = riemann.rusanov_wavespeed2(q, gamma)
    f = _RIEMANN[solver](qL, qR, fL, fR, gamma, **extra)
    return -(f[:, 1:] - f[:, :-1]) / dx


def euler_rhs_fused(q, gamma: float, dx: float, solver: str = "hllc",
                    rusanov_wavespeed: str = "roe"):
    """The whole 1D Euler RHS of the (3, nx) conservative state in one
    kernel pass (csrc/euler_rhs.cu): mirror WENO-5 interface states, Euler
    fluxes, roe | hllc | rusanov flux (rusanov_wavespeed roe | spectral),
    -(f[j+1] - f[j]) / dx.  q: contiguous fp32 or fp64, nx >= 3."""
    check_euler_variant(solver, rusanov_wavespeed)
    if q.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"euler_rhs_fused takes an fp32 or fp64 state, got "
                        f"{q.dtype}")
    if q.dim() != 2 or q.shape[0] != 3:
        raise ValueError(f"euler_rhs_fused takes a (3, nx) state, got "
                         f"{tuple(q.shape)}")
    nx = q.shape[1]
    if nx < 3:
        raise ValueError(f"euler_rhs_fused needs nx >= 3 (the mirror pads "
                         f"read u_(nx-3)), got {nx}")
    if _on_cpu("euler_rhs_fused", q):
        return euler_rhs_fused_plain(q, gamma, dx, solver, rusanov_wavespeed)
    out = torch.empty_like(q)
    _launch("euler_rhs", f"euler_rhs_{_SUFFIX[q.dtype]}", q.device,
            q.data_ptr(), out.data_ptr(), nx, float(gamma), float(dx),
            _EULER_SOLVER[solver], _EULER_WS[rusanov_wavespeed],
            outputs=(out,))
    return out


# ------------------------------------------------------- packed cavity stage

def _shift(a, da: int, db: int):
    """out[i, j] = a[i+da, j+db] in range, else 0: pad and slice, never a
    roll (cavity_fused.py:55-63)."""
    p = F.pad(a, (max(-db, 0), max(db, 0), max(-da, 0), max(da, 0)))
    i, j = max(da, 0), max(db, 0)
    return p[i:i + a.shape[0], j:j + a.shape[1]]


def _vshift(v, d: int, L: int, corner: float):
    """Wall-vector shift out[k] = v[k+d], 0 past the buffer, and `corner` at
    the slot next to the adjacent wall: k = L-1 for d = +1, k = 0 for
    d = -1 (cavity_fused.py:66-77)."""
    out = F.pad(v, (max(-d, 0), max(d, 0)))[max(d, 0):max(d, 0) + v.shape[0]]
    k = torch.arange(v.shape[0], device=v.device)
    exposed = (k == L - 1) if d > 0 else (k == 0)
    return torch.where(exposed, corner, out)


def _lid(dy: float, bc_order: int) -> float:
    """The moving lid's wall term, also the value at both lid corners."""
    return -3.0 / dy if bc_order == 2 else -2.0 / dy


def _cavity_wall_vectors(s, m: int, n: int, dx: float, dy: float,
                        bc_order: int):
    """(rl, rh, cl, ch): the wall vorticity of the padded interior psi s
    (Hoffmann or Jensen, lid_driven_cavity.jl:24-51), rl / rh over columns
    (the walls i = 0 / nx), cl / ch over rows (j = 0 / ny, the lid); cl and
    ch are 0 at rows >= m (cavity_fused.py:129-151)."""
    lid = _lid(dy, bc_order)
    if bc_order == 1:
        rl = -2.0 * s[0, :] / dx**2
        rh = -2.0 * s[m - 1, :] / dx**2
        cl = -2.0 * s[:, 0] / dy**2
        ch = -2.0 * s[:, n - 1] / dy**2 + lid
    else:
        rl = (-4.0 * s[0, :] + 0.5 * s[1, :]) / dx**2
        rh = (-4.0 * s[m - 1, :] + 0.5 * s[m - 2, :]) / dx**2
        cl = (-4.0 * s[:, 0] + 0.5 * s[:, 1]) / dy**2
        ch = (-4.0 * s[:, n - 1] + 0.5 * s[:, n - 2]) / dy**2 + lid
    rows = torch.arange(s.shape[0], device=s.device) < m
    return rl, rh, torch.where(rows, cl, 0.0), torch.where(rows, ch, 0.0)


def _cavity_rhs(w, s, walls, m: int, n: int, dx: float, dy: float, re,
                lid: float):
    """-J(w, s) + lap(w)/re on the padded interior, w's wall values from the
    wall vectors, psi's walls zero (cavity_fused.py:153-196)."""
    rl, rh, cl, ch = walls
    ai = torch.arange(w.shape[0], device=w.device)[:, None]
    bj = torch.arange(w.shape[1], device=w.device)[None, :]
    a_first, a_last = ai == 0, ai == m - 1
    b_first, b_last = bj == 0, bj == n - 1
    rlr, rhr, clc, chc = rl[None, :], rh[None, :], cl[:, None], ch[:, None]

    wE = torch.where(a_last, rhr, _shift(w, 1, 0))
    wW = torch.where(a_first, rlr, _shift(w, -1, 0))
    wN = torch.where(b_last, chc, _shift(w, 0, 1))
    wS = torch.where(b_first, clc, _shift(w, 0, -1))
    # row-wall correction first, then the column-wall one: the y-walls own
    # the corners
    wNE = torch.where(a_last, _vshift(rh, 1, n, lid)[None, :], _shift(w, 1, 1))
    wNE = torch.where(b_last, _vshift(ch, 1, m, lid)[:, None], wNE)
    wSE = torch.where(a_last, _vshift(rh, -1, n, 0.0)[None, :],
                      _shift(w, 1, -1))
    wSE = torch.where(b_first, _vshift(cl, 1, m, 0.0)[:, None], wSE)
    wNW = torch.where(a_first, _vshift(rl, 1, n, lid)[None, :],
                      _shift(w, -1, 1))
    wNW = torch.where(b_last, _vshift(ch, -1, m, lid)[:, None], wNW)
    wSW = torch.where(a_first, _vshift(rl, -1, n, 0.0)[None, :],
                      _shift(w, -1, -1))
    wSW = torch.where(b_first, _vshift(cl, -1, m, 0.0)[:, None], wSW)

    sE, sW = _shift(s, 1, 0), _shift(s, -1, 0)
    sN, sS = _shift(s, 0, 1), _shift(s, 0, -1)
    sNE, sSW = _shift(s, 1, 1), _shift(s, -1, -1)
    sNW, sSE = _shift(s, -1, 1), _shift(s, 1, -1)

    gg = 1.0 / (4.0 * dx * dy)
    j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW)
    j2 = (wE * (sNE - sSE) - wW * (sNW - sSW)
          - wN * (sNE - sNW) + wS * (sSE - sSW))
    j3 = (wNE * (sN - sE) - wSW * (sW - sS)
          - wNW * (sN - sW) + wSE * (sE - sS))
    jac = gg * (j1 + j2 + j3) / 3.0
    lap = (wE - 2 * w + wW) / dx**2 + (wN - 2 * w + wS) / dy**2
    return -jac + lap / re


def cavity_fused_stage_plain(w, wt, s, walls, stage: int, dt: float,
                             dx: float, dy: float, re, m: int, n: int,
                             bc_order: int):
    """Plain twin of cavity_fused_stage: the JAX package's rhs, the SSP-RK3
    combine of stage `stage` and the validity mask, then the next wall
    vectors from s (cavity_fused.py:153-215).  re: a float or a 0-d
    tensor (autograd differentiates the twin in it)."""
    r = _cavity_rhs(wt, s, walls, m, n, dx, dy, re, _lid(dy, bc_order))
    if stage == 1:
        raw = w + dt * r
    elif stage == 2:
        raw = 0.75 * w + 0.25 * wt + 0.25 * dt * r
    else:
        raw = (w + 2.0 * wt + 2.0 * dt * r) / 3.0
    valid = ((torch.arange(w.shape[0], device=w.device) < m)[:, None]
             & (torch.arange(w.shape[1], device=w.device) < n)[None, :])
    return (torch.where(valid, raw, 0.0),
            _cavity_wall_vectors(s, m, n, dx, dy, bc_order))


# the stage kernel's walk (csrc/cavity_stage.cu): rows a walker, walkers a
# block, bytes a lane loads of a row, lanes a walker
CAVITY_STAGE_CONSTANTS = ("rows", "walkers", "vec_bytes", "lanes")


# the backward kernel's walk: rows a walker, walkers a block (exported
# after the forward's)
CAVITY_STAGE_BACKWARD_CONSTANTS = ("rows", "walkers")


def cavity_stage_geometry() -> dict:
    """The stage kernel's walk constants, as the library exports them
    (cavity_stage_constant); builds the CUDA library."""
    lib = _cuda_build.load_library()
    return {name: lib.cavity_stage_constant(i)
            for i, name in enumerate(CAVITY_STAGE_CONSTANTS)}


def cavity_stage_backward_geometry() -> dict:
    """The backward kernel's walk constants, as the library exports them;
    builds the CUDA library."""
    lib = _cuda_build.load_library()
    first = len(CAVITY_STAGE_CONSTANTS)
    return {name: lib.cavity_stage_constant(first + i)
            for i, name in enumerate(CAVITY_STAGE_BACKWARD_CONSTANTS)}


def cavity_fused_stage(w, wt, s, walls, stage: int, dt: float, dx: float,
                       dy: float, re: float, m: int, n: int, bc_order: int,
                       re_t=None):
    """One SSP-RK3 stage of the packed cavity in one kernel pass
    (csrc/cavity_stage.cu): r = -J(wt, s) + lap(wt)/re on the (m, n)
    logical interior of the (P, Q) buffers, wt's walls from the vectors
    walls = (rl, rh, cl, ch) (lengths Q, Q, P, P); the stage's combine of
    w (the step's start), wt and r, 0 in the padding; and the next wall
    vectors from s.  Stage 1 takes wt = w.  Returns (wt_new, walls_new),
    new tensors; matches cavity_fused_stage_plain.

    re is the float the kernel takes; re_t, if given, a 0-d tensor of the
    same value (its caller reads it on the host) in which the result is
    differentiated.  Under grad mode, with an input or re_t that requires
    grad, the call is _CavityStage: this launch forward, the backward
    kernel (cavity_fused_stage_backward) backward.  On the CPU autograd
    differentiates the twin."""
    tensors = (w, wt, s, *walls)
    if w.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != w.dtype for t in tensors):
        raise TypeError("cavity_fused_stage takes fp32 or fp64 tensors of "
                        f"one dtype, got {[str(t.dtype) for t in tensors]}")
    _check_stage_shapes("cavity_fused_stage", w, wt, s, walls, stage, m, n,
                        bc_order)
    if re_t is not None and (not isinstance(re_t, torch.Tensor) or
                             re_t.dim() != 0 or
                             not re_t.is_floating_point()):
        raise ValueError("cavity_fused_stage: re_t must be a 0-d floating "
                         f"tensor, got {re_t!r}")
    if _on_cpu("cavity_fused_stage", *tensors):
        return cavity_fused_stage_plain(w, wt, s, walls, stage, dt, dx, dy,
                                        re if re_t is None else re_t, m, n,
                                        bc_order)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*tensors, re_t) if t is not None):
        out, *walls_out = _CavityStage.apply(
            w, wt, s, *walls, re_t, (stage, dt, dx, dy, re, m, n, bc_order))
        return out, tuple(walls_out)
    return _cavity_stage_launch(w, wt, s, walls, stage, dt, dx, dy, re, m, n,
                                bc_order)


def _check_stage_shapes(name, w, wt, s, walls, stage, m, n, bc_order):
    if w.dim() != 2 or wt.shape != w.shape or s.shape != w.shape:
        raise ValueError(f"{name} takes w, wt, s of one 2-D shape, "
                         f"got {[tuple(t.shape) for t in (w, wt, s)]}")
    P, Q = w.shape
    if [tuple(v.shape) for v in walls] != [(Q,), (Q,), (P,), (P,)]:
        raise ValueError(f"wall vectors of shapes "
                         f"{[tuple(v.shape) for v in walls]}, expected "
                         f"{[(Q,), (Q,), (P,), (P,)]}")
    if not (2 <= m <= P and 2 <= n <= Q):
        raise ValueError(f"logical interior {(m, n)} outside 2..{(P, Q)}")
    if stage not in (1, 2, 3) or bc_order not in (1, 2):
        raise ValueError(f"stage {stage} (1, 2, 3) or bc_order {bc_order} "
                         "(1, 2) out of range")


def _cavity_stage_launch(w, wt, s, walls, stage, dt, dx, dy, re, m, n,
                         bc_order):
    """Kernel 7 on checked CUDA tensors: one launch."""
    P, Q = w.shape
    out = torch.empty_like(w)
    walls_out = tuple(torch.empty_like(v) for v in walls)
    _launch("cavity_fused_stage", f"cavity_stage_{_SUFFIX[w.dtype]}",
            w.device, *(t.data_ptr() for t in (w, wt, s, *walls, out,
                                               *walls_out)),
            P, Q, m, n, stage, bc_order, float(dt), float(dx), float(dy),
            float(re), outputs=(out, *walls_out))
    return out, walls_out


class _CavityStage(torch.autograd.Function):
    """Kernel 7 with its backward kernel: forward cavity_fused_stage's
    launch, backward cavity_fused_stage_backward, on CUDA tensors; re_t a
    0-d tensor holding the launch's re, or None (no Re gradient)."""

    @staticmethod
    def forward(ctx, w, wt, s, rl, rh, cl, ch, re_t, args):
        ctx.args = args
        ctx.re_like = None if re_t is None else (re_t.dtype, re_t.device)
        ctx.save_for_backward(wt, s, rl, rh, cl, ch)
        out, walls = _cavity_stage_launch(w, wt, s, (rl, rh, cl, ch), *args)
        return (out, *walls)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, *h):
        wt, s, *walls = ctx.saved_tensors
        want_re = ctx.needs_input_grad[7]
        # the kernel reads g's rows 16 bytes at a time
        g = g.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        gw, gwt, gs, gwalls, gre = cavity_fused_stage_backward(
            wt, s, walls, g, tuple(v.contiguous() for v in h), *ctx.args,
            re_grad=want_re)
        if want_re:
            dtype, device = ctx.re_like
            gre = gre.to(device=device, dtype=dtype)
        return (gw, gwt, gs, *gwalls, gre, None)


# the stage's combine a w + b wt + c r: (a, b, c) with c a multiple of dt;
# stage 1 reads wt alone (it is w)
_STAGE_COEFFS = {1: (0.0, 1.0, 1.0), 2: (0.75, 0.25, 0.25),
                 3: (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)}


def _extended_w(wt, walls, m: int, n: int, lid: float):
    """W on the points [-1, P] x [-1, Q] (index (i+1, j+1) for point (i, j)):
    wt on the logical interior, the wall vectors on its one-node frame,
    the lid at the corners (-1, n) and (m, n), 0 elsewhere (the stage's
    view of wt, cavity_fused.py:153-180)."""
    rl, rh, cl, ch = walls
    P, Q = wt.shape
    e = wt.new_zeros((P + 2, Q + 2))
    e[1:m + 1, 1:n + 1] = wt[:m, :n]
    e[0, 1:n + 1] = rl[:n]
    e[m + 1, 1:n + 1] = rh[:n]
    e[1:m + 1, 0] = cl[:m]
    e[1:m + 1, n + 1] = ch[:m]
    e[0, n + 1] = e[m + 1, n + 1] = lid
    return e


def cavity_fused_stage_backward_plain(wt, s, walls, g, h, stage: int,
                                      dt: float, dx: float, dy: float, re,
                                      m: int, n: int, bc_order: int):
    """Plain version of cavity_fused_stage_backward: the adjoint of one
    stage as the explicit gather the kernel computes (not autograd).  With
    q = g on the logical interior (0 elsewhere), W wt extended by its
    walls (_extended_w), S s extended by 0, and (a, b, c) the stage's
    combine (_STAGE_COEFFS, c times dt), on the zero-extended grid where
    sum q J(W, S) = sum W J(S, q) = sum S J(q, W) holds:
      dW = c (-J(S, q) + lap(q)/re) on the interior and its frame: gwt =
           b q + dW on the interior (0 in the padding), the wall vectors'
           gradients on the frame (0 past the logical walls; the corners
           are constants);
      gs = -c J(q, W) on the buffer, plus h's share through the next wall
           vectors (rl_o = f(s[0], s[1]), rh_o, cl_o, ch_o);
      gw = a q (None at stage 1, where wt is w);
      gre = -c sum q lap(W) / re^2.
    J and lap are ops.arakawa's on the extended grids padded past any
    wrap.  Returns (gw, gwt, gs, (grl, grh, gcl, gch), gre)."""
    P, Q = wt.shape
    a_c, b_c, c_c = _STAGE_COEFFS[stage]
    c = c_c * dt
    rows = torch.arange(P, device=wt.device) < m
    cols = torch.arange(Q, device=wt.device) < n
    valid = rows[:, None] & cols[None, :]
    q = torch.where(valid, g, 0.0)
    # points (i, j) of [-2, P+1] x [-2, Q+1] at index (i+2, j+2)
    qz = F.pad(q, (2, 2, 2, 2))
    sz = F.pad(s, (2, 2, 2, 2))
    wz = F.pad(_extended_w(wt, walls, m, n, _lid(dy, bc_order)),
               (1, 1, 1, 1))
    d_w = -arakawa.jacobian(sz, qz, dx, dy) + \
        arakawa.laplacian(qz, dx, dy) / re
    d_s = -arakawa.jacobian(qz, wz, dx, dy)
    gwt = torch.where(valid, b_c * q + c * d_w[2:P + 2, 2:Q + 2], 0.0)
    gwalls = (torch.where(cols, c * d_w[1, 2:Q + 2], 0.0),
              torch.where(cols, c * d_w[m + 2, 2:Q + 2], 0.0),
              torch.where(rows, c * d_w[2:P + 2, 1], 0.0),
              torch.where(rows, c * d_w[2:P + 2, n + 2], 0.0))
    gs = c * d_s[2:P + 2, 2:Q + 2]
    # the next wall vectors' adjoint: f(s0, s1) = (k0 s0 + k1 s1) / h^2
    h_rl, h_rh, h_cl, h_ch = h
    k0, k1 = (-2.0, 0.0) if bc_order == 1 else (-4.0, 0.5)
    for row, hv, k in ((0, h_rl, k0), (1, h_rl, k1), (m - 1, h_rh, k0),
                       (m - 2, h_rh, k1)):
        if k:
            gs[row, :] += k * hv / dx**2
    for col, hv, k in ((0, h_cl, k0), (1, h_cl, k1), (n - 1, h_ch, k0),
                       (n - 2, h_ch, k1)):
        if k:
            gs[:m, col] += k * hv[:m] / dy**2
    lap_w = arakawa.laplacian(wz, dx, dy)[2:P + 2, 2:Q + 2]
    gre = -c * torch.sum(q * lap_w) / re**2
    return (None if stage == 1 else a_c * q), gwt, gs, gwalls, gre


def cavity_fused_stage_backward(wt, s, walls, g, h, stage: int, dt: float,
                                dx: float, dy: float, re: float, m: int,
                                n: int, bc_order: int, re_grad: bool = True):
    """The adjoint of cavity_fused_stage for the cotangents g (of the new
    interior) and h = (h_rl, h_rh, h_cl, h_ch) (of the next wall vectors):
    (gw, gwt, gs, (grl, grh, gcl, gch), gre), cavity_fused_stage_backward_
    plain's formulas; gw None at stage 1 (wt is w), gre a 0-d tensor of
    wt's dtype, or None with re_grad=False.  One launch of the backward
    kernel (csrc/cavity_stage.cu: the forward's warp walkers on 16-byte
    rows of g, wt and s, each output written by one thread), counted under
    cavity_stage_backward, with or without gre: the last of its blocks to
    finish adds their fp64 partial sums in a fixed order (no atomics on a
    value, so two calls agree bitwise) and resets the stream's completion
    counter (_fold_counters; concurrent calls on two streams use two
    buffers of them).  re: a float.  The
    kernel refuses (a launch error) Q not a multiple of 16 bytes' worth of
    elements and wt, s or g not 16-byte aligned."""
    tensors = (wt, s, *walls, g, *h)
    if wt.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != wt.dtype for t in tensors):
        raise TypeError("cavity_fused_stage_backward takes fp32 or fp64 "
                        "tensors of one dtype, got "
                        f"{[str(t.dtype) for t in tensors]}")
    _check_stage_shapes("cavity_fused_stage_backward", wt, g, s, walls,
                        stage, m, n, bc_order)
    if [tuple(v.shape) for v in h] != [tuple(v.shape) for v in walls]:
        raise ValueError(f"cavity_fused_stage_backward: h of shapes "
                         f"{[tuple(v.shape) for v in h]}, expected the "
                         f"wall vectors' {[tuple(v.shape) for v in walls]}")
    if _on_cpu("cavity_fused_stage_backward", *tensors):
        gw, gwt, gs, gwalls, gre = cavity_fused_stage_backward_plain(
            wt, s, walls, g, h, stage, dt, dx, dy, re, m, n, bc_order)
        return gw, gwt, gs, gwalls, gre if re_grad else None
    P, Q = wt.shape
    gw = None if stage == 1 else torch.empty_like(wt)
    gwt, gs = torch.empty_like(wt), torch.empty_like(wt)
    gwalls = tuple(torch.empty_like(v) for v in walls)
    partials = counters = gre = None
    if re_grad:
        k = _cuda_build.load_library().cavity_stage_backward_partials(P, Q)
        partials = torch.empty(k, dtype=torch.float64, device=wt.device)
        counters = _fold_counters(wt.device)
        gre = torch.empty((), dtype=wt.dtype, device=wt.device)
    _launch("cavity_stage_backward",
            f"cavity_stage_backward_{_SUFFIX[wt.dtype]}", wt.device,
            *(t.data_ptr() for t in tensors), _ptr(gw), gwt.data_ptr(),
            gs.data_ptr(), *(v.data_ptr() for v in gwalls),
            *(_ptr(t) for t in (partials, counters, gre)), P, Q, m, n, stage,
            bc_order, float(dt), float(dx), float(dy), float(re),
            outputs=(gw, gwt, gs, *gwalls, gre))
    return gw, gwt, gs, gwalls, gre


# ------------------------------------------------------- vortex stage passes
#
# The elementwise stage math of models/vortex.make_spectral_step_half
# (csrc/vortex_stage.cu): each pass is one launch on CUDA tensors and its
# twin on the CPU.  Under grad, with an input that requires grad, a CUDA
# call is an autograd Function whose backward is the pass's adjoint as
# torch ops (the *_backward_plain functions); the constants take no
# gradient.

_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _kx_major(name: str, *tensors) -> bool:
    """The memory order the 2-D operands of a pass share: False, each
    contiguous (row by row); True, each stored column by column (t.mT
    contiguous: the half spectra torch.fft.rfft2 returns on the GPU).
    Raises for any other layout, or for operands of mixed orders."""
    if all(t.is_contiguous() for t in tensors):
        return False
    if all(t.mT.is_contiguous() for t in tensors):
        return True
    raise ValueError(f"{name} takes operands of one memory order, row by row "
                     f"(contiguous) or column by column, got strides "
                     f"{[t.stride() for t in tensors]}")


def _refuse_stage_grad(name: str, *consts) -> None:
    if torch.is_grad_enabled() and any(
            c is not None and c.requires_grad for c in consts):
        raise ValueError(f"{name}: its constants take no gradient, and one "
                         "requires grad")


def _deriv_g(rowk, colk, nb: int, scale: float):
    """(4, rows, nb) real g = kx0/k2, ky, ky/k2, kx0, each times the mask
    rm cm and `scale`, in the kernel's operation order, from rowk (rows, 3)
    = (kx, kx0, rm) and colk (>= nb, 3) = (ky, kyg, cm)."""
    kx, kx0, rm = (rowk[:, k, None] for k in range(3))
    ky, kyg, cm = (colk[:nb, k] for k in range(3))
    k2 = kx * kx + kyg * kyg
    m = rm * cm
    return torch.stack([(kx0 / k2) * m, ky * m, (ky / k2) * m,
                        kx0 * m]) * scale


def vortex_derivs_half_plain(h, rowk, colk, nb: int, scale: float = 1.0,
                             cols: int | None = None, pad_rows: int = 0,
                             ky_fastest: bool = False):
    """Plain twin of vortex_derivs_half: g (_deriv_g), then the four spectra
    g (i H) = (-g Im H, g Re H) of H's first nb columns; with `cols`, those
    placed in the buffer layout (_to_buffer)."""
    g = _deriv_g(rowk, colk, nb, scale)
    hb = h[..., :nb]
    spectra = torch.complex(-(g * hb.imag), g * hb.real)
    if cols is None:
        return spectra
    return _to_buffer(spectra, cols, pad_rows, ky_fastest)


def _to_buffer(spectra, cols: int, pad_rows: int, ky_fastest: bool = False):
    """(4, rows, nb) spectra -> the buffer of vortex_derivs_half's buffer
    mode, (4, rows + pad_rows, cols) with ky_fastest, else (cols, 4, rows +
    pad_rows): buf[c, e, j] (buf[j, c, e]) = spectra[c, i, j] for j < nb,
    e = i below rows//2 and i + pad_rows from there (the 3/2 pad of
    spectral.pad_32_half), zeros elsewhere."""
    rows, nb = spectra.shape[-2:]
    split = rows // 2
    buf = spectra.new_zeros((4, rows + pad_rows, cols))
    buf[:, :split, :nb] = spectra[:, :split]
    buf[:, split + pad_rows:, :nb] = spectra[:, split:]
    return buf if ky_fastest else buf.permute(2, 0, 1).contiguous()


def _from_buffer(buf, rows: int, nb: int, pad_rows: int,
                 ky_fastest: bool = False):
    """The (4, rows, nb) spectra a buffer of _to_buffer holds."""
    planes = buf if ky_fastest else buf.permute(1, 2, 0)
    split = rows // 2
    return torch.cat([planes[:, :split, :nb],
                      planes[:, split + pad_rows:, :nb]], -2)


def vortex_derivs_half_backward_plain(gout, rowk, colk, hy: int,
                                      scale: float = 1.0):
    """The adjoint of vortex_derivs_half for the cotangent gout (4, rows,
    nb): gH = -i sum_c g_c gout_c on H's first nb columns, 0 on the rest
    of its hy (the complex autograd convention: conj(i g) = -i g)."""
    nb = gout.shape[-1]
    g = _deriv_g(rowk, colk, nb, scale)
    acc = g[0] * gout[0] + g[1] * gout[1] + g[2] * gout[2] + g[3] * gout[3]
    gh = gout.new_zeros((gout.shape[-2], hy))
    gh[:, :nb] = torch.complex(acc.imag, -acc.real)
    return gh


def _buffer_shape(rows: int, cols: int, pad_rows: int, ky_fastest: bool):
    return (4, rows + pad_rows, cols) if ky_fastest else \
        (cols, 4, rows + pad_rows)


def _derivs_launch(h, rowk, colk, nb: int, scale: float, cols=None,
                   pad_rows: int = 0, ky_fastest: bool = False, out=None):
    """One launch: the spectra in h's memory order (_kx_major), or with
    `cols` the buffer mode into `out` (a new buffer if None)."""
    rows, hy = h.shape
    sfx = _SUFFIX[rowk.dtype]
    if cols is not None:
        if out is None:
            out = h.new_empty(_buffer_shape(rows, cols, pad_rows,
                                            ky_fastest))
        si, sj = h.stride()
        _launch("vortex_derivs_half", f"vortex_derivs_half_buffer_{sfx}",
                h.device, h.data_ptr(), rowk.data_ptr(), colk.data_ptr(),
                out.data_ptr(), rows, si, sj, nb, cols, pad_rows,
                int(ky_fastest), float(scale), outputs=(out,))
        return out
    kx = _kx_major("vortex_derivs_half", h)
    out = h.new_empty((4, nb, rows)).mT if kx else h.new_empty((4, rows, nb))
    _launch("vortex_derivs_half", f"vortex_derivs_half_{sfx}", h.device,
            h.data_ptr(), rowk.data_ptr(), colk.data_ptr(), out.data_ptr(),
            rows, hy, nb, int(kx), float(scale), outputs=(out,))
    return out


class _VortexDerivs(torch.autograd.Function):
    """vortex_derivs_half's launch, differentiable in H."""

    @staticmethod
    def forward(ctx, h, rowk, colk, nb, scale, cols, pad_rows, ky_fastest):
        ctx.save_for_backward(rowk, colk)
        ctx.args = (h.shape[-1], scale)
        ctx.buffer = None if cols is None else (h.shape[0], nb, pad_rows,
                                                ky_fastest)
        return _derivs_launch(h, rowk, colk, nb, scale, cols, pad_rows,
                              ky_fastest)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        rowk, colk = ctx.saved_tensors
        if ctx.buffer is not None:
            g = _from_buffer(g, *ctx.buffer)
        return (vortex_derivs_half_backward_plain(g, rowk, colk, *ctx.args),
                None, None, None, None, None, None, None)


def vortex_derivs_half(h, rowk, colk, nb: int, scale: float = 1.0,
                       cols: int | None = None, pad_rows: int = 0,
                       ky_fastest: bool = False, out=None):
    """The four derivative half spectra psi_x, w_y, psi_y, w_x of the
    vorticity half spectrum H in one pass (csrc/vortex_stage.cu): out[c] =
    g_c (i H[:, :nb]), (4, rows, nb), g_c = kx0/k2, ky, ky/k2, kx0 times the
    mask rm cm and `scale`, k2 = kx^2 + kyg^2, built from rowk (rows, 3) =
    (kx, kx0, rm) and colk (>= nb, 3) = (ky, kyg, cm).  h: (rows, hy)
    complex64 or complex128, a half spectrum or a rank's row slab of one;
    rowk, colk: of h's real dtype, contiguous; 1 <= nb <= hy.  On the GPU
    h is contiguous or stored column by column (torch.fft.rfft2's
    output there), and the spectra come in h's order.

    The buffer mode (`cols` given, nb <= cols): the spectra in the layout
    of the step's cuFFT plans (ops/fft_plans.HalfInverse), a complex
    buffer (cols, 4, rows + pad_rows), kx fastest, or with ky_fastest (4,
    rows + pad_rows, cols): buf[j, c, e] (buf[c, e, j]) = out[c, i, j] for
    j < nb, e = i below rows//2 and i + pad_rows from there, and every
    other element 0 (_to_buffer).  Written into `out` (that shape,
    contiguous; not under grad), else into a new buffer; h then takes any
    strides.  ps23: ky fastest, pad_rows = 0, cols = the inverse's row
    pitch (hy rounded up to 16); ps32: kx fastest, cols = nye//2+1,
    pad_rows = nxe - nx, nb = ny//2 (spectral.pad_32_half drops the
    Nyquist column).

    Matches vortex_derivs_half_plain bitwise."""
    if h.dtype not in _REAL_OF or rowk.dtype != _REAL_OF[h.dtype] or \
            colk.dtype != rowk.dtype:
        raise TypeError(f"vortex_derivs_half takes a complex64 or complex128 "
                        f"H and constants of its real dtype, got {h.dtype}, "
                        f"{rowk.dtype}, {colk.dtype}")
    if h.dim() != 2 or not 1 <= nb <= h.shape[1] or \
            tuple(rowk.shape) != (h.shape[0], 3) or colk.dim() != 2 or \
            colk.shape[0] < nb or colk.shape[1] != 3:
        raise ValueError(f"vortex_derivs_half: H (rows, hy), rowk (rows, 3), "
                         f"colk (>= nb, 3), 1 <= nb <= hy; got "
                         f"{tuple(h.shape)}, {tuple(rowk.shape)}, "
                         f"{tuple(colk.shape)}, nb={nb}")
    track = torch.is_grad_enabled() and h.requires_grad
    if cols is None:
        if out is not None or pad_rows or ky_fastest:
            raise ValueError("vortex_derivs_half: out, pad_rows and "
                             "ky_fastest belong to the buffer mode (cols)")
    else:
        shape = _buffer_shape(h.shape[0], cols, pad_rows, ky_fastest)
        if cols < nb or pad_rows < 0:
            raise ValueError(f"vortex_derivs_half: the buffer mode takes "
                             f"cols >= nb and pad_rows >= 0, got cols={cols},"
                             f" nb={nb}, pad_rows={pad_rows}")
        if out is not None and (tuple(out.shape) != shape or
                                out.dtype != h.dtype or
                                not out.is_contiguous() or track):
            raise ValueError(f"vortex_derivs_half: out must be a contiguous "
                             f"{h.dtype} buffer {shape}, outside grad; got "
                             f"{out.dtype} {tuple(out.shape)}")
    if _on_cpu("vortex_derivs_half", rowk, colk,
               any_order=(h,) if out is None else (h, out)):
        res = vortex_derivs_half_plain(h, rowk, colk, nb, scale, cols,
                                       pad_rows, ky_fastest)
        return res if out is None else out.copy_(res)
    if cols is None:
        _kx_major("vortex_derivs_half", h)
    _refuse_stage_grad("vortex_derivs_half", rowk, colk)
    if track:
        return _VortexDerivs.apply(h, rowk, colk, nb, scale, cols, pad_rows,
                                   ky_fastest)
    return _derivs_launch(h, rowk, colk, nb, scale, cols, pad_rows,
                          ky_fastest, out)


def vortex_product_plain(phys):
    """Plain twin of vortex_product: phys[0] phys[1] - phys[2] phys[3]."""
    return phys[0] * phys[1] - phys[2] * phys[3]


def vortex_product_backward_plain(phys, g):
    """The adjoint of vortex_product for the cotangent g: the four
    products (g p1, g p0, -(g p3), -(g p2)), stacked."""
    return torch.stack([g * phys[1], g * phys[0], -(g * phys[3]),
                        -(g * phys[2])])


def _product_launch(phys):
    out = phys.new_empty(phys.shape[1:])
    _launch("vortex_product", f"vortex_product_{_SUFFIX[phys.dtype]}",
            phys.device, phys.data_ptr(), out.data_ptr(), out.numel(),
            outputs=(out,))
    return out


class _VortexProduct(torch.autograd.Function):
    """vortex_product's launch, differentiable in the fields."""

    @staticmethod
    def forward(ctx, phys):
        ctx.save_for_backward(phys)
        return _product_launch(phys)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (phys,) = ctx.saved_tensors
        return vortex_product_backward_plain(phys, g)


def vortex_product(phys):
    """The physical Jacobian p = a b - c d of the four real fields phys =
    (a, b, c, d), (4, ...) fp32 or fp64, in one pass
    (csrc/vortex_stage.cu).  Matches vortex_product_plain bitwise."""
    if phys.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vortex_product takes fp32 or fp64 fields, got "
                        f"{phys.dtype}")
    if phys.dim() < 2 or phys.shape[0] != 4 or phys[0].numel() == 0:
        raise ValueError(f"vortex_product takes four stacked fields (4, ...),"
                         f" got {tuple(phys.shape)}")
    if _on_cpu("vortex_product", phys):
        return vortex_product_plain(phys)
    if torch.is_grad_enabled() and phys.requires_grad:
        return _VortexProduct.apply(phys)
    return _product_launch(phys)


def vortex_cn_combine_plain(a, h, r, j0, b, j1):
    """Plain twin of vortex_cn_combine: a H + r j0 + b j1, or a H + b j1
    with r and j0 None, summed left to right."""
    out = a * h
    if j0 is not None:
        out = out + r * j0
    return out + b * j1


def vortex_cn_combine_backward_plain(a, r, b, g):
    """The adjoint of vortex_cn_combine in H, j0 and j1 for the cotangent
    g: the real scalings (a g, r g, b g), r g None without r."""
    return a * g, None if r is None else r * g, b * g


def _combine_launch(a, h, r, j0, b, j1):
    out = torch.empty_like(h)
    _launch("vortex_cn_combine",
            f"vortex_cn_combine_{_SUFFIX[a.dtype]}", h.device,
            a.data_ptr(), h.data_ptr(), _ptr(r), _ptr(j0), b.data_ptr(),
            j1.data_ptr(), out.data_ptr(), h.numel(), outputs=(out,))
    return out


class _VortexCombine(torch.autograd.Function):
    """vortex_cn_combine's launch, differentiable in H, j0 and j1."""

    @staticmethod
    def forward(ctx, a, h, r, j0, b, j1):
        ctx.save_for_backward(a, r, b)
        return _combine_launch(a, h, r, j0, b, j1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, r, b = ctx.saved_tensors
        gh, gj0, gj1 = vortex_cn_combine_backward_plain(a, r, b, g)
        need = ctx.needs_input_grad
        return (None, gh if need[1] else None, None,
                gj0 if need[3] else None, None, gj1 if need[5] else None)


def vortex_cn_combine(a, h, r, j0, b, j1):
    """One RK3/CN stage update of the half spectrum in one pass
    (csrc/vortex_stage.cu): a H + r j0 + b j1, or a H + b j1 at stage 1
    (r and j0 None), in the twin's order.  a, r, b: the stage's real
    tables (models/vortex._cn_consts), of H's shape and real dtype; H, j0,
    j1: complex64 or complex128 of one shape.  On the GPU every operand is
    contiguous, or every one stored column by column (_kx_major), and the
    result comes in their order.  Matches vortex_cn_combine_plain
    bitwise."""
    if (r is None) != (j0 is None):
        raise ValueError("vortex_cn_combine takes r and j0 together")
    waves = [t for t in (h, j0, j1) if t is not None]
    tables = [t for t in (a, r, b) if t is not None]
    if h.dtype not in _REAL_OF or any(t.dtype != h.dtype for t in waves) or \
            any(t.dtype != _REAL_OF[h.dtype] for t in tables):
        raise TypeError(f"vortex_cn_combine takes complex64 or complex128 "
                        f"spectra and tables of their real dtype, got "
                        f"{[str(t.dtype) for t in (*waves, *tables)]}")
    if any(t.shape != h.shape for t in (*waves, *tables)) or h.numel() == 0:
        raise ValueError(f"vortex_cn_combine takes tensors of one non-empty "
                         f"shape, got "
                         f"{[tuple(t.shape) for t in (*waves, *tables)]}")
    if _on_cpu("vortex_cn_combine", any_order=(*waves, *tables)):
        return vortex_cn_combine_plain(a, h, r, j0, b, j1)
    _kx_major("vortex_cn_combine", *waves, *tables)
    _refuse_stage_grad("vortex_cn_combine", a, r, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in waves):
        return _VortexCombine.apply(a, h, r, j0, b, j1)
    return _combine_launch(a, h, r, j0, b, j1)


def vortex_truncate_32_plain(jf, table):
    """Plain twin of vortex_truncate_32: spectral.truncate_32_half(jf, nx,
    ny) * table, (nx, ny//2+1) = table's shape."""
    from cfd_julia_torch.ops import spectral

    nx, hy = table.shape
    return spectral.truncate_32_half(jf, nx, 2 * (hy - 1)) * table


def vortex_truncate_32_backward_plain(g, table, nxe: int, hye: int):
    """The adjoint of vortex_truncate_32 for the cotangent g (nx, hy): g t
    scattered back to the (nxe, hye) fine spectrum, to rows r(i) of the
    columns below ny/2 and, conjugated, to rows (nxe - r(i)) % nxe of
    column ny/2; 0 elsewhere."""
    nx, hy = table.shape
    hx, hc = nx // 2, hy - 1
    gm = g * table
    r = torch.cat([torch.arange(hx, device=g.device),
                   torch.arange(nxe - hx, nxe, device=g.device)])
    gjf = gm.new_zeros((nxe, hye))
    gjf[r, :hc] = gm[:, :hc]
    gjf[(nxe - r) % nxe, hc] = torch.conj(gm[:, hc])
    return gjf


def _truncate_launch(jf, table):
    """One launch; the Jacobian in the table's memory order."""
    nx, hy = table.shape
    kx = _kx_major("vortex_truncate_32", table)
    out = torch.empty((hy, nx), dtype=jf.dtype, device=jf.device).mT if kx \
        else torch.empty((nx, hy), dtype=jf.dtype, device=jf.device)
    si, sj = jf.stride()
    _launch("vortex_truncate_32", f"vortex_truncate_32_{_SUFFIX[table.dtype]}",
            jf.device, jf.data_ptr(), table.data_ptr(), out.data_ptr(), nx,
            hy, jf.shape[0], si, sj, int(kx), outputs=(out,))
    return out


class _VortexTruncate(torch.autograd.Function):
    """vortex_truncate_32's launch, differentiable in jf."""

    @staticmethod
    def forward(ctx, jf, table):
        ctx.save_for_backward(table)
        ctx.fine = tuple(jf.shape)
        return _truncate_launch(jf, table)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        return vortex_truncate_32_backward_plain(g, table, *ctx.fine), None


def vortex_truncate_32(jf, table):
    """ps32's Jacobian from the 3/2 grid's rfft2 output in one pass
    (csrc/vortex_stage.cu, kernel 12): spectral.truncate_32_half(jf, nx,
    ny) times the real (nx, ny//2+1) table (the step's nyq/scale), read
    where jf lies, its conjugate-flipped Nyquist column included.  jf:
    (nxe, >= ny//2+1) complex64 or complex128, nxe >= nx, any strides;
    table: of jf's real dtype, nx and ny even, contiguous or stored column
    by column; the result comes in the table's memory order.  Matches
    vortex_truncate_32_plain bitwise."""
    if jf.dtype not in _REAL_OF or table.dtype != _REAL_OF[jf.dtype]:
        raise TypeError(f"vortex_truncate_32 takes a complex64 or complex128 "
                        f"jf and a table of its real dtype, got {jf.dtype}, "
                        f"{table.dtype}")
    if jf.dim() != 2 or table.dim() != 2 or table.shape[0] % 2 or \
            table.shape[1] < 2 or jf.shape[0] < table.shape[0] or \
            jf.shape[1] < table.shape[1]:
        raise ValueError(f"vortex_truncate_32: jf (nxe, hye), table (nx, "
                         f"ny//2+1) with nx even, nxe >= nx, hye >= ny//2+1;"
                         f" got {tuple(jf.shape)}, {tuple(table.shape)}")
    if _on_cpu("vortex_truncate_32", any_order=(jf, table)):
        return vortex_truncate_32_plain(jf, table)
    _kx_major("vortex_truncate_32", table)
    _refuse_stage_grad("vortex_truncate_32", table)
    if torch.is_grad_enabled() and jf.requires_grad:
        return _VortexTruncate.apply(jf, table)
    return _truncate_launch(jf, table)


# ------------------------------------------------------- precision tiers

# passes of the cavity's bf16 tiers: XLA's bf16_3x ("high") and one bf16
# pass ("default") on the TPU's matrix unit
TIER_PASSES = {"bf16x3": 3, "bf16x1": 1}
# csrc/tier_gemm.cu's tile: rows of C a block (an A operand's planes are
# padded to a multiple of it), columns of C a block (a B operand's) and k a
# ring stage (K's); the split pass takes multiples of TIER_BN
TIER_BM, TIER_BN, TIER_BK = 128, 64, 64
_TMA_MAP_BYTES = 128   # sizeof(CUtensorMap)


def _bf16_split(a):
    """(hi, lo) as fp32: hi = bf16(a), lo = bf16(a - hi), both rounded to
    nearest even; a - hi is exact in fp32."""
    hi = a.to(torch.bfloat16).to(torch.float32)
    return hi, (a - hi).to(torch.bfloat16).to(torch.float32)


def tier_matmul_plain(a, b, passes: int):
    """Plain twin of tier_matmul: the operands split with `.to(bfloat16)`,
    each pass's product taken in fp64 and rounded to fp32 (exact but for
    that rounding: a product of two bf16 values has 16 bits), and the
    passes summed in fp32 as hh + hl + lh (the JAX package's emulation of
    the TPU's tiers, tests/test_poisson2d.py:375-388)."""
    ah, al = _bf16_split(a)
    bh, bl = _bf16_split(b)

    def mm(x, y):
        return torch.matmul(x.double(), y.double()).float()

    if passes == 1:
        return mm(ah, bh)
    return mm(ah, bh) + mm(ah, bl) + mm(al, bh)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _planes(passes: int) -> int:
    return 2 if passes == 3 else 1


def tier_split_plain(x, transpose: bool, out_rows: int, kp: int,
                     passes: int):
    """Plain twin of tier_split: `_bf16_split` of x (of x.T for transpose)
    as bf16 planes, hi and, for 3 passes, lo, zero-padded: (planes,
    out_rows, kp)."""
    src = x.t() if transpose else x
    out = torch.zeros((_planes(passes), out_rows, kp), dtype=torch.bfloat16,
                      device=x.device)
    for p, part in zip(range(out.shape[0]), _bf16_split(src)):
        out[p, :src.shape[0], :src.shape[1]] = part
    return out


def tier_split(x, transpose: bool, out_rows: int, kp: int, passes: int,
               out=None):
    """The split pass of the tier GEMM (csrc/tier_gemm.cu `tier_split`):
    x's bf16 hi (and lo) planes, K-major and zero-padded, into `out`
    (bf16, (planes, out_rows, kp), contiguous) or a new buffer.  An A
    operand (M, K) is written as it is (transpose=False), a B operand
    (K, N) transposed, as (N, K).  x: fp32 (rows, cols) whose rows may be
    strided (x[1:-1, 1:-1] is read in place); out_rows and kp multiples of
    TIER_BN, at least x's extents.  Matches tier_split_plain bitwise."""
    if x.dtype != torch.float32:
        raise TypeError(f"tier_split takes an fp32 operand, got {x.dtype}")
    if x.dim() != 2 or x.numel() == 0 or passes not in (1, 3):
        raise ValueError(f"tier_split takes a non-empty 2-D operand and 1 "
                         f"or 3 passes, got {tuple(x.shape)}, {passes}")
    rows, cols = x.shape
    need = (cols, rows) if transpose else (rows, cols)
    if out_rows < need[0] or kp < need[1] or out_rows % TIER_BN or \
            kp % TIER_BN:
        raise ValueError(f"tier_split: planes ({out_rows}, {kp}) do not "
                         f"hold {need} in multiples of {TIER_BN}")
    shape = (_planes(passes), out_rows, kp)
    if out is not None and (out.dtype != torch.bfloat16 or
                            tuple(out.shape) != shape or
                            out.device != x.device or
                            not out.is_contiguous()):
        raise ValueError(f"tier_split writes a contiguous bf16 {shape} "
                         f"buffer on {x.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if x.device.type == "cpu":
        planes = tier_split_plain(x, transpose, out_rows, kp, passes)
        return planes if out is None else out.copy_(planes)
    if x.device.type != "cuda":
        raise ValueError(f"tier_split runs on cpu or cuda, not {x.device}")
    ld = x.stride(0) if rows > 1 else cols
    if (cols > 1 and x.stride(1) != 1) or ld < cols or \
            max(rows, cols, ld, out_rows, kp) >= 2**31:
        raise ValueError(f"tier_split reads rows of contiguous values with "
                         f"an int row stride, got strides {x.stride()}")
    if out is None:
        out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    _launch("tier_split", "tier_split", x.device, x.data_ptr(), rows, cols,
            ld, int(transpose), out.data_ptr(), out_rows, kp, passes,
            outputs=(out,))
    return out


def _tma_map(planes, role: str):
    """The TMA descriptor of an A or B operand's split buffer (planes,
    rows, kp), encoded on the host (csrc/tier_gemm.cu `tier_encode`, which
    knows its kernel's boxes), as a ctypes buffer."""
    desc = ctypes.create_string_buffer(_TMA_MAP_BYTES)
    err = _cuda_build.load_library().tier_encode(
        ctypes.addressof(desc), planes.data_ptr(),
        planes.shape[0] * planes.shape[1], planes.shape[2], "AB".index(role))
    if err != 0:
        raise RuntimeError(f"tier_encode failed: CUDA error {err} for "
                           f"planes {tuple(planes.shape)}")
    return desc


def tier_plane_extents(role: str, m: int, n: int) -> tuple[int, int]:
    """(rows, kp) of the bf16 planes that hold an (m, n) fp32 operand of
    the tier GEMM: as an A operand (m rows of n, rows padded to TIER_BM),
    or as a B operand transposed (n rows of m); kp padded to TIER_BK.  A
    TierPlan's field buffer has these extents."""
    if role == "A":
        return _round_up(m, TIER_BM), _round_up(n, TIER_BK)
    return _round_up(n, TIER_BN), _round_up(m, TIER_BK)


def _tier_op(c, table=None, scale=None):
    """op(C) as a solve writes it between two products: C / table (an fp32
    table of C's shape), or C * scale (a float, rounded to fp32 as torch
    rounds a Python scalar), or C."""
    if table is not None:
        return c / table
    if scale is not None:
        return c * scale
    return c


def tier_gemm_planes_plain(a, b, passes: int, role: str, table=None,
                           scale=None):
    """Plain twin of the tier GEMM's planes epilogue (TierPlan.gemm_into,
    csrc/tier_gemm.cu `tier_gemm_tn_planes`): op(tier_matmul_plain(a, b))
    as fp32 C (role "C") or as the planes tier_split_plain writes of it,
    an A operand's or a B operand's (transposed), of the extents
    tier_plane_extents gives."""
    c = _tier_op(tier_matmul_plain(a, b, passes), table, scale)
    if role == "C":
        return c
    return tier_split_plain(c, role == "B",
                            *tier_plane_extents(role, *c.shape), passes)


# the GEMM's epilogues (csrc/tier_gemm.cu `Epilogue`) and the ops on C
# (`Op`)
_TIER_EPILOGUE = {"C": 0, "A": 1, "B": 2}
_TIER_OP = {"none": 0, "divide": 1, "scale": 2}


def _tier_gemm(map_a, map_b, a_lo: int, b_lo: int, m: int, n: int, kp: int,
               passes: int, device, role: str = "C", out=None, table=None,
               scale=None):
    """The (m, n) product of split planes through their descriptors (the
    lo planes from rows a_lo of A's and b_lo of B's), op(C) stored by
    epilogue `role` into `out` (fp32 C, a new buffer if None, or checked
    planes: TierPlan.gemm_into): one tier_gemm launch."""
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=device)
    rows, ld = (m, n) if role == "C" else out.shape[1:]
    op = "divide" if table is not None else \
        "scale" if scale is not None else "none"
    _launch("tier_gemm", "tier_gemm_tn_planes", device,
            ctypes.addressof(map_a), ctypes.addressof(map_b), out.data_ptr(),
            m, n, ld, rows, kp // TIER_BK, a_lo, b_lo, passes,
            _TIER_EPILOGUE[role], None if table is None else table.data_ptr(),
            n, _TIER_OP[op], 1.0 if scale is None else float(scale),
            outputs=(out,))
    return out


class TierPlan:
    """A tier product with one operand fixed: const @ x (side "left") or
    x @ const ("right") for fp32 fields x of one shape, as a solver
    multiplies by its sine matrices.  On the GPU the constant is split,
    padded and laid out once, here, with its TMA descriptor; the field's
    planes go to a scratch buffer allocated here, whose address (and
    descriptor) is the same at every call and CUDA-graph replay.  A call is
    one tier_split launch (the field, read in place through its row stride)
    and one tier_gemm launch; a_planes and b_planes hold the operands'
    planes.  On the CPU a call is the twin, tier_matmul_plain, on the fp32
    operands.

    Differentiable in the field on every device (_TierPlanProduct): the
    backward is the tier product of the cotangent with the transposed
    constant, as JAX transposes a dot at its precision.  A symmetric
    constant (the sine matrices; checked once, here) is its own
    transpose, so the backward is this plan, its split constant and its
    scratch; another builds the transposed plan at its first backward.
    The constant takes no gradient: one that requires grad is refused."""

    def __init__(self, const, passes: int, side: str, shape):
        if const.dtype != torch.float32 or const.dim() != 2:
            raise TypeError(f"TierPlan takes a 2-D fp32 constant, got "
                            f"{const.dtype} {tuple(const.shape)}")
        if passes not in (1, 3) or side not in ("left", "right"):
            raise ValueError(f"TierPlan: passes 1 or 3 and side left or "
                             f"right, got {passes}, {side!r}")
        rows, cols = self.shape = tuple(shape)
        if side == "left":
            (m, k), n = const.shape, cols
            inner = rows
        else:
            (m, k), n = (rows, cols), const.shape[1]
            inner = const.shape[0]
        if inner != k or min(m, n, k) < 1:
            raise ValueError(f"TierPlan {side}: {tuple(const.shape)} and "
                             f"fields {self.shape} do not multiply")
        _refuse_const_grad(const)
        self.const, self.passes, self.side = const, passes, side
        self.mnk = (m, n, k)
        self.symmetric = (const.shape[0] == const.shape[1]
                          and bool(torch.equal(const, const.t())))
        self._transposed = self if self.symmetric else None
        if const.device.type == "cpu":
            return
        if m * n >= 2**31:
            raise ValueError(f"{(m, n, k)} exceeds the kernel's int index")
        mp, np_, kp = (_round_up(m, TIER_BM), _round_up(n, TIER_BN),
                       _round_up(k, TIER_BK))
        scratch = (_planes(passes), np_ if side == "left" else mp, kp)
        self._field = torch.empty(scratch, dtype=torch.bfloat16,
                                  device=const.device)
        if side == "left":
            self.a_planes = tier_split(const, False, mp, kp, passes)
            self.b_planes = self._field
        else:
            self.a_planes = self._field
            self.b_planes = tier_split(const, True, np_, kp, passes)
        self._map_a = _tma_map(self.a_planes, "A")
        self._map_b = _tma_map(self.b_planes, "B")
        self._lo = (mp, np_)

    def split(self, x) -> None:
        """x's planes into the scratch buffer (one tier_split launch)."""
        tier_split(x, self.side == "left", self._field.shape[1],
                   self._field.shape[2], self.passes, out=self._field)

    def gemm(self):
        """The product from the planes in place, fp32 C (one tier_gemm
        launch)."""
        return self.gemm_into("C")

    def gemm_into(self, role: str, out=None, *, table=None, scale=None):
        """The product from the planes in place, op(C) stored by the
        GEMM's own epilogue (one tier_gemm launch, csrc/tier_gemm.cu
        `tier_gemm_tn_planes`): role "C" fp32 C, "A" or "B" the bf16
        planes tier_split would write of op(C) for the next product's A
        operand or (transposed) B operand, every element of `out` (planes,
        rows, kp) written, its pad 0; out defaults to a new buffer of
        tier_plane_extents.  op: C / table for an fp32 table of C's shape,
        or C * scale.  Bitwise equal to tier_split of op(gemm()), torch's
        / and * for op.  On the card only (a plan's planes live there)."""
        m, n, _ = self.mnk
        dev = self.const.device
        if dev.type != "cuda":
            raise ValueError("TierPlan.gemm_into runs on the card; its plain "
                             "version is tier_gemm_planes_plain")
        if role not in _TIER_EPILOGUE:
            raise ValueError(f"gemm_into: role is one of "
                             f"{' | '.join(_TIER_EPILOGUE)}, got {role!r}")
        if table is not None:
            if table.dtype != torch.float32 or tuple(table.shape) != (m, n) \
                    or table.device != dev or not table.is_contiguous():
                raise ValueError(f"gemm_into takes a contiguous fp32 table "
                                 f"{(m, n)} on {dev}, got {table.dtype} "
                                 f"{tuple(table.shape)} on {table.device}")
        if role == "C":
            want, dtype = (m, n), torch.float32
        else:
            want = (_planes(self.passes), *tier_plane_extents(role, m, n))
            dtype = torch.bfloat16
        if out is None:
            out = torch.empty(want, dtype=dtype, device=dev)
        if tuple(out.shape) != want or out.dtype != dtype or \
                out.device != dev or not out.is_contiguous():
            raise ValueError(f"gemm_into {role} writes a contiguous {dtype} "
                             f"{want} buffer on {dev}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
        return _tier_gemm(self._map_a, self._map_b, *self._lo, m, n,
                          self.a_planes.shape[2], self.passes, dev, role,
                          out, table, scale)

    def transposed(self) -> "TierPlan":
        """The plan of the transposed constant on the same side, for
        fields of this plan's output shape: this plan for a symmetric
        constant, else built at the first call."""
        if self._transposed is None:
            m, n, _ = self.mnk
            self._transposed = TierPlan(self.const.t().contiguous(),
                                        self.passes, self.side, (m, n))
        return self._transposed

    def product(self, x):
        """The tier product of x, outside autograd."""
        if tuple(x.shape) != self.shape or x.device != self.const.device:
            raise ValueError(f"TierPlan takes fields {self.shape} on "
                             f"{self.const.device}, got {tuple(x.shape)} on "
                             f"{x.device}")
        if x.device.type == "cpu":
            return (tier_matmul_plain(self.const, x, self.passes)
                    if self.side == "left" else
                    tier_matmul_plain(x, self.const, self.passes))
        self.split(x)
        return self.gemm()

    def __call__(self, x):
        if torch.is_grad_enabled():
            _refuse_const_grad(self.const)
            if x.requires_grad:
                return _TierPlanProduct.apply(x, self)
        return self.product(x)


class _TierPlanProduct(torch.autograd.Function):
    """A TierPlan's product, linear in the field: the backward is the
    transposed plan's product of the cotangent (kernel 8 on the GPU, the
    twin on the CPU), never autograd of the split's bf16 casts, which
    would round the cotangent to bf16."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return plan.product(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return ctx.plan.transposed().product(g.contiguous()), None


class TierSolve:
    """A sine-matrix Poisson solve in a precision tier,
    u = R(L(R(L(f)) / den)) * scale with L(x) = left's product (sx @ x)
    and R(x) = right's (x @ sy), as the Poisson solves of the tiers write
    it (poisson/direct.sine_solve).  On the CPU a call is that composition
    of the plans' twins with torch's / and * between them.  On the GPU it
    is five launches: the split of f into left's field buffer, then each
    product's GEMM writing its op(C) straight into the next plan's field
    buffer as bf16 planes (TierPlan.gemm_into: R's A operand, L's B
    operand transposed, / den folded into the second), the last one fp32
    u with * scale folded in; no split, copy or elementwise launch sits
    between the GEMMs.  Bitwise equal to the plans' products with torch's
    / and * (`products`), on every device.

    Differentiable in f (_TierSolve): the backward runs the transposed
    products in autograd's order, * scale on the cotangent (a torch op),
    R, L, / den, R, L, chained the same way (one split, four GEMMs),
    bitwise autograd through `products`.  Square constants of the fields'
    shape (the solves'): every product maps that shape to itself."""

    def __init__(self, left: TierPlan, right: TierPlan, den, scale: float):
        if left.side != "left" or right.side != "right" or \
                left.passes != right.passes:
            raise ValueError("TierSolve takes a left and a right plan of one "
                             "tier")
        m, n, k = left.mnk
        mr, nr, kr = right.mnk
        if m != k or nr != kr or left.shape != right.shape or \
                (m, n) != left.shape or (mr, nr) != right.shape:
            raise ValueError(f"TierSolve: square constants of the fields' "
                             f"shape, got {left.mnk}, {right.mnk} on "
                             f"{left.shape}")
        if den.dtype != torch.float32 or tuple(den.shape) != left.shape or \
                den.device != left.const.device or not den.is_contiguous():
            raise ValueError(f"TierSolve takes a contiguous fp32 den "
                             f"{left.shape} on {left.const.device}, got "
                             f"{den.dtype} {tuple(den.shape)} on {den.device}")
        self.left, self.right, self.den = left, right, den
        self.scale, self.shape = scale, left.shape

    def products(self, f):
        """The solve as the plans' products with torch's / and * between
        them, differentiable through _TierPlanProduct: the CPU's route and
        the reference of the chained one."""
        coeff = self.right(self.left(f)) / self.den
        return self.right(self.left(coeff)) * self.scale

    def _chain(self, x, steps):
        """x through the (plan, op) steps, outside autograd: the plans'
        products and _tier_op on the CPU; on the GPU one split and a GEMM
        a step, each writing the next plan's field buffer."""
        if x.device.type == "cpu":
            for plan, op in steps:
                x = _tier_op(plan.product(x), **op)
            return x
        steps[0][0].split(x)
        for (plan, op), (nxt, _) in zip(steps, steps[1:]):
            plan.gemm_into("A" if nxt.side == "right" else "B", nxt._field,
                           **op)
        plan, op = steps[-1]
        return plan.gemm_into("C", **op)

    def forward(self, f):
        """The solve of f, outside autograd."""
        div = {"table": self.den}
        return self._chain(f, [(self.left, {}), (self.right, div),
                               (self.left, {}),
                               (self.right, {"scale": self.scale})])

    def backward(self, g):
        """The solve's adjoint applied to the cotangent g."""
        rt, lt = self.right.transposed(), self.left.transposed()
        div = {"table": self.den}
        return self._chain(g * self.scale, [(rt, {}), (lt, div), (rt, {}),
                                            (lt, {})])

    def __call__(self, f):
        if tuple(f.shape) != self.shape or f.device != self.den.device:
            raise ValueError(f"TierSolve takes fields {self.shape} on "
                             f"{self.den.device}, got {tuple(f.shape)} on "
                             f"{f.device}")
        if torch.is_grad_enabled():
            _refuse_const_grad(self.left.const)
            _refuse_const_grad(self.right.const)
            if self.den.requires_grad:
                raise ValueError("a TierSolve's den (folded into a GEMM's "
                                 "epilogue) takes no gradient, and this one "
                                 "requires grad")
            if f.requires_grad:
                return _TierSolve.apply(f, self)
        return self.forward(f)


class _TierSolve(torch.autograd.Function):
    """A TierSolve, linear in f: the backward is its adjoint, the chain of
    the transposed products (TierSolve.backward)."""

    @staticmethod
    def forward(ctx, f, solve):
        ctx.solve = solve
        return solve.forward(f)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return ctx.solve.backward(g.contiguous()), None


def _refuse_const_grad(const) -> None:
    """A plan's constant is split once, at build: it takes no gradient."""
    if const.requires_grad:
        raise ValueError("a TierPlan's constant (split once, when the plan "
                         "is built) takes no gradient, and this one "
                         "requires grad; differentiate in the field, or "
                         "multiply two fields with tier_matmul")


class _TierMatmul(torch.autograd.Function):
    """tier_matmul, bilinear: the gradients are the tier products
    g @ b^T and a^T @ g, of the forward's passes (JAX's transpose of a
    dot at its precision)."""

    @staticmethod
    def forward(ctx, a, b, passes):
        ctx.passes = passes
        ctx.save_for_backward(a, b)
        return _tier_matmul(a, b, passes)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _tier_matmul(g, b.t().contiguous(), ctx.passes)
        if ctx.needs_input_grad[1]:
            gb = _tier_matmul(a.t().contiguous(), g, ctx.passes)
        return ga, gb, None


def tier_matmul(a, b, passes: int):
    """C = A @ B in a precision tier of the TPU's matrix unit, fp32 in and
    out: passes=3 is XLA's bf16_3x (a_lo b_hi + a_hi b_lo + a_hi b_hi),
    passes=1 one bf16 product bf16(a) bf16(b), both accumulated in fp32.
    a: (M, K), b: (K, N), fp32.  On the GPU both operands are split
    (tier_split, two launches) and multiplied (tier_gemm, one launch);
    TierPlan splits a constant operand once instead.  On the CPU it runs
    the twin, so a tier computes the TPU's arithmetic on every device.
    Differentiable in a and b on every device (_TierMatmul): the
    gradients are tier products of the cotangent."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"tier_matmul takes fp32 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            a.numel() == 0 or b.numel() == 0:
        raise ValueError(f"tier_matmul takes (M, K) @ (K, N) with M, N, K "
                         f">= 1, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if passes not in (1, 3):
        raise ValueError(f"tier_matmul: passes must be 1 or 3, got {passes}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _TierMatmul.apply(a, b, passes)
    return _tier_matmul(a, b, passes)


def _tier_matmul(a, b, passes: int):
    """tier_matmul on checked operands, outside autograd."""
    if _on_cpu("tier_matmul", a, b):
        return tier_matmul_plain(a, b, passes)
    (m, k), n = a.shape, b.shape[1]
    if m * n >= 2**31 or b.numel() >= 2**31:
        raise ValueError(f"{(m, n, k)} exceeds the kernel's int index")
    mp, np_, kp = (_round_up(m, TIER_BM), _round_up(n, TIER_BN),
                   _round_up(k, TIER_BK))
    pa = tier_split(a, False, mp, kp, passes)
    pb = tier_split(b, True, np_, kp, passes)
    return _tier_gemm(_tma_map(pa, "A"), _tma_map(pb, "B"), mp, np_, m, n, kp,
                      passes, a.device)
