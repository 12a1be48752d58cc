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

Kernels (csrc/ file; TPU function replaced):
  arakawa_rhs_fused               arakawa_rhs.cu; arakawa_rhs_fused
  redblack_sweeps_fused           multigrid.cu;   redblack_sweeps_fused
  smooth_residual_restrict_fused  multigrid.cu;   smooth_residual_restrict_fused
  residual_restrict_fused         multigrid.cu;   residual_restrict_fused
  prolong_correct_smooth_fused    multigrid.cu;   prolong_correct_smooth_fused
  euler_rhs_fused                 euler_rhs.cu;   euler_rhs_fused

The multigrid kernels take bf16, fp32 or fp64 fields; bf16 computes in
fp32 and rounds once, at the output store (the TPU kernels' `_c32`
contract), and so do the bf16 twins.
"""
from __future__ import annotations

import torch

from cfd_julia_torch.ops import _cuda_build, arakawa, riemann, weno
from cfd_julia_torch.poisson import iterative

LAUNCHES = {"arakawa_rhs": 0, "redblack_sweeps": 0,
            "smooth_residual_restrict": 0, "residual_restrict": 0,
            "prolong_correct_smooth": 0, "euler_rhs": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_MG_DTYPES = tuple(_SUFFIX)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(name: str, *tensors) -> bool:
    """True for CPU tensors (take the twin); checks a CUDA call's
    preconditions; raises for any other device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if tensors[0].numel() >= 2**31:
        raise ValueError(f"{tensors[0].numel()} points exceed the kernel's "
                         "int index")
    return False


def _launch(name: str, symbol: str, device, *args) -> None:
    """Call a C launcher of the kernel library on `device`'s current
    stream; raise on a launch error; count the call."""
    lib = _cuda_build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        msg = lib.cfd_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1


# ------------------------------------------------------- Arakawa RHS

def arakawa_rhs_fused_plain(w, s, dx: float, dy: float, re: float):
    """Plain twin of arakawa_rhs_fused: ops.arakawa.vorticity_rhs."""
    return arakawa.vorticity_rhs(w, s, dx, dy, re)


def arakawa_rhs_fused(w, s, dx: float, dy: float, re: float):
    """Periodic vorticity RHS -J(w,s) + lap(w)/re over the whole (n_rows,
    n_cols) array, in one kernel pass (csrc/arakawa_rhs.cu); matches
    ops.arakawa.vorticity_rhs.  w, s: contiguous fp32 or fp64 tensors of
    one shape on one device, n_rows >= 3."""
    if w.dtype not in (torch.float32, torch.float64) or s.dtype != w.dtype:
        raise TypeError(
            f"arakawa_rhs_fused takes two fp32 or two fp64 tensors, got "
            f"{w.dtype} and {s.dtype}")
    if w.dim() != 2 or s.shape != w.shape:
        raise ValueError(
            f"arakawa_rhs_fused takes two 2-D tensors of one shape, got "
            f"{tuple(w.shape)} and {tuple(s.shape)}")
    n_rows, n_cols = w.shape
    if n_rows < 3:
        raise ValueError(f"arakawa_rhs_fused needs >= 3 rows, got {n_rows}")
    if _on_cpu("arakawa_rhs_fused", w, s):
        return arakawa_rhs_fused_plain(w, s, dx, dy, re)
    out = torch.empty_like(w)
    _launch("arakawa_rhs", f"arakawa_rhs_{_SUFFIX[w.dtype]}", w.device,
            w.data_ptr(), s.data_ptr(), out.data_ptr(), n_rows, n_cols,
            float(dx), float(dy), float(re))
    return out


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
            *u.shape, 1.0 / dx**2, 1.0 / dy**2, iters)
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
            _ptr(work), nr, nc, 1.0 / dx**2, 1.0 / dy**2, sweeps)
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
            1.0 / dx**2, 1.0 / dy**2)
    return fc


def prolong_correct_smooth_fused_plain(u, f, uc, dx: float, dy: float,
                                       sweeps: int, want_rms: bool = False):
    """Plain twin of prolong_correct_smooth_fused: reshape prolongation,
    masked add, the sweeps, and sum(r^2) of the result in the compute
    dtype."""
    from cfd_julia_torch.poisson import multigrid

    u32, f32 = _compute(u), _compute(f)
    mask = iterative.interior_mask(u.shape[0] - 1, u.shape[1] - 1,
                                   u32.dtype, u.device)
    v = u32 + multigrid.prolongation_reshape(_compute(uc)) * mask
    v = _sweeps_plain(v, f32, dx, dy, sweeps)
    if not want_rms:
        return v.to(u.dtype)
    r = iterative.residual_full(f32, v, dx, dy, mask)
    return v.to(u.dtype), torch.sum(r * r)


def prolong_correct_smooth_fused(u, f, uc, dx: float, dy: float,
                                 sweeps: int, want_rms: bool = False):
    """The V-cycle ascend edge (mg_N.jl:94-105): bilinear prolongation of
    the coarse correction uc, added at interior nodes, then `sweeps`
    red-black sweeps; == smooth(u + prolongation(uc) * imask, f, sweeps).
    want_rms=True also returns sum(residual(f, u_out)^2) over the interior
    as a 0-d fp32 tensor (fp64 for fp64 fields), summed in a fixed order
    (csrc/multigrid.cu, mg_prolong_correct_smooth_*: one pass over
    shared-memory tiles for up to 3 sweeps, and with the sum one
    one-block reduction)."""
    _check_level("prolong_correct_smooth_fused", u, f, uc, sweeps)
    if _on_cpu("prolong_correct_smooth_fused", u, f, uc):
        return prolong_correct_smooth_fused_plain(u, f, uc, dx, dy, sweeps,
                                                  want_rms)
    nr, nc = u.shape
    out = torch.empty_like(u)
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
            1.0 / dy**2, sweeps)
    return (out, ssq) if want_rms else out


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
            _EULER_SOLVER[solver], _EULER_WS[rusanov_wavespeed])
    return out
