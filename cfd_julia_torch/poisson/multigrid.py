"""Geometric multigrid V-cycle for the 2D Poisson equation (counterpart of
cfd_julia_tpu/poisson/multigrid.py, its single-device part).

Reference: 17_Poisson_Solver_Multigrid/mg.jl (2-level) and mg_N.jl
(N-level, the general case this module implements).  Transfer operators are
full-weighting restriction (Common.jl:21-48) and bilinear prolongation
(Common.jl:50-76); the smoother is red-black Gauss-Seidel, as in the JAX
package (the reference's lexicographic `gauss_seidel_mg` is serial).

Dispatch, as the cavity's `rhs_impl`: `MGConfig.impl` "auto" runs the CUDA
kernels of ops/cuda_kernels.py on a CUDA device and their plain PyTorch
twins on the CPU; "kernel" insists on the kernels (and raises on the CPU);
"torch" runs the twins on any device (the GPU comparison of
chip_smoke.py).

Level rule, a deliberate deviation from the TPU's: the JAX package fuses
the level edges only on levels of >= 512 points a side on a TPU
(`_pick_smoother`, `_use_fused`), because there a Pallas launch costs a
DMA set-up, and only while the sweeps fit its 8-row VMEM halo.  The CUDA
kernels have no such set-up, and their halo bounds only the sweeps of one
pass: an edge runs up to K = 3 sweeps in one pass over shared-memory tiles
(halo 2*3+2 = 8, the TPU's budget) and more sweeps as further passes of
the same kernel.  So here, unless `fused="off"` or `smoother="cheb"`,
EVERY level edge runs fused: the descend edge is one
`smooth_residual_restrict_fused` call for any v1 (one launch for v1 <= 3),
the ascend edge one `prolong_correct_smooth_fused` call (one launch, and
one more for the residual sum that the finest ascend edge returns for the
convergence check).  The coarsest-level smoother, and every smoother under
`fused="off"`, is `redblack_sweeps_fused` (one launch for up to 3 sweeps,
and for any sweeps on a level of at most 65^2 nodes).  A solve's rms0,
with fmg its right-hand side g, and an unfused cycle's check are one
`residual_ssq` call each (a streaming pass and its sum).

On a CUDA device `solve` captures one V-cycle, with its rms and
rms/rms0, as a CUDA graph (the JAX package's `lax.while_loop` body) and
replays it once a cycle; the host reads rms/rms0 once a cycle to test
convergence, as the eager loop does.  The graph is kept per solve
configuration (grid, dtype, device, spacing, the cycle's options), the
four most recent ones, so repeated solves replay it; a solve copies its
f, u0 and rms0 into the graph's static tensors.  A fused cycle's finest
ascend edge writes the graph's static u itself (its `out=`), so a replay
copies nothing back; an unfused one copies its u there.  fmg_start and
the rms0 residual run eagerly, once a solve.  graph=False keeps the eager
loop.
`solve(..., mesh=)` runs the multi-device solve on a mesh of ranks (the
last section).  Left out of the port: `cycle_dtype="bf16"` (its numerics
stall at 4096², ROADMAP A.0), and the TPU-only halo, tile and interpret
options.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cfd_julia_torch.ops import arakawa, cuda_kernels
from cfd_julia_torch.parallel import halo
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.poisson.iterative import (
    IterativeResult,
    _record,
    chebyshev_smooth,
    interior_mask,
    residual_full,
)
from cfd_julia_torch.stepping import loop


def _stencil(scale, like):
    """(1, 1, 3, 3) stencil scale * outer(v, v), v = (1, 2, 1), built by
    device arithmetic (exact: small integers times a power of two), since
    a CUDA graph capture forbids torch.tensor's copy from the host."""
    v = 2.0 - (torch.arange(3, dtype=like.dtype, device=like.device)
               - 1.0).abs()
    return (torch.outer(v, v) * scale)[None, None]


def restriction(r):
    """Full-weighting fine -> coarse transfer on node-centred grids
    (Common.jl:21-48). r: (nxf+1, nyf+1) -> (nxf//2+1, nyf//2+1).

    Interior = 3x3 full-weighting stencil at even fine nodes as a stride-2
    convolution; boundary rows/cols are direct injection of the
    coincident fine nodes.  In fp32 on CUDA the convolution runs in TF32
    unless torch.backends.cudnn.allow_tf32 is False."""
    k = _stencil(1.0 / 16.0, r)
    interior = F.conv2d(r[None, None], k, stride=2, padding=1)[0, 0, 1:-1, 1:-1]
    mid = torch.cat([r[2:-2:2, :1], interior, r[2:-2:2, -1:]], dim=1)
    return torch.cat([r[:1, ::2], mid, r[-1:, ::2]], dim=0)


def prolongation(uc):
    """Bilinear coarse -> fine transfer (Common.jl:50-76) as a transposed
    stride-2 convolution with the bilinear kernel; in fp32 on CUDA it runs
    in TF32 unless torch.backends.cudnn.allow_tf32 is False."""
    k = _stencil(0.25, uc)
    return F.conv_transpose2d(uc[None, None], k, stride=2, padding=1)[0, 0]


def _restrict_matrix_padded(nf, Pc, Pf, dtype, device=None):
    """(Pc, Pf) separable full-weighting rows, zero past the logical
    (nc+1, nf+1) corner: interior row c holds [1/4, 1/2, 1/4] at fine
    2c-1..2c+1; rows 0/nc inject the coincident boundary node (exact for
    interior-masked residuals).  The mesh solve's padded levels take it
    zero-extended; _restrict_matrix is the logical extent."""
    nc = nf // 2
    c = torch.arange(Pc, device=device)[:, None]
    fine = torch.arange(Pf, device=device)[None, :]
    d = fine - 2 * c
    w = torch.where(d == 0, 0.5,
                    torch.where(d.abs() == 1, 0.25, 0.0)).to(dtype)
    inject = (fine == 2 * c).to(dtype)
    m = torch.where((c == 0) | (c == nc), inject, w)
    return torch.where((c <= nc) & (fine <= nf), m, 0.0)


def _prolong_matrix_padded(nc, Pf, Pc, dtype, device=None):
    """(Pf, Pc) bilinear columns, zero past the logical (nf+1, nc+1)
    corner: fine even row 2c copies coarse c, fine odd row 2c+1 averages
    coarse c and c+1."""
    nf = 2 * nc
    fine = torch.arange(Pf, device=device)[:, None]
    c = torch.arange(Pc, device=device)[None, :]
    even = (fine == 2 * c).to(dtype)
    odd = ((fine == 2 * c + 1) | (fine == 2 * c - 1)).to(dtype) * 0.5
    m = torch.where(fine % 2 == 0, even, odd)
    return torch.where((fine <= nf) & (c <= nc), m, 0.0)


def _restrict_matrix(nf: int, dtype, device):
    return _restrict_matrix_padded(nf, nf // 2 + 1, nf + 1, dtype, device)


def _prolong_matrix(nc: int, dtype, device):
    return _prolong_matrix_padded(nc, 2 * nc + 1, nc + 1, dtype, device)


def restriction_matmul(r):
    """restriction as R_x @ r @ R_y^T (full fp32 on CUDA unless
    torch.backends.cuda.matmul.allow_tf32 is set)."""
    mx = _restrict_matrix(r.shape[0] - 1, r.dtype, r.device)
    my = _restrict_matrix(r.shape[1] - 1, r.dtype, r.device)
    return mx @ r @ my.T


def prolongation_matmul(uc):
    px = _prolong_matrix(uc.shape[0] - 1, uc.dtype, uc.device)
    py = _prolong_matrix(uc.shape[1] - 1, uc.dtype, uc.device)
    return px @ uc @ py.T


def _shift(a, di: int, dj: int):
    """Zero-fill shift: out[i, j] = a[i+di, j+dj] (in-range) else 0."""
    padded = F.pad(a, (max(-dj, 0), max(dj, 0), max(-di, 0), max(di, 0)))
    i0, j0 = max(di, 0), max(dj, 0)
    return padded[i0:i0 + a.shape[0], j0:j0 + a.shape[1]]


def restriction_reshape(r):
    """Full weighting via even/odd deinterleave: one reshape, then
    elementwise combines on quarter-size grids.  Exact for interior-masked
    residuals (zero boundary ring), like the conv form; no TF32 anywhere."""
    nc, mc = (r.shape[0] - 1) // 2, (r.shape[1] - 1) // 2
    q = F.pad(r, (0, 1, 0, 1)).reshape(nc + 1, 2, mc + 1, 2)
    ee = q[:, 0, :, 0]        # r[2c,   2d]
    eo = q[:, 0, :, 1]        # r[2c,   2d+1]
    oe = q[:, 1, :, 0]        # r[2c+1, 2d]
    oo = q[:, 1, :, 1]        # r[2c+1, 2d+1]
    out = (4.0 * ee
           + 2.0 * (oe + _shift(oe, -1, 0) + eo + _shift(eo, 0, -1))
           + oo + _shift(oo, -1, 0) + _shift(oo, 0, -1)
           + _shift(oo, -1, -1)) / 16.0
    c = torch.arange(nc + 1, device=r.device)[:, None]
    d = torch.arange(mc + 1, device=r.device)[None, :]
    boundary = (c == 0) | (c == nc) | (d == 0) | (d == mc)
    return torch.where(boundary, ee, out)


def prolongation_reshape(uc):
    """Bilinear prolongation by strided slices: fine (2c, 2d) copies coarse
    (c, d), even/odd and odd/even nodes average two coarse neighbours,
    odd/odd nodes four with weight 0.25.  No TF32 anywhere (the port's
    addition; the JAX `reshape` pair uses the conv prolongation)."""
    nc, mc = uc.shape[0] - 1, uc.shape[1] - 1
    out = uc.new_empty((2 * nc + 1, 2 * mc + 1))
    out[0::2, 0::2] = uc
    out[0::2, 1::2] = 0.5 * (uc[:, :-1] + uc[:, 1:])
    out[1::2, 0::2] = 0.5 * (uc[:-1, :] + uc[1:, :])
    out[1::2, 1::2] = 0.25 * (uc[:-1, :-1] + uc[:-1, 1:] + uc[1:, :-1]
                              + uc[1:, 1:])
    return out


_TRANSFERS = {
    "conv": (restriction, prolongation),
    "matmul": (restriction_matmul, prolongation_matmul),
    "reshape": (restriction_reshape, prolongation_reshape),
}


def _pick_transfers(name: str):
    """`auto` is the reshape pair on every device: O(n^2) slice arithmetic
    whose fp32 result does not depend on the TF32 flags."""
    return _TRANSFERS["reshape" if name == "auto" else name]


@dataclasses.dataclass(frozen=True)
class MGConfig:
    n_levels: int = 0          # 0 -> auto (coarsen to 2x2 cells)
    v1: int = 2                # pre-smoothing sweeps (mg_N.jl v1)
    v2: int = 2                # coarsest-level sweeps (v2)
    v3: int = 2                # post-smoothing sweeps (v3)
    tol: float = 1e-9
    max_cycles: int = 100
    transfers: str = "auto"    # auto (= reshape) | conv | matmul | reshape:
                               # the unfused edges' and FMG's transfers
    fused: str = "auto"        # auto | on | off: fused level-edge kernels
                               # (smooth+residual+restrict descend,
                               # prolong+correct+smooth ascend); auto = on
                               # at every level (see the module docstring)
    smoother: str = "auto"     # auto (red-black GS) | cheb (Chebyshev-
                               # Jacobi, plain PyTorch, never fused)
    fmg: bool = False          # full-multigrid (nested-iteration) start:
                               # coarsest-first, one V-cycle per level up
    cycle_dtype: str = "fp32"  # fp32 | mixed: the finest level stays in
                               # the input dtype, every coarser level runs
                               # bf16 storage with fp32 compute in-kernel
    impl: str = "auto"         # auto (CUDA kernels on a CUDA device, plain
                               # twins on the CPU) | kernel | torch


_CHOICES = {"transfers": ("auto", "conv", "matmul", "reshape"),
            "fused": ("auto", "on", "off"),
            "smoother": ("auto", "cheb"),
            "impl": ("auto", "kernel", "torch")}


def check_config(cfg: MGConfig) -> None:
    """Raise on an unknown or unported option: a typo'd name must never
    silently run the default."""
    if cfg.cycle_dtype == "bf16":
        raise NotImplementedError(
            "cycle_dtype='bf16' is not ported: its iterative refinement "
            "stalls at 4096^2 (ROADMAP A.0); use 'mixed' or 'fp32'")
    if cfg.cycle_dtype not in ("fp32", "mixed"):
        raise ValueError(f"unknown cycle_dtype {cfg.cycle_dtype!r} "
                         "(fp32 | mixed)")
    for field, allowed in _CHOICES.items():
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"unknown {field} {getattr(cfg, field)!r} "
                             f"({' | '.join(allowed)})")


def impl_choice(name: str, device: torch.device) -> str:
    """Resolve MGConfig.impl against the device the solve runs on."""
    if name == "auto":
        return "kernel" if device.type == "cuda" else "torch"
    if name == "kernel" and device.type != "cuda":
        raise ValueError(
            f"impl='kernel' runs the CUDA kernels and needs a CUDA device, "
            f"got {device}; use impl='torch' or 'auto'")
    return name


class _EdgeOps(NamedTuple):
    smooth_residual_restrict: object
    prolong_correct_smooth: object
    residual_restrict: object
    redblack_sweeps: object
    residual_ssq: object


_OPS = {
    "kernel": _EdgeOps(cuda_kernels.smooth_residual_restrict_fused,
                       cuda_kernels.prolong_correct_smooth_fused,
                       cuda_kernels.residual_restrict_fused,
                       cuda_kernels.redblack_sweeps_fused,
                       cuda_kernels.residual_ssq),
    "torch": _EdgeOps(cuda_kernels.smooth_residual_restrict_fused_plain,
                      cuda_kernels.prolong_correct_smooth_fused_plain,
                      cuda_kernels.residual_restrict_fused_plain,
                      cuda_kernels.redblack_sweeps_fused_plain,
                      cuda_kernels.residual_ssq_plain),
}


def smooth(u, f, dx: float, dy: float, iters: int, imask, impl: str):
    """`iters` smoothing sweeps (replaces gauss_seidel_mg): red-black GS
    through the kernel ("kernel") or its plain twin ("torch"), or the
    Chebyshev-Jacobi smoother ("cheb", which takes the interior mask)."""
    if impl == "cheb":
        return chebyshev_smooth(u, f, dx, dy, iters, imask)
    return _OPS[impl].redblack_sweeps(u, f, dx, dy, iters)


def _build_levels(nx, ny, dx, dy, n_levels):
    # BOTH axes must stay even at every coarsening: an anisotropic grid
    # whose axes have different 2-adic valuations (e.g. 20x16) would
    # otherwise produce an odd intermediate level
    max_levels = 1
    mx, my = nx, ny
    while mx % 2 == 0 and my % 2 == 0 and mx > 2 and my > 2:
        mx //= 2
        my //= 2
        max_levels += 1
    # <=0 -> auto (coarsen to 2x2 cells); an explicit request deeper than
    # the grid allows is clamped, not rejected, so a preset's pinned depth
    # composes with `run --nx` overrides on smaller grids
    n_levels = max_levels if n_levels <= 0 else min(n_levels, max_levels)
    return [(nx >> l, ny >> l, dx * (1 << l), dy * (1 << l))
            for l in range(n_levels)]


def _fused(cfg: MGConfig) -> bool:
    return cfg.fused != "off" and cfg.smoother != "cheb"


def v_cycle(u, f, levels, imasks, cfg: MGConfig, impl: str,
            want_rms: bool = False, out=None):
    """One V-cycle over the level pyramid (mg_N.jl:53-106); `impl` is
    "kernel" or "torch" (see impl_choice).

    want_rms=True returns (u, ssq) where ssq is the sum of the squared
    interior residual of the RETURNED u, computed by the finest ascend
    kernel (None when that edge did not run fused, or for a single-level
    pyramid).  out: where a fused finest ascend edge writes the returned
    u (not u itself, which the descend edge reads); ignored otherwise."""
    n = len(levels)
    fused = _fused(cfg)
    sm = "cheb" if cfg.smoother == "cheb" else impl
    ops = _OPS[impl]
    restrict_fn, prolong_fn = _pick_transfers(cfg.transfers)
    # cycle_dtype="mixed": the finest level stays in the input dtype, every
    # coarser level runs bf16; the casts live on the level-0/1 edges
    mixed = cfg.cycle_dtype == "mixed"

    # descend: pre-smooth -> residual -> restrict -> next level from zero
    fs = [f]
    us = [u]
    for k in range(n - 1):
        _, _, dxk, dyk = levels[k]
        if fused:
            uk, fk = ops.smooth_residual_restrict(us[k], fs[k], dxk, dyk,
                                                  cfg.v1)
        else:
            uk = smooth(us[k], fs[k], dxk, dyk, cfg.v1, imasks[k], sm)
            fk = restrict_fn(residual_full(fs[k], uk, dxk, dyk, imasks[k]))
        us[k] = uk
        if mixed and k == 0:
            fk = fk.to(torch.bfloat16)
        fs.append(fk)
        nxn, nyn, _, _ = levels[k + 1]
        us.append(fk.new_zeros((nxn + 1, nyn + 1)))
    _, _, dxc, dyc = levels[n - 1]
    us[n - 1] = smooth(us[n - 1], fs[n - 1], dxc, dyc,
                       cfg.v2 if n > 1 else cfg.v1, imasks[n - 1], sm)

    # ascend: prolongate -> correct -> relax (fused: one kernel call)
    ssq = None
    for k in range(n - 1, 0, -1):
        _, _, dxp, dyp = levels[k - 1]
        uc = us[k].to(us[k - 1].dtype)    # mixed: bf16 -> fp32 edge
        if fused:
            fine_rms = want_rms and k == 1
            res = ops.prolong_correct_smooth(us[k - 1], fs[k - 1], uc, dxp,
                                             dyp, cfg.v3, want_rms=fine_rms,
                                             out=out if k == 1 else None)
            if fine_rms:
                us[k - 1], ssq = res
            else:
                us[k - 1] = res
            continue
        us[k - 1] = us[k - 1] + prolong_fn(uc) * imasks[k - 1]
        us[k - 1] = smooth(us[k - 1], fs[k - 1], dxp, dyp, cfg.v3,
                           imasks[k - 1], sm)
    return (us[0], ssq) if want_rms else us[0]


def fmg_start(f, u0, levels, imasks, cfg: MGConfig, impl: str, g=None):
    """Nested-iteration start: homogenize (v = u - u0 has zero boundary,
    A v = f - A u0 =: g), restrict g down the pyramid, then from the
    coarsest level up: prolong the current solution and run one V-cycle
    of the sub-pyramid.  Returns u0 + v at ~discretization accuracy.
    g: the residual of (f, u0) when the caller has it (solve's rms0
    call), else computed here."""
    n = len(levels)
    _, _, dx0, dy0 = levels[0]
    if g is None:
        g = residual_full(f, u0, dx0, dy0, imasks[0])
    restrict_fn, prolong_fn = _pick_transfers(cfg.transfers)
    ops = _OPS[impl]
    gs = [g]
    for k in range(1, n):
        if _fused(cfg):
            gs.append(ops.residual_restrict(torch.zeros_like(gs[k - 1]),
                                            gs[k - 1], 1.0, 1.0))
        else:
            gs.append(restrict_fn(gs[k - 1] * imasks[k - 1]))

    nxc, nyc, dxc, dyc = levels[n - 1]
    v = f.new_zeros((nxc + 1, nyc + 1))
    v = smooth(v, gs[n - 1], dxc, dyc, cfg.v2, imasks[n - 1],
               "cheb" if cfg.smoother == "cheb" else impl)
    for k in range(n - 2, -1, -1):
        v = prolong_fn(v) * imasks[k]
        v = v_cycle(v, gs[k], levels[k:], imasks[k:], cfg, impl)
    return u0 + v


class _CycleGraph:
    """One V-cycle of a solve configuration captured as a CUDA graph:
    graph.replay() advances the static u in place and leaves its rms and
    rms/rms0 in `rms` and `rel`; load() copies a solve's f, u0 and rms0
    into the static inputs."""

    def __init__(self, cycle, f, u, rms0):
        self.cycle = cycle        # holds the tensors the graph reads
        self.f, self.u, self.rms0 = f.clone(), u.clone(), rms0.clone()
        stream = torch.cuda.Stream(f.device)
        loop.warm_up(lambda: cycle(self.u, self.f, self.rms0), stream)
        self.graph = loop.Graph(self._captured, stream)
        self.rms, self.rel = self.graph.out

    def _captured(self):
        u, rms, rel = self.cycle(self.u, self.f, self.rms0, out=self.u)
        if u is not self.u:       # an unfused cycle returns a new u
            self.u.copy_(u)
        return rms, rel

    def load(self, f, u, rms0):
        for dst, src in ((self.f, f), (self.u, u), (self.rms0, rms0)):
            dst.copy_(src)


# solve configuration -> _CycleGraph, most recently used last
_CYCLE_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_CYCLE_GRAPHS_KEPT = 4


def _cycle_graph(key, cycle, f, u, rms0) -> _CycleGraph:
    """The configuration's cached graph, loaded with this solve's inputs,
    or a new one captured from them."""
    graph = _CYCLE_GRAPHS.pop(key, None)
    if graph is None:
        graph = _CycleGraph(cycle, f, u, rms0)
    else:
        graph.load(f, u, rms0)
    _CYCLE_GRAPHS[key] = graph
    while len(_CYCLE_GRAPHS) > _CYCLE_GRAPHS_KEPT:
        _CYCLE_GRAPHS.popitem(last=False)
    return graph


def solve(f, u0, dx: float, dy: float, cfg: MGConfig = MGConfig(),
          mesh=None, graph: bool = True) -> IterativeResult:
    """V-cycles until rms/rms0 <= tol (mg_N.jl:53-106), the residual
    history recorded once per cycle on the device; cfg.fmg starts from a
    full-multigrid initial guess instead of u0.  f, u0: (nx+1, ny+1)
    tensors of one dtype (fp32 or fp64) on one device.

    The loop runs on the host and reads rms/rms0 once per cycle (one
    device sync per cycle); on a CUDA device each cycle is a replay of the
    configuration's captured V-cycle unless graph=False or under
    utils.debug.nan_guard.  With fused edges
    the finest ascend kernel returns the residual sum of the cycle's
    output, so no separate residual pass runs per cycle.

    With `mesh` (a DeviceMesh of parallel/mesh.make_mesh, called on every
    rank with the same global f and u0) the solve runs distributed over
    the ranks and returns the global u on every rank (_mesh_solve); it
    runs eagerly, since collectives over gloo cannot be captured in a CUDA
    graph, so `graph` applies to the single-device solve only."""
    if mesh is not None:
        return _mesh_solve(f, u0, dx, dy, cfg, mesh)
    check_config(cfg)
    impl = impl_choice(cfg.impl, f.device)
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    levels = _build_levels(nx, ny, dx, dy, cfg.n_levels)
    # mixed pyramid: coarse-level masks in bf16 so the dtype flow stays
    # bf16 through the coarse levels (an fp32 mask would upcast)
    ldt = [f.dtype] + [torch.bfloat16 if cfg.cycle_dtype == "mixed"
                       else f.dtype] * (len(levels) - 1)
    imasks = [interior_mask(l[0], l[1], d, f.device)
              for l, d in zip(levels, ldt)]
    fused_rms = len(levels) > 1 and _fused(cfg)
    residual_ssq = _OPS[impl].residual_ssq

    def rms_of(ssq):
        """compute_l2norm over interior nodes (Common.jl:229-232)."""
        return torch.sqrt(ssq / ((nx - 1) * (ny - 1))).to(f.dtype)

    def cycle(u, f, rms0, out=None):
        """One V-cycle: (u, rms, rms/rms0); a fused cycle writes u into
        `out` when given."""
        if fused_rms:
            u, ssq = v_cycle(u, f, levels, imasks, cfg, impl, want_rms=True,
                             out=out)
        else:
            u = v_cycle(u, f, levels, imasks, cfg, impl)
            ssq, _ = residual_ssq(u, f, dx, dy)
        rms = rms_of(ssq)
        return u, rms, rms / rms0

    ssq0, g = residual_ssq(u0, f, dx, dy, want_r=cfg.fmg)
    rms0 = rms_of(ssq0)
    if cfg.fmg:
        u0 = fmg_start(f, u0, levels, imasks, cfg, impl, g=g)
    hist = torch.full((cfg.max_cycles + 1, 3), float("nan"), dtype=f.dtype,
                      device=f.device)

    graphed = None
    u, it, rms, rel, nrec = u0, 0, rms0, rms0 / rms0, 0
    while it < cfg.max_cycles and float(rel) > cfg.tol:
        if graph and f.device.type == "cuda" and \
                not cuda_kernels.CHECK_NAN:
            if graphed is None:
                key = (tuple(f.shape), f.dtype, f.device, dx, dy, impl,
                       dataclasses.replace(cfg, tol=0.0, max_cycles=0,
                                           fmg=False))
                graphed = _cycle_graph(key, cycle, f, u, rms0)
            graphed.graph.replay()
            u, rms, rel = graphed.u, graphed.rms, graphed.rel
        else:
            u, rms, rel = cycle(u, f, rms0)
        it += 1
        _record(hist, nrec, it, rms, rel)
        nrec += 1
    if graphed is not None:       # the graph's static tensors stay its own
        u, rms = u.clone(), rms.clone()
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)


# --------------------------------------------------- multi-device V-cycle
#
# Distributed multigrid (cfd_julia_tpu/poisson/multigrid.py:540-760; mg_N.jl
# redesigned for a mesh of ranks), one program on every rank, each holding
# its block of every sharded level.
#  * Every level is zero-padded to mesh-divisible extents, JAX's exactly:
#    a sharded axis pads to a multiple of 8 * (its ranks), an unsharded one
#    keeps the logical extent.  The masks make the padded algebra exact:
#    stencils never reach the interior from the padding, smoother updates
#    are interior-masked, and the transfer matrices are zero-extended, so
#    the padding stays exactly zero through the cycle.
#  * A level is sharded along an axis while each rank keeps at least
#    _AGGLOM_TILE rows (columns) there; below that every rank holds all of
#    it and computes it (coarse-level agglomeration).  The descent gathers
#    once past the switch (inside the restriction's products), the ascent
#    takes a local slice (the prolongation matrix's row block).
#  * The smoother is the Chebyshev-Jacobi one and the transfers the
#    separable matmul pair, as in JAX: every residual takes a width-1 halo
#    exchange and runs the stencil on the framed block; each transfer
#    product applies the rank's block of the zero-extended matrix to an
#    operand gathered along one mesh axis (parallel/halo.py).
# The loop runs on the host and reads rms/rms0 once a cycle, as the
# single-device eager loop does.

_AGGLOM_TILE = 8   # least rows / columns a rank keeps before a level is
                   # held whole on every rank (JAX's TPU sublane count;
                   # kept so the padded extents match JAX's)


class _MeshLevel(NamedTuple):
    nx: int
    ny: int
    dx: float
    dy: float
    P: int
    Q: int
    sx: str | None     # the mesh axis the level's rows are sharded on
    sy: str | None     # that of its columns


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mesh_grid(mesh):
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.shape)
    py = shape[1] if len(shape) > 1 else 1
    return shape[0], py, names[0], names[1] if len(names) > 1 else None


def _mesh_levels(nx, ny, dx, dy, n_levels, mesh):
    """Padded level pyramid: logical (nxl+1, nyl+1) nodes inside padded
    (P, Q) extents; sharded axes pad to multiples of 8 * their ranks, so
    every block has whole tiles, unsharded axes keep the logical extent."""
    px, py, xn, yn = _mesh_grid(mesh)
    out = []
    for nxl, nyl, dxl, dyl in _build_levels(nx, ny, dx, dy, n_levels):
        sx = xn if px > 1 and (nxl + 1) >= _AGGLOM_TILE * px else None
        sy = yn if yn and py > 1 and (nyl + 1) >= _AGGLOM_TILE * py \
            else None
        P = _round_up(nxl + 1, 8 * px) if sx else nxl + 1
        Q = _round_up(nyl + 1, 8 * py) if sy else nyl + 1
        out.append(_MeshLevel(nxl, nyl, dxl, dyl, P, Q, sx, sy))
    return out


def _padded_imask(nx, ny, P, Q, dtype, device=None):
    """Interior mask with LOGICAL bounds inside a padded (P, Q) extent
    (interior_mask with the padding rows and columns zero)."""
    i = torch.arange(P, device=device)
    j = torch.arange(Q, device=device)
    m = ((i > 0) & (i < nx))[:, None] & ((j > 0) & (j < ny))[None, :]
    return m.to(dtype)


def _mesh_cfg(cfg: MGConfig) -> MGConfig:
    """Resolve an MGConfig for the mesh solve; refuse the single-device
    options loudly rather than silently running another solve."""
    transfers = "matmul" if cfg.transfers == "auto" else cfg.transfers
    if transfers != "matmul":
        raise ValueError("mesh multigrid uses transfers='matmul' (the "
                         "conv/reshape forms are single-device; dense "
                         f"matmuls split over the mesh), got {transfers!r}")
    if cfg.smoother not in ("auto", "cheb"):
        raise ValueError("mesh multigrid uses the Chebyshev smoother "
                         f"(smoother='cheb'|'auto'), got {cfg.smoother!r}")
    if cfg.cycle_dtype != "fp32":
        raise ValueError("mesh multigrid supports cycle_dtype='fp32' only "
                         "(the mixed and bf16 pyramids are single-device)")
    if cfg.impl == "kernel":
        raise ValueError("mesh multigrid runs no CUDA kernel (Chebyshev "
                         "smoother and matmul transfers in PyTorch, as the "
                         "JAX mesh solve runs no Pallas kernel); impl="
                         "'kernel' is single-device")
    cfg = dataclasses.replace(cfg, transfers=transfers, smoother="cheb",
                              fused="off")
    check_config(cfg)
    return cfg


class _LevelOps(NamedTuple):
    """A level of the padded pyramid on this rank: its spacing, its block's
    interior mask, the distributed residual, and the transfers to the next
    coarser level (restrict) and from it (prolong; None at the bottom)."""
    dx: float
    dy: float
    shape: tuple
    imask: torch.Tensor
    residual: object
    restrict: object
    prolong: object


def _mesh_level_ops(plv, mesh, dtype, device) -> list:
    """_LevelOps of every level of `plv` on this rank."""
    def block(L):
        return mesh_lib.block_slices((L.P, L.Q), mesh, (L.sx, L.sy))

    def residual_fn(L):
        def residual(f, u, dx, dy, mask):
            up = halo.halo_exchange_periodic(u, mesh, 1, (L.sx, L.sy))
            return (f - arakawa.laplacian(up, dx, dy)[1:-1, 1:-1]) * mask
        return residual

    def transfer(src, mx, my):
        """a on level src -> mx @ a @ my.T on the destination's blocks: mx
        and my are the destination's row and column blocks of the
        zero-extended matrices, each applied to an operand gathered along
        the axis src is sharded on."""
        def apply(a):
            t = mx @ halo.all_gather_axis(a, mesh, src.sx, 0)
            return halo.all_gather_axis(t, mesh, src.sy, 1) @ my.T
        return apply

    out = []
    for k, L in enumerate(plv):
        rows, cols = block(L)
        restrict = prolong = None
        if k + 1 < len(plv):
            C = plv[k + 1]
            crows, ccols = block(C)
            restrict = transfer(
                L,
                _restrict_matrix_padded(L.nx, C.P, L.P, dtype, device)[crows],
                _restrict_matrix_padded(L.ny, C.Q, L.Q, dtype, device)[ccols])
            prolong = transfer(
                C,
                _prolong_matrix_padded(C.nx, L.P, C.P, dtype, device)[rows],
                _prolong_matrix_padded(C.ny, L.Q, C.Q, dtype, device)[cols])
        imask = _padded_imask(L.nx, L.ny, L.P, L.Q, dtype,
                              device)[rows, cols].contiguous()
        out.append(_LevelOps(L.dx, L.dy, tuple(imask.shape), imask,
                             residual_fn(L), restrict, prolong))
    return out


def _mesh_smooth(L: _LevelOps, u, f, iters: int):
    return chebyshev_smooth(u, f, L.dx, L.dy, iters, L.imask,
                            residual=L.residual)


def _mesh_v_cycle(u, f, ops, cfg: MGConfig):
    """One V-cycle over the padded pyramid's levels `ops` (a tail of the
    whole pyramid during FMG) on this rank's blocks; element-equal to
    v_cycle with the Chebyshev smoother and matmul transfers on the
    unpadded grids."""
    n = len(ops)
    fs, us = [f], [u]
    for k in range(n - 1):
        L = ops[k]
        uk = _mesh_smooth(L, us[k], fs[k], cfg.v1)
        r = L.residual(fs[k], uk, L.dx, L.dy, L.imask)
        us[k] = uk
        fs.append(L.restrict(r))
        us.append(u.new_zeros(ops[k + 1].shape))
    us[-1] = _mesh_smooth(ops[-1], us[-1], fs[-1],
                          cfg.v2 if n > 1 else cfg.v1)
    for k in range(n - 1, 0, -1):
        L = ops[k - 1]
        uf = us[k - 1] + L.prolong(us[k]) * L.imask
        us[k - 1] = _mesh_smooth(L, uf, fs[k - 1], cfg.v3)
    return us[0]


def _mesh_fmg_start(fp, up, ops, cfg: MGConfig):
    """fmg_start on the padded pyramid: homogenize, restrict down, then one
    V-cycle per level on the way up."""
    L0 = ops[0]
    gs = [L0.residual(fp, up, L0.dx, L0.dy, L0.imask)]
    for k in range(1, len(ops)):
        gs.append(ops[k - 1].restrict(gs[k - 1]))
    v = _mesh_smooth(ops[-1], fp.new_zeros(ops[-1].shape), gs[-1], cfg.v2)
    for k in range(len(ops) - 2, -1, -1):
        v = ops[k].prolong(v) * ops[k].imask
        v = _mesh_v_cycle(v, gs[k], ops[k:], cfg)
    return up + v


def _mesh_solve(f, u0, dx: float, dy: float, cfg: MGConfig,
                mesh) -> IterativeResult:
    """solve() over a mesh of ranks.  f, u0: the global (nx+1, ny+1)
    fields, the same on every rank; returns the global u on every rank."""
    cfg = _mesh_cfg(cfg)
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    plv = _mesh_levels(nx, ny, dx, dy, cfg.n_levels, mesh)
    ops = _mesh_level_ops(plv, mesh, f.dtype, f.device)
    L0, top = plv[0], ops[0]
    rows, cols = mesh_lib.block_slices((L0.P, L0.Q), mesh, (L0.sx, L0.sy))
    pad = (0, L0.Q - (ny + 1), 0, L0.P - (nx + 1))
    fp = F.pad(f, pad)[rows, cols].contiguous()
    up = F.pad(u0, pad)[rows, cols].contiguous()

    def rms_of(u):
        r = top.residual(fp, u, dx, dy, top.imask)
        return torch.sqrt(halo.all_reduce_sum(torch.sum(r**2))
                          / ((nx - 1) * (ny - 1)))

    rms0 = rms_of(up)
    if cfg.fmg:
        up = _mesh_fmg_start(fp, up, ops, cfg)
    hist = torch.full((cfg.max_cycles + 1, 3), float("nan"), dtype=f.dtype,
                      device=f.device)
    it, rms, rel, nrec = 0, rms0, rms0 / rms0, 0
    while it < cfg.max_cycles and float(rel) > cfg.tol:
        up = _mesh_v_cycle(up, fp, ops, cfg)
        rms = rms_of(up)
        rel = rms / rms0
        it += 1
        _record(hist, nrec, it, rms, rel)
        nrec += 1
    from cfd_julia_torch.parallel import sharded

    u = sharded.gather(up, mesh, (L0.sx, L0.sy))
    return IterativeResult(u=u[:nx + 1, :ny + 1].contiguous(), iterations=it,
                           rms=rms, rms0=rms0, history=hist, n_records=nrec)
