"""Direct (transform-based) Poisson solvers on node-centred grids
(counterpart of cfd_julia_tpu/poisson/direct.py).

Wraps ops.spectral with the reference's full-grid conventions:
* the periodic FFT solvers take/return (nx+1, ny+1) node grids, solving on
  the nx x ny unique nodes and wrapping the duplicated boundary
  (fft_p.jl:92-104, fft_s.jl);
* the FST solver takes the full grid, solves the (nx-1)x(ny-1) interior
  with homogeneous Dirichlet boundaries and zero-fills the boundary ring
  (fft_d.jl:70-76);
* the sine-matmul solver is the same DST-I solve as four dense
  sine-matrix products, which on the GPU are plain large GEMMs
  (torch.matmul, full fp32) or, in a precision tier of the TPU's matrix
  unit (`tier`, the JAX package's `mm_precision`), split-bf16 products
  (ops/cuda_kernels.TierPlan: csrc/tier_gemm.cu on the GPU, the sine
  matrices split once at build, the four products chained by
  cuda_kernels.TierSolve; its plain twin on the CPU, so a tier computes
  the TPU's arithmetic on every device where JAX's CPU backend ignores
  the precision and runs fp32).

PyTorch runs eagerly, so each `make_*` builds its eigenvalue denominator
(and the sine matrices or transform weights) once and returns the solve
that reuses them, where JAX built them once at trace time; `solve_*` are
the one-off forms.

With a mesh (`mesh=`), the FFT and FST solves map this rank's 2D block of
the node grid, zero-padded to parallel/mesh.padded_shape, to its block of
the solution, exactly zero on the padding: the grid moves into the row
slabs of the nodes the transforms read (parallel/transpose.py, the moves
planned when the solve is built), the pencil solve of ops/spectral.py
runs, and the result moves back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cfd_julia_torch.ops import cuda_kernels, spectral
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.parallel import transpose


def _row_wrap(parts, n: int):
    """The Parts of a row slab moved down by n rows and cut to global row
    n: rank 0 then holds row n, a copy of its row 0 (a periodic wrap)."""
    from cfd_julia_torch.parallel import transpose

    out = []
    for p in parts:
        lo, hi = max(p.rows[0] + n, n), min(p.rows[1] + n, n + 1)
        rows = (lo, hi) if lo < hi else (n, n)
        out.append(transpose.Part(p.shape, (p.origin[0] + n, p.origin[1]),
                                  rows, p.cols))
    return out


def make_fft(nx: int, ny: int, dx: float, dy: float, dtype, device=None,
             eigen: str = "fdm", mesh=None):
    """Build the periodic Poisson solve on an (nx+1, ny+1) node grid with
    wrapped edges; returns solve(f) -> u of the same shape.  With a mesh:
    blocks of the padded grid (module docstring); the unique nodes' row
    slabs solve, and u's last row and column are moved in as copies of
    its first."""
    inner = spectral.make_fft_poisson_periodic(nx, ny, dx, dy, dtype, device,
                                               eigen, mesh=mesh)
    if mesh is not None:
        shape = mesh_lib.padded_shape((nx + 1, ny + 1), mesh)
        wide = transpose.row_parts(mesh, (nx, ny + 1))
        blocks = transpose.block_parts(mesh, shape, extent=(nx + 1, ny + 1))
        to_slabs = transpose.plan(
            transpose.block_parts(mesh, shape, extent=(nx, ny)),
            transpose.row_parts(mesh, (nx, ny)), mesh)
        to_blocks = transpose.plan(wide, blocks, mesh)
        wrap = transpose.plan(_row_wrap(wide, nx), blocks, mesh)

        def solve(f):
            u = inner(transpose.move(f, to_slabs))
            u = torch.cat([u, u[..., :1]], dim=-1)   # column ny = column 0
            return transpose.move(u, to_blocks) + transpose.move(u, wrap)

        return solve

    def solve(f):
        # circular pad: the duplicated last row and column repeat the first
        return F.pad(inner(f[:-1, :-1])[None], (0, 1, 0, 1),
                     mode="circular")[0]

    return solve


def solve_fft(f, dx: float, dy: float, eigen: str = "fdm", mesh=None,
              shape=None):
    """Periodic Poisson solve; f, result: (nx+1, ny+1) with wrapped edges,
    or with a mesh this rank's block of that grid zero-padded to mesh
    multiples, `shape` its (nx+1, ny+1)."""
    nx, ny = (f.shape[0] - 1, f.shape[1] - 1) if mesh is None \
        else (shape[0] - 1, shape[1] - 1)
    return make_fft(nx, ny, dx, dy, f.dtype, f.device, eigen, mesh)(f)


def make_fst(nx: int, ny: int, dx: float, dy: float, dtype, device=None,
             impl: str = "rfft", mesh=None):
    """Build the homogeneous-Dirichlet Poisson solve via DST-I on the
    interior of an (nx+1, ny+1) grid (impl: rfft | half, ops.spectral.dst1);
    returns solve(f) -> u with an exactly-zero boundary ring.  With a mesh:
    blocks of the padded grid (module docstring); one move takes the
    interior nodes into the row slabs of the (nx-1, ny-1) interior, and
    one brings the solution back, the walls and the padding zero."""
    inner = spectral.make_fst_poisson_dirichlet(nx - 1, ny - 1, dx, dy, dtype,
                                                device, impl, mesh)
    if mesh is not None:
        interior = (nx - 1, ny - 1)
        blocks = transpose.block_parts(
            mesh, mesh_lib.padded_shape((nx + 1, ny + 1), mesh), (1, 1),
            interior)
        slabs = transpose.row_parts(mesh, interior)
        to_slabs = transpose.plan(blocks, slabs, mesh)
        to_blocks = transpose.plan(slabs, blocks, mesh)
        return lambda f: transpose.move(inner(transpose.move(f, to_slabs)),
                                        to_blocks)
    return lambda f: F.pad(inner(f[1:-1, 1:-1]), (1, 1, 1, 1))


def solve_fst(f, dx: float, dy: float, impl: str = "rfft", mesh=None,
              shape=None):
    """One-off form of make_fst; f: (nx+1, ny+1), or with a mesh this
    rank's block of that grid zero-padded to mesh multiples, `shape` its
    (nx+1, ny+1)."""
    nx, ny = (f.shape[0] - 1, f.shape[1] - 1) if mesh is None \
        else (shape[0] - 1, shape[1] - 1)
    return make_fst(nx, ny, dx, dy, f.dtype, f.device, impl, mesh)(f)


def sine_matrix(n: int, size: int, dtype, device=None):
    """(size, size) zero-extended DST-I matrix: S[r, c] = sin(pi r c / n)
    for r, c < n and 0 elsewhere.  The argument is reduced by sin's period
    before the float cast (see _sine_entries)."""
    ri = torch.arange(size, dtype=torch.int32, device=device)[:, None]
    ci = torch.arange(size, dtype=torch.int32, device=device)[None, :]
    s = _sine_entries(ri, ci, n, dtype)
    return torch.where((ri < n) & (ci < n), s,
                       torch.zeros((), dtype=dtype, device=device))


def _sine_entries(ri, ci, n: int, dtype):
    """sin(pi * (ri*ci mod 2n) / n) with the product period-reduced in
    int32 BEFORE the float cast, so an fp32 argument stays <= 2 pi and the
    entries are accurate to ~3e-7 instead of the ~3e-4 an unreduced fp32
    pi*r*c/n carries at n=1024.  ri*ci is exact in int32 while the largest
    index is below ~46k."""
    m = (ri * ci) % (2 * n)
    return torch.sin(math.pi * m.to(dtype) / n)


def tier_of(poisson: str) -> str | None:
    """The precision tier a cavity Poisson name carries: "bf16x3" for
    matmul_bf16x3 / fused_bf16x3, "bf16x1" for the _bf16x1 names, else
    None (full precision)."""
    for tier in cuda_kernels.TIER_PASSES:
        if poisson.endswith("_" + tier):
            return tier
    return None


def sine_solve(tier: str | None, sx, sy, den, scale: float, shape):
    """The sine-matrix solve f -> (sx ((sx f sy) / den) sy) * scale on
    fields of `shape`.  tier=None: torch.matmul (full precision, JAX's
    mm_precision="highest") and torch's / and *; "bf16x3" ("high") or
    "bf16x1" ("default"): a cuda_kernels.TierSolve over the split-bf16
    products, one TierPlan a sine matrix (split once, here), whose GEMMs on
    the GPU write the next product's split operand themselves with / den
    and * scale folded in (one split and four GEMMs a solve), bitwise the
    plans' products with torch's / and *; fp32 only, so a tier never runs
    silently at another precision."""
    if tier is None:
        def solve(f):
            coeff = torch.matmul(torch.matmul(sx, f), sy) / den
            return torch.matmul(torch.matmul(sx, coeff), sy) * scale

        return solve
    if tier not in cuda_kernels.TIER_PASSES:
        raise ValueError(f"unknown precision tier {tier!r} "
                         f"({' | '.join(cuda_kernels.TIER_PASSES)})")
    if sx.dtype != torch.float32:
        raise ValueError(f"the {tier} tier splits fp32 operands into bf16 "
                         f"parts and takes fp32 only, got {sx.dtype}")
    passes = cuda_kernels.TIER_PASSES[tier]
    return cuda_kernels.TierSolve(
        cuda_kernels.TierPlan(sx, passes, "left", shape),
        cuda_kernels.TierPlan(sy, passes, "right", shape), den, scale)


def make_fst_matmul_interior(nx: int, ny: int, dx: float, dy: float,
                             dtype, device=None, tier: str | None = None):
    """Build the Dirichlet Poisson solve lap(u) = f on an (nx+1, ny+1) grid
    as four dense matmuls; returns solve(f) -> u.

    solve reads only f's interior (1..nx-1, 1..ny-1) and returns u with an
    exactly-zero boundary ring.  With S the unscaled interior sine matrix,
    u = S((S g S) / den) S * 4/(nx ny): S^2 = (n/2) I on the interior, and
    FFTW's RODFT00 pair scales by 2nx * 2ny.  tier: None (fp32 or fp64
    products), "bf16x3" or "bf16x1" (fp32 only; sine_solve).
    solve.interior is the solve of the interior alone, (nx-1, ny-1) ->
    (nx-1, ny-1): sine_solve's (a cuda_kernels.TierSolve in a tier)."""
    def sine_interior(n):
        k = torch.arange(1, n, dtype=torch.int32, device=device)
        return _sine_entries(k[:, None], k[None, :], n, dtype)

    sx = sine_interior(nx)
    sy = sine_interior(ny)
    kx = torch.arange(1, nx, dtype=dtype, device=device)
    ky = torch.arange(1, ny, dtype=dtype, device=device)
    den = (2.0 / dx**2) * (torch.cos(math.pi * kx[:, None] / nx) - 1.0) + (
        2.0 / dy**2
    ) * (torch.cos(math.pi * ky[None, :] / ny) - 1.0)
    inner = sine_solve(tier, sx, sy, den, 4.0 / (nx * ny), (nx - 1, ny - 1))

    def solve(f):
        # the interior is read in place (a tier's split takes strided rows)
        return F.pad(inner(f[1:nx, 1:ny]), (1, 1, 1, 1))

    solve.interior = inner
    return solve


def make_fst_matmul_padded(nx: int, ny: int, dx: float, dy: float,
                           padded_shape, dtype, device=None, block=None,
                           gather_rows=None, gather_cols=None):
    """Build the Dirichlet Poisson solve lap(u) = f as four dense matmuls
    on a zero-extended (P, Q) padded field whose logical content lives at
    [0..nx, 0..ny] (cfd_julia_tpu/poisson/direct.py:71-104, the multi-chip
    formulation).  solve(f) reads only the interior (1..nx-1, 1..ny-1) and
    returns the padded solution, exactly zero on the walls and the
    padding: u = (S_x ((S_x g S_y) / den) S_y) * 4/(nx ny), S the
    zero-extended sine matrices (sine_matrix).

    Sharded over a mesh: `block` = (rows, cols), the slices of the rank's
    block (parallel/mesh.block_slices); solve then maps the rank's block of
    f to its block of u.  gather_rows(a) stacks the blocks of the rank's
    mesh column along dim 0 (the x axis), gather_cols(a) those of its mesh
    row along dim 1: each left product takes the rank's row block of S_x
    against the gathered operand, each right product the gathered operand
    against the column block of S_y."""
    P, Q = padded_shape
    rows, cols = block or (slice(0, P), slice(0, Q))
    sx = sine_matrix(nx, P, dtype, device)[rows]
    sy = sine_matrix(ny, Q, dtype, device)[:, cols].contiguous()
    k = torch.arange(P, dtype=dtype, device=device)[rows, None]
    l_ = torch.arange(Q, dtype=dtype, device=device)[None, cols]
    valid = ((k >= 1) & (k <= nx - 1)) & ((l_ >= 1) & (l_ <= ny - 1))
    den = (2.0 / dx**2) * (torch.cos(math.pi * k / nx) - 1.0) + (
        2.0 / dy**2
    ) * (torch.cos(math.pi * l_ / ny) - 1.0)
    den = torch.where(valid, den, torch.ones((), dtype=dtype, device=device))
    scale = 4.0 / (nx * ny)
    same = lambda a: a  # noqa: E731
    gather_rows, gather_cols = gather_rows or same, gather_cols or same

    def solve(f):
        g = torch.where(valid, f, torch.zeros((), dtype=dtype, device=device))
        coeff = (gather_cols(sx @ gather_rows(g)) @ sy) / den
        return (gather_cols(sx @ gather_rows(coeff)) @ sy) * scale

    return solve


def solve_fst_matmul_padded(f, nx: int, ny: int, dx: float, dy: float):
    """One-off form of make_fst_matmul_padded on a whole (P, Q) padded
    field f (builds the matrices for this call)."""
    return make_fst_matmul_padded(nx, ny, dx, dy, tuple(f.shape), f.dtype,
                                  f.device)(f)


def solve_fst_matmul_interior(f, nx: int, ny: int, dx: float, dy: float,
                              tier: str | None = None):
    """One-off form of make_fst_matmul_interior (builds the matrices for
    this call); f: (nx+1, ny+1)."""
    return make_fst_matmul_interior(nx, ny, dx, dy, f.dtype, f.device,
                                    tier)(f)
