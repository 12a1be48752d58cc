"""Sharded solver steps on a 2D mesh of ranks (counterpart of
cfd_julia_tpu/parallel/sharded.py).

The JAX package jits the padded cavity step with the fields sharded
P("x", "y") and lets XLA's SPMD partitioner insert the collectives.  Here
each rank runs the same step on its own block, and the collectives are
explicit (parallel/halo.py): a halo exchange for the stencils, a gather
along one mesh axis for each dense sine product, a sum over all ranks for
the rms.

Node-centred (n+1)-sized fields are zero-padded to mesh-divisible shapes
(mesh.padded_shape, `pad_to_mesh`); the step works on the logical
[:n+1, :n+1] view and the padding stays exactly zero.  `place` takes a
rank's block of a global array, `gather` builds the global array from the
blocks on every rank (the port's `np.asarray` of a sharded JAX array), and
`as_dtensor` wraps a block as the DTensor that utils/checkpoint
.save_sharded writes without a gather.

The periodic vortex steps (`make_sharded_vortex_step`,
`make_sharded_vortex_step_half`) and the cavity's fst / fst_half solve run
the pencil transforms of ops/spectral.py, whose all-to-all transposes are
parallel/transpose.py.  The half spectrum lives in row slabs
(mesh.place_slab, `gather_slab`); JAX's packed Re/Im states (`pack_c`) are
not ported: the states here are complex.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cfd_julia_torch.models import cavity, vortex
from cfd_julia_torch.parallel import halo
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.poisson import direct
from cfd_julia_torch.stepping import ssprk3


def pad_to_mesh(arr, mesh):
    """A global (n, m) tensor zero-padded to mesh.padded_shape."""
    P, Q = mesh_lib.padded_shape(arr.shape, mesh)
    return F.pad(arr, (0, Q - arr.shape[1], 0, P - arr.shape[0]))


def place(arr, mesh):
    """This rank's block of a global mesh-divisible field (a copy); leading
    axes are a batch."""
    return arr[(..., *mesh_lib.block_slices(arr.shape, mesh))].contiguous()


def gather(block, mesh, axes=mesh_lib.AXES):
    """The global field from every rank's block, on every rank."""
    ax, ay = axes
    rows = halo.all_gather_axis(block, mesh, ax, 0)
    return halo.all_gather_axis(rows, mesh, ay, 1)


def gather_slab(slab, mesh, shape, dim: int = -2):
    """The global field of `shape` (n, m) from every rank's slab, on every
    rank, its padding cut."""
    n, m = shape
    line = mesh_lib.flat_line(mesh)
    whole = halo.all_gather_axis(slab, line, mesh_lib.FLAT[0], dim)
    return whole[..., :n, :m]


def _device(mesh, device):
    device = torch.device(device or mesh.device_type)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_sharded_vortex_step(cfg, mesh, dtype=None, device=None):
    """The vortex step on this rank's block: fdm, the real vorticity
    (SSP-RK3 over vortex.make_fdm_rhs(mesh=): the pencil Poisson solve and
    kernel 1 on the framed block); the spectral solvers, the full complex
    spectrum (vortex.make_spectral_step(mesh=)).  The JAX package carries
    the spectrum as its packed Re/Im stack; here it is complex."""
    device = _device(mesh, device)
    dtype = dtype or torch.float32
    if cfg.solver == "fdm":
        rhs = vortex.make_fdm_rhs(cfg, dtype, device, mesh=mesh)
        return lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
    return vortex.make_spectral_step(cfg, dtype, device, mesh=mesh)


def make_sharded_vortex_step_half(cfg, mesh, dtype=None, device=None):
    """The half-spectrum step on this rank's row slab of the complex
    (nx, ny//2+1) half spectrum (kx over all ranks: JAX's
    packed_half_sharding, P(None, flat, None), without its Re/Im axis)."""
    return vortex.make_spectral_step_half(cfg, dtype or torch.float32,
                                          _device(mesh, device), mesh=mesh)


def as_dtensor(block, mesh):
    """The rank's block of a mesh-divisible field as a DTensor sharded
    [Shard(0), Shard(1)] over the 2D mesh (no communication)."""
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(block, mesh, [Shard(0), Shard(1)],
                              run_check=False)


# the cavity's Poisson solves on a mesh: the padded sine matmuls, and the
# pencil DST-I of JAX's make_step_fn(cfg, mesh=)
CAVITY_POISSON = ("auto", "matmul", "fst", "fst_half")


def make_sharded_cavity_step(cfg, mesh, dtype=None, device=None, re=None):
    """The padded cavity step on this rank's blocks:
    (w_block, s_block, rms) -> (w_block, s_block, rms), rms the global
    ||psi^n - psi^{n-1}|| on every rank (models/cavity.padded_step).

    A stage: one width-2 halo exchange of the stacked (w, psi) blocks
    serves both the RHS and the wall BCs' +-2 shifts of psi; kernel 1
    (its twin on the CPU, by cfg.rhs_impl) runs on the framed block,
    periodic over it, and its interior is the rank's block, since the
    stencil never reaches a wrapped value from there; the rms an
    all-reduced sum.  The Poisson solve, by cfg.poisson: "auto" and
    "matmul" four block matmuls, each behind a gather along one mesh axis
    (direct.make_fst_matmul_padded); "fst" and "fst_half" the pencil
    DST-I (direct.make_fst(mesh=): the interior to row slabs, y
    transforms, a transpose, x transforms and the division, back).  Any
    other name raises.

    Differentiable with torch.autograd in the state (the exchanges,
    gathers, sums and moves of halo.py and transpose.py carry the
    gradient back), and for fst / fst_half in re: a float or a 0-d tensor
    every rank holds alike, which enters each stage through
    halo.replicate and reaches kernel 1 on the framed block (the kernel's
    device-Re entry and its backward kernel).  The matmul form takes
    cfg.re only, as the JAX package's make_padded_step_fn: a tensor re
    raises."""
    if cfg.poisson not in CAVITY_POISSON:
        raise ValueError(
            f"poisson={cfg.poisson!r} does not run on a mesh; the sharded "
            f"cavity step runs {' | '.join(CAVITY_POISSON)} ('fst' / "
            "'fst_half': the pencil DST; 'auto' / 'matmul': the padded sine "
            "matmuls)")
    fst = cfg.poisson in ("fst", "fst_half")
    if isinstance(re, torch.Tensor) and not fst:
        raise ValueError(
            f"poisson={cfg.poisson!r} on a mesh takes cfg.re only, as the "
            "JAX package's make_padded_step_fn; a tensor re runs with "
            "poisson='fst' or 'fst_half'")
    device = _device(mesh, device)
    dtype = dtype or torch.float32
    if cfg.bc_order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")
    shape = mesh_lib.padded_shape((cfg.nx + 1, cfg.ny + 1), mesh)
    rows, cols = mesh_lib.block_slices(shape, mesh)
    re = cfg.re if re is None else re
    rhs = cavity.periodic_rhs(cfg, device)

    def frame(w, s):
        ext = halo.halo_exchange_periodic(torch.stack([w, s]), mesh, 2)
        return (rhs(ext[0], ext[1], halo.replicate(re, mesh))[2:-2, 2:-2],
                ext[1], 2)

    if fst:
        solve = direct.make_fst(
            cfg.nx, cfg.ny, cfg.dx, cfg.dy, dtype, device,
            impl="half" if cfg.poisson == "fst_half" else "rfft", mesh=mesh)
    else:
        solve = direct.make_fst_matmul_padded(
            cfg.nx, cfg.ny, cfg.dx, cfg.dy, shape, dtype, device,
            (rows, cols),
            gather_rows=lambda a: halo.all_gather_axis(a, mesh, "x", 0),
            gather_cols=lambda a: halo.all_gather_axis(a, mesh, "y", 1))
    i = torch.arange(rows.start, rows.stop, device=device)[:, None]
    j = torch.arange(cols.start, cols.stop, device=device)[None, :]
    return cavity.padded_step(cfg, i, j, frame, solve,
                              lambda t: halo.all_reduce_sum(t.sum()))
