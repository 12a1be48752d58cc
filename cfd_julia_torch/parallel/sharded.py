"""Sharded solver steps on a 2D mesh of ranks (counterpart of
cfd_julia_tpu/parallel/sharded.py:23-56, 122-124).

The JAX package jits the padded cavity step with the fields sharded
P("x", "y") and lets XLA's SPMD partitioner insert the collectives.  Here
each rank runs the same step on its own block, and the collectives are
explicit (parallel/halo.py): a halo exchange for the stencils, a gather
along one mesh axis for each dense sine product, a sum over all ranks for
the rms.

Node-centred (n+1)-sized fields are zero-padded to mesh-divisible shapes
(`padded_shape`, `pad_to_mesh`); the step works on the logical
[:n+1, :n+1] view and the padding stays exactly zero.  `place` takes a
rank's block of a global array, `gather` builds the global array from the
blocks on every rank (the port's `np.asarray` of a sharded JAX array), and
`as_dtensor` wraps a block as the DTensor that utils/checkpoint
.save_sharded writes without a gather.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cfd_julia_torch.models import cavity
from cfd_julia_torch.parallel import halo
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.poisson import direct


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_shape(shape, mesh):
    """`shape` rounded up to multiples of the mesh's (px, py)."""
    px, py = mesh.shape
    return (_round_up(shape[0], px), _round_up(shape[1], py))


def pad_to_mesh(arr, mesh):
    """A global (n, m) tensor zero-padded to padded_shape."""
    P, Q = padded_shape(arr.shape, mesh)
    return F.pad(arr, (0, Q - arr.shape[1], 0, P - arr.shape[0]))


def place(arr, mesh):
    """This rank's block of a global mesh-divisible field (a copy)."""
    return arr[mesh_lib.block_slices(arr.shape, mesh)].contiguous()


def gather(block, mesh, axes=mesh_lib.AXES):
    """The global field from every rank's block, on every rank."""
    ax, ay = axes
    rows = halo.all_gather_axis(block, mesh, ax, 0)
    return halo.all_gather_axis(rows, mesh, ay, 1)


def as_dtensor(block, mesh):
    """The rank's block of a mesh-divisible field as a DTensor sharded
    [Shard(0), Shard(1)] over the 2D mesh (no communication)."""
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(block, mesh, [Shard(0), Shard(1)],
                              run_check=False)


def make_sharded_cavity_step(cfg, mesh, dtype=None, device=None):
    """The padded cavity step on this rank's blocks:
    (w_block, s_block, rms) -> (w_block, s_block, rms), rms the global
    ||psi^n - psi^{n-1}|| on every rank (models/cavity.padded_step).

    A stage: one width-2 halo exchange of the stacked (w, psi) blocks
    serves both the RHS and the wall BCs' +-2 shifts of psi; kernel 1
    (its twin on the CPU, by cfg.rhs_impl) runs on the framed block,
    periodic over it, and its interior is the rank's block, since the
    stencil never reaches a wrapped value from there; the Poisson solve
    is four block matmuls, each behind a gather along one mesh axis
    (direct.make_fst_matmul_padded); the rms an all-reduced sum."""
    device = torch.device(device or mesh.device_type)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dtype = dtype or torch.float32
    if cfg.bc_order not in (1, 2):
        raise ValueError("bc_order must be 1 or 2")
    shape = padded_shape((cfg.nx + 1, cfg.ny + 1), mesh)
    rows, cols = mesh_lib.block_slices(shape, mesh)
    rhs = cavity.periodic_rhs(cfg, device)

    def frame(w, s):
        ext = halo.halo_exchange_periodic(torch.stack([w, s]), mesh, 2)
        return rhs(ext[0], ext[1])[2:-2, 2:-2], ext[1], 2

    solve = direct.make_fst_matmul_padded(
        cfg.nx, cfg.ny, cfg.dx, cfg.dy, shape, dtype, device, (rows, cols),
        gather_rows=lambda a: halo.all_gather_axis(a, mesh, "x", 0),
        gather_cols=lambda a: halo.all_gather_axis(a, mesh, "y", 1))
    i = torch.arange(rows.start, rows.stop, device=device)[:, None]
    j = torch.arange(cols.start, cols.stop, device=device)[None, :]
    return cavity.padded_step(cfg, i, j, frame, solve,
                              lambda t: halo.all_reduce_sum(t.sum()))
