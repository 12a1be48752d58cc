"""Pencil transposes: a field moved between the 2D block layout of the
mesh and the slab layouts of the pencil transforms (counterpart of the
sharding-constraint pairs of cfd_julia_tpu/ops/spectral.py:34-80, and of
the all-to-all that XLA's partitioner emits for them).

Layouts of a global (n, m) field over a mesh of px x py ranks:
- block, P("x", "y"): rank (a, b) holds rows [a n/px, (a+1) n/px) and
  columns [b m/py, (b+1) m/py) (mesh.block_slices; n, m must divide);
- row slab, P(flat, None): the rank at flat position r holds rows
  [r s, (r+1) s), s = mesh.slab_extent(n), and every column;
- column slab, P(None, flat): every row, and columns [r t, (r+1) t),
  t = mesh.slab_extent(m).
A slab's rows (columns) past n (m) are zero padding: a move never sends
them, and fills them with zeros where it builds a slab.  So a transform
along the whole axis of a slab never sees padding, and a transform along
the padded axis is not made (ops/spectral.py transforms each axis where it
is whole).

Every move is one `dist.all_to_all_single`: each rank sends every other
the part of its tensor that the other holds in the target layout, and
places what it receives.  Block <-> row slab runs on the mesh's "y" group
when n divides over all ranks (the rows of block-row a are then exactly
the row slabs of its "y" line); every other move runs over all ranks with
per-rank split sizes (zero where two parts do not meet).  Leading batch
axes ride along.  Complex tensors travel as `torch.view_as_real` views on
both backends.  Under gloo, CUDA tensors are staged through host memory
(halo.host_staged: the backend decides, never an error).  On one rank a
move between two layouts that coincide returns its input: no message, no
copy.

A move's `Plan` (its group, and this rank's slices to send and to fill)
depends only on the mesh and the shapes, so the callers build each plan
once, when a step or a solve is built, and `move(x, plan)` only slices,
exchanges and places.  A `Pencil` holds the two moves of a pencil
transform: row slab -> column slab and back.  Rank k sits at flat
position k and at mesh coordinate divmod(k, py) (mesh.make_mesh).

`move` is differentiable: each element the target holds comes from one
source element, so the backward is the plan's `inverse` (send and recv
swapped, built with the plan), one all-to-all of the gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from cfd_julia_torch.parallel import halo
from cfd_julia_torch.parallel import mesh as mesh_lib


class Part(NamedTuple):
    """What one rank holds of a global field: the trailing (h, w) shape of
    its local tensor, the global index of that tensor's [0, 0] element, and
    the global rows and columns of the field it holds, [lo, hi) each (any
    other element of the tensor is zero padding)."""
    shape: tuple[int, int]
    origin: tuple[int, int]
    rows: tuple[int, int]
    cols: tuple[int, int]


def _clip(lo: int, hi: int, n: int) -> tuple[int, int]:
    return max(lo, 0), min(hi, n)


def block_parts(mesh, shape, shift=(0, 0), extent=None) -> list[Part]:
    """Every rank's Part of a field in 2D blocks of the block-divisible
    global `shape` (P, Q), in global rank order.  shift: global indices
    are the field's less `shift` (the cavity's interior is its nodes less
    (1, 1)); extent: the (n, m) of the shifted field whose indices are
    valid (default: all of the block)."""
    P, Q = tuple(shape)[-2:]
    px, py = mesh.shape
    bx, by = P // px, Q // py
    out = []
    for rank in range(mesh_lib.world_size(mesh)):
        a, b = divmod(rank, py)
        r0, c0 = a * bx - shift[0], b * by - shift[1]
        rows, cols = (r0, r0 + bx), (c0, c0 + by)
        if extent is not None:
            rows, cols = _clip(*rows, extent[0]), _clip(*cols, extent[1])
        out.append(Part((bx, by), (r0, c0), rows, cols))
    return out


def row_parts(mesh, shape) -> list[Part]:
    """Every rank's Part of a global (n, m) field in row slabs."""
    n, m = tuple(shape)[-2:]
    s = mesh_lib.slab_extent(n, mesh)
    return [Part((s, m), (k * s, 0), _clip(k * s, (k + 1) * s, n), (0, m))
            for k in range(mesh_lib.world_size(mesh))]


def col_parts(mesh, shape) -> list[Part]:
    """Every rank's Part of a global (n, m) field in column slabs."""
    n, m = tuple(shape)[-2:]
    t = mesh_lib.slab_extent(m, mesh)
    return [Part((n, t), (0, k * t), (0, n), _clip(k * t, (k + 1) * t, m))
            for k in range(mesh_lib.world_size(mesh))]


def _meet(a, b):
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _local(part: Part, rows, cols):
    """Slices of part's tensor holding global rows x cols."""
    return (slice(rows[0] - part.origin[0], rows[1] - part.origin[0]),
            slice(cols[0] - part.origin[1], cols[1] - part.origin[1]))


def _all_to_all(x, send, shapes, group):
    """One all_to_all_single over `group`: send[k] (a tensor or None) to
    its k-th member, and return what each member sent here, shaped
    shapes[k] (None where nothing comes)."""
    rdtype = x.dtype.to_real()
    per = 2 if x.is_complex() else 1

    def flat(t):
        return (torch.view_as_real(t) if t.is_complex() else t).reshape(-1)

    in_splits = [0 if t is None else t.numel() * per for t in send]
    out_splits = [0 if s is None else math.prod(s) * per for s in shapes]
    staged = halo.host_staged(group, x)
    parts = [flat(t) for t in send if t is not None]
    buf = torch.cat(parts) if parts else x.new_empty(0, dtype=rdtype)
    if staged:
        buf = buf.cpu()
    got = buf.new_empty(sum(out_splits))
    dist.all_to_all_single(got, buf, out_splits, in_splits, group=group)
    if staged:
        got = got.to(x.device)
    out = []
    for piece, shape in zip(got.split(out_splits), shapes):
        if shape is None:
            out.append(None)
        elif per == 2:
            out.append(torch.view_as_complex(piece.view(*shape, 2)))
        else:
            out.append(piece.view(shape))
    return out


class Plan(NamedTuple):
    """One move between two layouts, for this rank: the `group` it runs
    on (None: all ranks); for each member of the group, the (rows, cols)
    slices of this rank's tensor that the member gets (`send`) and of the
    result that what it sends fills (`recv`), None where the two parts do
    not meet; the trailing shape of the result; `noop`, true where
    the group is this rank alone and the two layouts coincide; and
    `inverse`, the move back (send and recv swapped, to the source's
    shape; its own inverse None), which the backward of `move` runs."""
    group: object
    send: tuple
    recv: tuple
    shape: tuple[int, int]
    noop: bool
    inverse: "Plan | None" = None


def plan(src: list[Part], dst: list[Part], mesh, group_axis=None) -> Plan:
    """The Plan of moving a field laid out as `src` (Parts in global rank
    order) to the layout `dst`, by one all-to-all over the ranks of mesh
    axis `group_axis`'s group that holds this rank (None: all ranks)."""
    world = mesh_lib.world_size(mesh)
    if not torch.equal(mesh.mesh.flatten().cpu(), torch.arange(world)):
        raise ValueError("a move needs rank k at flat position k of the "
                         "mesh, as mesh.make_mesh lays it out")
    group = None if group_axis is None else mesh.get_group(group_axis)
    ranks = (range(world) if group is None
             else dist.get_process_group_ranks(group))
    me = dist.get_rank()
    mine, want = src[me], dst[me]
    send, recv = [], []
    for k in ranks:
        rows, cols = _meet(mine.rows, dst[k].rows), _meet(mine.cols,
                                                           dst[k].cols)
        send.append(_local(mine, rows, cols) if rows and cols else None)
        rows, cols = _meet(src[k].rows, want.rows), _meet(src[k].cols,
                                                          want.cols)
        recv.append(_local(want, rows, cols) if rows and cols else None)
    noop = len(send) == 1 and mine == want
    send, recv = tuple(send), tuple(recv)
    # every element a layout holds is held by one rank, so the move is a
    # permutation (less the padding): its inverse is its transpose
    return Plan(group, send, recv, want.shape, noop,
                Plan(group, recv, send, mine.shape, noop))


def _move(x, plan: Plan):
    batch = tuple(x.shape[:-2])
    send = [None if s is None else x[(..., *s)] for s in plan.send]
    if len(send) == 1:
        pieces = send
    else:
        shapes = [None if r is None
                  else (*batch, r[0].stop - r[0].start, r[1].stop - r[1].start)
                  for r in plan.recv]
        pieces = _all_to_all(x, send, shapes, plan.group)
    out = x.new_zeros((*batch, *plan.shape))
    for r, piece in zip(plan.recv, pieces):
        if r is not None:
            out[(..., *r)] = piece
    return out


class _Move(torch.autograd.Function):
    """move, whose backward is the inverse move of the gradient: what the
    padding received (zeros) drops its gradient, and source padding that
    was never sent gets zero."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _move(x, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _move(g, ctx.plan.inverse), None


def move(x, plan: Plan):
    """x, this rank's tensor of a field in the plan's source layout, as
    its tensor of the target layout.  Leading axes of x are a batch.
    Differentiable (_Move)."""
    if plan.noop:
        return x
    return _Move.apply(x, plan)


def _rows_group(mesh, shape):
    """The "y" axis when the row slabs of each "y" line tile its block
    row, else None (all ranks)."""
    return "y" if shape[-2] % mesh_lib.world_size(mesh) == 0 else None


def block_to_rows(mesh, shape) -> Plan:
    """Block of a global (n, m) field -> its row slab."""
    return plan(block_parts(mesh, shape), row_parts(mesh, shape), mesh,
                _rows_group(mesh, shape))


def rows_to_block(mesh, shape) -> Plan:
    """Row slab of a global (n, m) field -> its block."""
    return plan(row_parts(mesh, shape), block_parts(mesh, shape), mesh,
                _rows_group(mesh, shape))


def rows_to_cols(mesh, shape) -> Plan:
    """Row slab of a global (n, m) field -> its column slab."""
    return plan(row_parts(mesh, shape), col_parts(mesh, shape), mesh)


def cols_to_rows(mesh, shape) -> Plan:
    """Column slab of a global (n, m) field -> its row slab."""
    return plan(col_parts(mesh, shape), row_parts(mesh, shape), mesh)


def block_to_cols(mesh, shape) -> Plan:
    """Block of a global (n, m) field -> its column slab, directly."""
    return plan(block_parts(mesh, shape), col_parts(mesh, shape), mesh)


def cols_to_block(mesh, shape) -> Plan:
    """Column slab of a global (n, m) field -> its block, directly."""
    return plan(col_parts(mesh, shape), block_parts(mesh, shape), mesh)


class Pencil(NamedTuple):
    """The moves of a pencil transform of a global (n, m) field `shape`:
    row slab -> column slab (`to_cols`) and back (`to_rows`)."""
    shape: tuple[int, int]
    to_cols: Plan
    to_rows: Plan


def pencil(mesh, shape) -> Pencil:
    """The Pencil of a global (n, m) field on `mesh`."""
    shape = tuple(shape)[-2:]
    return Pencil(shape, rows_to_cols(mesh, shape), cols_to_rows(mesh, shape))
