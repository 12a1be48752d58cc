"""Device mesh and block layout for 2D domain decomposition on
torch.distributed (counterpart of cfd_julia_tpu/parallel/mesh.py).

The JAX package runs one program over a `jax.sharding.Mesh` ("x", "y") and
lets XLA place the shards.  Here the program is SPMD: one process a rank
(parallel/launch.py starts them), each rank holding its block of every
sharded field, and the mesh is a 2D `DeviceMesh` over the default process
group whose axis groups carry the explicit collectives of parallel/halo.py.
Rank r sits at row-major position r of the mesh, so along either axis the
group ranks ascend with the coordinate.

A sharded field of global shape (P, Q) must divide over the mesh (the
callers zero-pad to it: `padded_shape`); the rank at
coordinate (a, b) owns rows [a P/px, (a+1) P/px) and columns
[b Q/py, (b+1) Q/py) (`block_slices`), the layout of the JAX package's
`field_sharding`.  An axis given as None is not sharded (the JAX package's
`replicated` along it): every rank holds all of it.

The pencil transforms of ops/spectral.py also lay fields out in slabs: one
axis split over all ranks in flat order, the JAX package's
P(tuple(mesh.axis_names), None) (a row slab) or P(None, flat) (a column
slab).  The flat order is x-major, so the rank at flat position r is
global rank r.  A slab's extent is zero-padded up to a multiple of the
world size (`slab_slices`, `place_slab`); parallel/transpose.py moves
fields between blocks and slabs, and `flat_line` is the 1D view of all
ranks that parallel/halo.py's ring exchange uses along a slab axis.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("x", "y")
FLAT = ("flat",)


def factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization of n ranks into (px, py)."""
    px = int(math.isqrt(n))
    while n % px:
        px -= 1
    return px, n // px


def make_mesh(device_type: str = "cuda", axis_names=AXES) -> DeviceMesh:
    """A DeviceMesh over every rank of the default process group (which
    parallel/launch.py initialises), shaped factor_2d(world size) for two
    axis names, or a line of all ranks for one (axis_names=("x",))."""
    world = dist.get_world_size()
    if len(axis_names) not in (1, 2):
        raise ValueError(f"a mesh has one or two axes, got {axis_names}")
    shape = factor_2d(world) if len(axis_names) == 2 else (world,)
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis) -> int:
    """Ranks along `axis` (1 for None: the field is not sharded on it)."""
    return 1 if axis is None else mesh.size(mesh.mesh_dim_names.index(axis))


def coordinate(mesh: DeviceMesh, axis) -> int:
    """This rank's coordinate along `axis` (0 for None)."""
    if axis is None:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def neighbour_ranks(mesh: DeviceMesh, axis) -> tuple[int, int]:
    """Global ranks of this rank's ring neighbours along `axis`: the one at
    coordinate c - 1 and the one at c + 1, periodic."""
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    n = mesh.size(dim)
    out = []
    for shift in (-1, 1):
        c = list(coord)
        c[dim] = (coord[dim] + shift) % n
        out.append(int(mesh.mesh[tuple(c)]))
    return out[0], out[1]


def world_size(mesh: DeviceMesh) -> int:
    """The mesh's ranks, every axis together."""
    return math.prod(mesh.shape)


def flat_line(mesh: DeviceMesh) -> DeviceMesh:
    """A 1D mesh ("flat",) of the mesh's ranks in flat order: the ring of a
    slab axis.  Over every rank of the default group, its group is that
    group (no new one is made), but build it once, when a step is built,
    on every rank in the same order, as any mesh."""
    return DeviceMesh(mesh.device_type,
                      torch.arange(world_size(mesh)), mesh_dim_names=FLAT)


def slab_extent(n: int, mesh: DeviceMesh) -> int:
    """Rows (or columns) a rank holds of an extent n split over all ranks:
    n rounded up to a multiple of the world size, then divided."""
    p = world_size(mesh)
    return -(-n // p)


def slab_slices(shape, mesh: DeviceMesh, dim: int) -> tuple[slice, slice]:
    """This rank's slab of a global (n, m) field with axis `dim` split over
    all ranks in flat order: (rows, cols) slices of the field zero-padded
    along `dim` to slab_extent * world size; the other axis is whole.
    dim -2 (or 0): a row slab; dim -1 (or 1): a column slab."""
    n, m = tuple(shape)[-2:]
    r = dist.get_rank()
    if dim in (-2, 0):
        b = slab_extent(n, mesh)
        return slice(r * b, (r + 1) * b), slice(0, m)
    if dim in (-1, 1):
        b = slab_extent(m, mesh)
        return slice(0, n), slice(r * b, (r + 1) * b)
    raise ValueError(f"a slab splits dim -2 or -1, got {dim}")


def place_slab(t, mesh: DeviceMesh, dim: int = -2, fill: float = 0.0):
    """This rank's slab of a global (.., n, m) tensor (a copy): axis `dim`
    (-2: rows, -1: columns) split over all ranks in flat order, its
    padding past n (or m) set to `fill`."""
    dim = dim - t.dim() if dim >= 0 else dim
    n = t.shape[dim]
    pad = slab_extent(n, mesh) * world_size(mesh) - n
    fill_shape = list(t.shape)
    fill_shape[dim] = pad
    whole = torch.cat([t, t.new_full(fill_shape, fill)], dim=dim)
    return whole[(..., *slab_slices(whole.shape, mesh, dim))].contiguous()


def padded_shape(shape, mesh: DeviceMesh) -> tuple[int, int]:
    """`shape` rounded up to multiples of the mesh's (px, py)."""
    return tuple(-(-n // p) * p for n, p in zip(tuple(shape)[-2:],
                                                 mesh.shape))


def block_slices(shape, mesh: DeviceMesh, axes=AXES) -> tuple[slice, ...]:
    """This rank's block of a global field: one slice for each of the
    field's last len(axes) dims, the rows (or columns) the rank owns along
    its axis, or all of them where the axis is None.  Raises where a
    sharded extent does not divide over its ranks."""
    shape = tuple(shape)[-len(axes):]
    out = []
    for n, axis in zip(shape, axes):
        p = axis_size(mesh, axis)
        if n % p:
            raise ValueError(f"extent {n} does not divide over the {p} ranks "
                             f"of mesh axis {axis!r}; pad the field first "
                             "(parallel/sharded.pad_to_mesh)")
        b = n // p
        c = coordinate(mesh, axis)
        out.append(slice(c * b, (c + 1) * b))
    return tuple(out)
