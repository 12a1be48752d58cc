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
callers zero-pad to it: parallel/sharded.padded_shape); the rank at
coordinate (a, b) owns rows [a P/px, (a+1) P/px) and columns
[b Q/py, (b+1) Q/py) (`block_slices`), the layout of the JAX package's
`field_sharding`.  An axis given as None is not sharded (the JAX package's
`replicated` along it): every rank holds all of it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("x", "y")


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
