"""Explicit collectives over the mesh: halo exchanges by point-to-point
messages, gathers along one mesh axis and sums over all ranks, and the
distributed stencils built on them (counterpart of
cfd_julia_tpu/parallel/halo.py).

The stencil half of every solver needs a 1-2 node halo from each
neighbour, the TPU-native equivalent of the reference's ghost-cell copies
(vm.jl:30-76).  Where the JAX package moves those edges with
`lax.ppermute`, `halo_exchange_periodic` sends them with
`dist.batch_isend_irecv` on the axis's group; the stencil then runs on the
padded local block.  An axis with one rank (or not sharded: None) wraps
its own edges, with no message.

Transport follows the group's backend: NCCL moves CUDA tensors in place;
gloo moves host tensors only (for CUDA tensors it has neither send / recv
nor all_gather), so under gloo every collective here stages CUDA tensors
through host memory (`host_staged`).  That is how several ranks share one
GPU, where NCCL refuses two ranks on the same device.  The choice is made
from the backend, never on an error.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from cfd_julia_torch.ops import arakawa, cuda_kernels, weno
from cfd_julia_torch.parallel import mesh as mesh_lib


def host_staged(group, t) -> bool:
    """True where `group`'s backend cannot move the CUDA tensor t: gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def transport(mesh, device) -> str:
    """How this mesh moves fields on `device` (halos, gathers and the
    transposes of parallel/transpose.py alike), for a run's log."""
    backend = dist.get_backend()
    if all(n == 1 for n in mesh.shape):
        return (f"backend {backend}, one rank: halos wrap in place, "
                "transposes are no-ops")
    if torch.device(device).type != "cuda":
        return (f"backend {backend}, halos, gathers and transposes in host "
                "memory")
    staged = backend == "gloo"
    return (f"backend {backend}, halos, gathers and transposes "
            f"{'staged through host memory' if staged else 'on the device'}")


def _stage(t, staged):
    return t.contiguous().cpu() if staged else t.contiguous()


def _edges_from_neighbours(ul, mesh, axis, dim: int, width: int):
    """(low halo, high halo) of ul along tensor dim `dim`: the high edge of
    the ring neighbour at coordinate c - 1 and the low edge of the one at
    c + 1 on mesh axis `axis`."""
    lo_edge = ul.narrow(dim, 0, width)
    hi_edge = ul.narrow(dim, ul.shape[dim] - width, width)
    if mesh_lib.axis_size(mesh, axis) == 1:
        return hi_edge, lo_edge
    group = mesh.get_group(axis)
    lo_rank, hi_rank = mesh_lib.neighbour_ranks(mesh, axis)
    staged = host_staged(group, ul)
    send_hi, send_lo = _stage(hi_edge, staged), _stage(lo_edge, staged)
    lo_halo, hi_halo = torch.empty_like(send_hi), torch.empty_like(send_lo)
    # the upward messages (tag 0) before the downward ones (tag 1): with two
    # ranks both neighbours are one rank, and the two pairs must not cross
    ops = [dist.P2POp(dist.isend, send_hi, hi_rank, group, 0),
           dist.P2POp(dist.irecv, lo_halo, lo_rank, group, 0),
           dist.P2POp(dist.isend, send_lo, lo_rank, group, 1),
           dist.P2POp(dist.irecv, hi_halo, hi_rank, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        lo_halo, hi_halo = lo_halo.to(ul.device), hi_halo.to(ul.device)
    return lo_halo, hi_halo


def halo_exchange_periodic(ul, mesh, width: int = 1,
                           axes=mesh_lib.AXES):
    """Pad a local block with `width` halo rows / columns from its ring
    neighbours, periodic global topology: (..., bx, by) ->
    (..., bx + 2w, by + 2w).  The x pass first, then the y pass on the
    x-padded block, so that the corners arrive.  Leading axes are a batch:
    stacking several operands rides one exchange.  axes: the mesh axes of
    the block's two dims, None where the field is not sharded (its own
    edges wrap)."""
    ax, ay = axes
    lo, hi = _edges_from_neighbours(ul, mesh, ax, -2, width)
    up = torch.cat([lo, ul, hi], dim=-2)
    lo, hi = _edges_from_neighbours(up, mesh, ay, -1, width)
    return torch.cat([lo, up, hi], dim=-1)


def halo_exchange_1d_periodic(ul, mesh, axis: str, width: int):
    """Pad a local 1D block with `width` ring-neighbour values per side."""
    lo, hi = _edges_from_neighbours(ul, mesh, axis, -1, width)
    return torch.cat([lo, ul, hi], dim=-1)


def all_gather_axis(t, mesh, axis, dim: int):
    """The blocks of the ranks along mesh axis `axis` (this rank's and
    theirs), concatenated along tensor dim `dim` in coordinate order: the
    JAX package's gather of a dense matmul's operand.  t itself for an axis
    of one rank or None."""
    n = mesh_lib.axis_size(mesh, axis)
    if n == 1:
        return t
    group = mesh.get_group(axis)
    staged = host_staged(group, t)
    src = _stage(t, staged)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def all_reduce_sum(t):
    """The sum of t over every rank (the default group: the whole mesh)."""
    staged = host_staged(None, t)
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device) if staged else buf


def make_distributed_vorticity_rhs(mesh, dx: float, dy: float, re: float,
                                   impl: str = "kernel"):
    """r = -J(w, s) + lap(w)/re over a 2D-decomposed periodic field, on
    local blocks: (w_block, s_block) -> r_block.  One stacked width-1 halo
    exchange for both operands, then kernel 1
    (cuda_kernels.arakawa_rhs_fused; its twin on the CPU) on the padded
    block, or with impl="torch" the plain ops.arakawa.vorticity_rhs.  The
    RHS is periodic over the block, and its 17-point stencil never
    reaches a wrapped value from the [1:-1, 1:-1] interior, which is the
    rank's block."""
    if impl not in ("kernel", "torch"):
        raise ValueError(f"unknown rhs impl {impl!r} (kernel | torch)")
    fn = cuda_kernels.arakawa_rhs_fused if impl == "kernel" \
        else arakawa.vorticity_rhs

    def rhs(wl, sl):
        bp = halo_exchange_periodic(torch.stack([wl, sl]), mesh, 1)
        return fn(bp[0], bp[1], dx, dy, re)[1:-1, 1:-1]

    return rhs


def slab_jacobian(w, s, dx: float, dy: float, line):
    """Arakawa J(w, s) on row slabs of periodic fields: one width-1 ring
    exchange of the stacked operands over `line` (mesh.flat_line) along
    the slab axis; the whole y axis wraps in place."""
    ext = halo_exchange_periodic(torch.stack([w, s]), line, 1,
                                 axes=(line.mesh_dim_names[0], None))
    return arakawa.jacobian(ext[0], ext[1], dx, dy)[..., 1:-1, 1:-1]


def make_distributed_burgers_weno_rhs(mesh, dx: float,
                                      axis_name: str | None = None):
    """Periodic WENO-5 Burgers RHS over a 1D-decomposed line, on local
    blocks: one width-3 halo exchange, then the local reconstruction of
    both edge-state families and the upwind derivative
    (weno_periodic.jl:58-68 semantics; models.burgers1d
    ._rhs_upwind_periodic is the single-device form)."""
    axis_name = axis_name or mesh.mesh_dim_names[0]

    def rhs(ul):
        n = ul.shape[-1]
        up = halo_exchange_1d_periodic(ul, mesh, axis_name, 3)
        # uL[j] for j = -1..n-1: stencil u_{j-2..j+2} -> pad idx k..k+n
        u_left = weno.weno5_L(*[up[..., k:k + n + 1] for k in range(5)])
        # uR[j] for j = 0..n: pad idx 1+k..1+k+n
        u_right = weno.weno5_R(*[up[..., 1 + k:1 + k + n + 1]
                                 for k in range(5)])
        dpos = (u_left[..., 1:] - u_left[..., :-1]) / dx
        dneg = (u_right[..., 1:] - u_right[..., :-1]) / dx
        return -ul * torch.where(ul >= 0.0, dpos, dneg)

    return rhs


def make_distributed_jacobi_step(mesh, dx: float, dy: float):
    """One distributed point-Jacobi sweep for periodic Poisson lap(u) = f
    on local blocks (the zero-mean gauge is the caller's)."""
    diag = -2.0 / dx**2 - 2.0 / dy**2

    def sweep(ul, fl):
        up = halo_exchange_periodic(ul, mesh, 1)
        r = fl - arakawa.laplacian(up, dx, dy)[1:-1, 1:-1]
        return ul + r / diag

    return sweep
