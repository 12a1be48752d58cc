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

Gradients: each collective runs as an autograd Function whose backward
is its transpose (the JAX package's transposes of ppermute, all_gather,
psum and pbroadcast), its messages staged as the forward's; without grad
the Function's forward is the whole of the call, the same code.  A
halo's gradient goes back to the rank it came from; a gather's is summed
over the axis (a reduce-scatter); all_reduce_sum's replicated output
passes its cotangent through; `replicate` (the identity) sums it over
the ranks.  So each rank's loss is all_reduce_sum(local), and its
.backward() on every rank leaves a replicated leaf (a tensor Re entered
through `replicate`) the whole gradient and every rank its blocks'.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

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


def _shift(up, down, mesh, axis):
    """One ring exchange along mesh axis `axis` (more than one rank): send
    `up` to the neighbour at coordinate c + 1 and `down` to the one at
    c - 1; return (what c - 1 sent up, what c + 1 sent down)."""
    group = mesh.get_group(axis)
    lo_rank, hi_rank = mesh_lib.neighbour_ranks(mesh, axis)
    staged = host_staged(group, up)
    send_up, send_down = _stage(up, staged), _stage(down, staged)
    from_lo, from_hi = torch.empty_like(send_up), torch.empty_like(send_down)
    # the upward messages (tag 0) before the downward ones (tag 1): with two
    # ranks both neighbours are one rank, and the two pairs must not cross
    ops = [dist.P2POp(dist.isend, send_up, hi_rank, group, 0),
           dist.P2POp(dist.irecv, from_lo, lo_rank, group, 0),
           dist.P2POp(dist.isend, send_down, lo_rank, group, 1),
           dist.P2POp(dist.irecv, from_hi, hi_rank, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        from_lo, from_hi = from_lo.to(up.device), from_hi.to(up.device)
    return from_lo, from_hi


class _Halos(torch.autograd.Function):
    """(lo edge, hi edge) of a block -> (lo halo, hi halo) from the ring
    neighbours.  The backward is the exchange's transpose: each halo's
    gradient goes back to the rank it came from, as the gradient of that
    rank's edge (the lo halo's down, the hi halo's up), by the same
    exchange with the same tags."""

    @staticmethod
    def forward(ctx, lo_edge, hi_edge, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(hi_edge, lo_edge, mesh, axis)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lo, g_hi):
        g_lo_edge, g_hi_edge = _shift(g_hi, g_lo, ctx.mesh, ctx.axis)
        return g_lo_edge, g_hi_edge, None, None


def _edges_from_neighbours(ul, mesh, axis, dim: int, width: int):
    """(low halo, high halo) of ul along tensor dim `dim`: the high edge of
    the ring neighbour at coordinate c - 1 and the low edge of the one at
    c + 1 on mesh axis `axis`.  Differentiable: with one rank on the axis
    autograd adds each halo's gradient into the opposite edge; with more,
    _Halos sends it back."""
    lo_edge = ul.narrow(dim, 0, width)
    hi_edge = ul.narrow(dim, ul.shape[dim] - width, width)
    if mesh_lib.axis_size(mesh, axis) == 1:
        return hi_edge, lo_edge
    return _Halos.apply(lo_edge, hi_edge, mesh, axis)


def halo_exchange_periodic(ul, mesh, width: int = 1,
                           axes=mesh_lib.AXES):
    """Pad a local block with `width` halo rows / columns from its ring
    neighbours, periodic global topology: (..., bx, by) ->
    (..., bx + 2w, by + 2w).  The x pass first, then the y pass on the
    x-padded block, so that the corners arrive.  Leading axes are a batch:
    stacking several operands rides one exchange.  axes: the mesh axes of
    the block's two dims, None where the field is not sharded (its own
    edges wrap).  Differentiable: the backward undoes the y pass, then the
    x pass, so the corners' gradients travel back through both."""
    ax, ay = axes
    lo, hi = _edges_from_neighbours(ul, mesh, ax, -2, width)
    up = torch.cat([lo, ul, hi], dim=-2)
    lo, hi = _edges_from_neighbours(up, mesh, ay, -1, width)
    return torch.cat([lo, up, hi], dim=-1)


def halo_exchange_1d_periodic(ul, mesh, axis: str, width: int):
    """Pad a local 1D block with `width` ring-neighbour values per side."""
    lo, hi = _edges_from_neighbours(ul, mesh, axis, -1, width)
    return torch.cat([lo, ul, hi], dim=-1)


def _gather(t, group, n: int, dim: int):
    staged = host_staged(group, t)
    src = _stage(t, staged)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def _reduce_scatter(g, group, n: int, dim: int):
    """The transpose of _gather: the sum over the group's ranks of their
    g's slice that this rank's block gave, added in rank order (one
    all_to_all_single, then a local sum: the same bits every run, on NCCL
    and gloo alike; gloo has no reduce_scatter of such tensors)."""
    pieces = g.chunk(n, dim)
    send = _stage(torch.cat([p.reshape(-1) for p in pieces]),
                  host_staged(group, g))
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    parts = got.to(g.device).split(pieces[0].numel())
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total.view(pieces[0].shape)


class _Gather(torch.autograd.Function):
    """all_gather_axis, whose backward is a reduce-scatter along the axis."""

    @staticmethod
    def forward(ctx, t, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(t, group, n, dim)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.n, ctx.dim), None, None, None


def all_gather_axis(t, mesh, axis, dim: int):
    """The blocks of the ranks along mesh axis `axis` (this rank's and
    theirs), concatenated along tensor dim `dim` in coordinate order: the
    JAX package's gather of a dense matmul's operand.  t itself for an axis
    of one rank or None.  Differentiable: each rank's gradient of the
    gathered tensor is summed over the axis into the block it came from."""
    n = mesh_lib.axis_size(mesh, axis)
    if n == 1:
        return t
    return _Gather.apply(t, mesh.get_group(axis), n, dim)


def _sum_over_ranks(t):
    staged = host_staged(None, t)
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device) if staged else buf


class _AllReduceSum(torch.autograd.Function):
    """all_reduce_sum.  Its output is replicated, and the cotangent of a
    replicated tensor is the same on every rank and stands for one copy,
    so the backward passes it through (JAX's psum transpose)."""

    @staticmethod
    def forward(ctx, t):
        return _sum_over_ranks(t)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return g


def all_reduce_sum(t):
    """The sum of t over every rank (the default group: the whole mesh),
    replicated.  A rank's loss is all_reduce_sum(local.sum()); its
    .backward() on every rank leaves each rank its own share of the
    gradient, which `replicate` sums where a replicated leaf entered."""
    return _AllReduceSum.apply(t)


class _Replicate(torch.autograd.Function):
    """replicate: the identity, whose backward sums the gradient over
    every rank (JAX's pbroadcast transpose)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _sum_over_ranks(g)


def replicate(t, mesh):
    """t, a tensor every rank holds alike (a replicated leaf such as a
    tensor Re), as it enters this rank's local work: the identity, and in
    the backward the sum over the mesh's ranks of the local gradients, so
    that every rank holds the whole gradient of the global loss.  t itself
    on one rank or for a number."""
    if not isinstance(t, torch.Tensor) or mesh_lib.world_size(mesh) == 1:
        return t
    return _Replicate.apply(t)


def make_distributed_vorticity_rhs(mesh, dx: float, dy: float, re,
                                   impl: str = "kernel"):
    """r = -J(w, s) + lap(w)/re over a 2D-decomposed periodic field, on
    local blocks: (w_block, s_block) -> r_block.  One stacked width-1 halo
    exchange for both operands, then kernel 1
    (cuda_kernels.arakawa_rhs_fused; its twin on the CPU) on the padded
    block, or with impl="torch" the plain ops.arakawa.vorticity_rhs.  The
    RHS is periodic over the block, and its 17-point stencil never
    reaches a wrapped value from the [1:-1, 1:-1] interior, which is the
    rank's block.  re: a float, or a tensor every rank holds alike, which
    enters through `replicate` (the RHS is then differentiable in it)."""
    if impl not in ("kernel", "torch"):
        raise ValueError(f"unknown rhs impl {impl!r} (kernel | torch)")
    fn = cuda_kernels.arakawa_rhs_fused if impl == "kernel" \
        else arakawa.vorticity_rhs

    def rhs(wl, sl):
        bp = halo_exchange_periodic(torch.stack([wl, sl]), mesh, 1)
        return fn(bp[0], bp[1], dx, dy, replicate(re, mesh))[1:-1, 1:-1]

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
