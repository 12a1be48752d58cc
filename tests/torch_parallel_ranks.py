"""Rank programs of tests/test_torch_parallel.py, one spawned group a
world size.  This module imports neither JAX nor cfd_julia_tpu: every rank
imports it to find its function (parallel/launch.py spawns them).

`all_cases` runs every case of the parallel slice on the rank's mesh in
fp64 on the CPU and returns the gathered global results, each as numpy.
"""
import numpy as np
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.models import cavity
from cfd_julia_torch.parallel import halo, sharded
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.poisson import multigrid
from cfd_julia_torch.utils import checkpoint

F64 = torch.float64


def _np(t):
    return t.detach().cpu().numpy()


def _gathered(block, mesh):
    return _np(sharded.gather(block, mesh))


def _cavity(inp, mesh, device):
    cfg = cavity.CavityConfig(nx=inp["cavity_n"], ny=inp["cavity_n"],
                              dt=inp["cavity_dt"])
    step = sharded.make_sharded_cavity_step(cfg, mesh, F64, device)
    w0, s0 = (np.asarray(sharded.pad_to_mesh(torch.from_numpy(a), mesh))
              for a in (inp["cavity_w0"], inp["cavity_s0"]))
    state = (interop.block_from_numpy(w0, mesh, F64, device),
             interop.block_from_numpy(s0, mesh, F64, device),
             torch.zeros((), dtype=F64, device=device))
    for _ in range(inp["cavity_steps"]):
        state = step(state)
    return state


def _checkpoints(state, mesh, device, ckpt_dir, other):
    """Save this world's cavity state, load it back on the same mesh, and
    load another world's checkpoint (`other`: (path, global shape))."""
    like = (sharded.as_dtensor(state[0], mesh),
            sharded.as_dtensor(state[1], mesh), state[2])
    checkpoint.save_sharded(ckpt_dir, like)
    zero = tuple(torch.zeros_like(t) for t in state)
    blank = (sharded.as_dtensor(zero[0], mesh),
             sharded.as_dtensor(zero[1], mesh), zero[2])
    back = checkpoint.load_sharded(ckpt_dir, blank)
    out = {"same": tuple(_gathered(t.to_local(), mesh) for t in back[:2])
           + (_np(back[2]),)}
    if other is not None:
        path, shape = other
        z = sharded.place(torch.zeros(shape, dtype=F64, device=device), mesh)
        like = (sharded.as_dtensor(z, mesh), sharded.as_dtensor(z.clone(),
                                                                mesh),
                torch.zeros((), dtype=F64, device=device))
        got = checkpoint.load_sharded(path, like)
        out["other"] = tuple(_gathered(t.to_local(), mesh)
                             for t in got[:2]) + (_np(got[2]),)
    return out


def all_cases(device, inp, ckpt_dir, other_ckpt):
    mesh = mesh_lib.make_mesh(device.type)
    out = {"mesh_shape": tuple(mesh.shape)}
    place = lambda a: interop.block_from_numpy(a, mesh, F64, device)  # noqa

    rhs = halo.make_distributed_vorticity_rhs(mesh, inp["dx"], inp["dx"],
                                              100.0)
    out["rhs"] = _gathered(rhs(place(inp["w"]), place(inp["s"])), mesh)

    sweep = halo.make_distributed_jacobi_step(mesh, inp["jdx"], inp["jdx"])
    u, f = place(np.zeros_like(inp["jf"])), place(inp["jf"])
    for _ in range(inp["jacobi_sweeps"]):
        u = sweep(u, f)
    out["jacobi"] = _gathered(u, mesh)

    line = mesh_lib.make_mesh(device.type, axis_names=("x",))
    burgers = halo.make_distributed_burgers_weno_rhs(line, inp["bdx"])
    ub = interop.field_from_numpy(inp["bu"], F64, device)
    ul = ub[mesh_lib.block_slices(ub.shape, line, ("x",))].contiguous()
    out["burgers"] = _np(halo.all_gather_axis(burgers(ul), line, "x", -1))

    state = _cavity(inp, mesh, device)
    out["cavity"] = (_gathered(state[0], mesh), _gathered(state[1], mesh),
                     _np(state[2]))
    out["checkpoint"] = _checkpoints(state, mesh, device, ckpt_dir,
                                     other_ckpt)

    f, u0 = (interop.field_from_numpy(inp[k], F64, device)
             for k in ("mg_f", "mg_u0"))
    mgc = multigrid.MGConfig(**inp["mg_cfg"])
    for name, fmg in (("mg_vcycle", False), ("mg_fmg", True)):
        cfg = multigrid.MGConfig(**{**inp["mg_cfg"], "fmg": fmg})
        r = multigrid.solve(f, u0, inp["mg_dx"], inp["mg_dx"], cfg=cfg,
                            mesh=mesh)
        out[name] = {"u": _np(r.u), "iterations": r.iterations,
                     "rel": float(r.rms / r.rms0)}
    out["mg_levels"] = {
        n: [tuple(L) for L in multigrid._mesh_levels(
            n, n, 1.0 / n, 1.0 / n, mgc.n_levels, mesh)]
        for n in inp["level_sizes"]}
    return out


def raise_on_rank(device, bad_rank):
    """Fails on `bad_rank` only; the others wait at a barrier."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise ValueError(f"deliberate failure on rank {bad_rank}")
    dist.barrier()
    return dist.get_rank()


def staged_exchange(device, shape, seed):
    """On a 2x2 mesh over gloo: halo exchanges (widths 1 and 2, a stacked
    batch) and axis gathers of CUDA blocks, staged through host memory,
    against the same calls on CPU copies of the blocks, and the exchange
    against the global field padded periodically.  Returns booleans."""
    import torch.nn.functional as F

    mesh = mesh_lib.make_mesh(device.type)
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((2, *shape)))
    blocks = g[(slice(None), *mesh_lib.block_slices(shape, mesh))]
    out = {"staged": halo.host_staged(mesh.get_group("x"),
                                      blocks.to(device))}
    for width in (1, 2):
        cuda = halo.halo_exchange_periodic(blocks.to(device), mesh, width)
        host = halo.halo_exchange_periodic(blocks, mesh, width)
        rows, cols = mesh_lib.block_slices(shape, mesh)
        framed = F.pad(g, (width,) * 4, mode="circular")[
            :, rows.start:rows.stop + 2 * width,
            cols.start:cols.stop + 2 * width]
        out[f"halo{width}"] = (torch.equal(cuda.cpu(), host)
                               and torch.equal(host, framed))
    for axis, dim in (("x", 0), ("y", 1)):
        cuda = halo.all_gather_axis(blocks[0].to(device), mesh, axis, dim)
        host = halo.all_gather_axis(blocks[0], mesh, axis, dim)
        out[f"gather_{axis}"] = torch.equal(cuda.cpu(), host)
    return out
