"""Rank programs of tests/test_torch_parallel_grad.py, one spawned group a
world size.  This module imports neither JAX nor cfd_julia_tpu: every rank
imports it to find its function (parallel/launch.py spawns them).

`all_cases` runs every case of the mesh gradients on the rank's mesh in
fp64 on the CPU: the adjoint identity of each collective and pencil move,
the gradients of the cavity (fst, fst_half and the matmul form), the fdm
RHS and the ps23 half step, and the no-grad forwards against the tracked
ones.  It returns numbers and gathered global arrays as numpy.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cfd_julia_torch.models import cavity, vortex
from cfd_julia_torch.parallel import halo, sharded, transpose
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.stepping import ssprk3

F64 = torch.float64
# ragged extents, as tests/test_torch_parallel_spectral.py's
TRANSPOSE_SHAPES = {"31x17": (31, 17), "32x17": (32, 17), "32x32": (32, 32),
                    "34x34": (34, 34)}
# the block of every rank in the collectives' identities
BLOCK = (6, 5)
MOVES = ("rows_to_cols", "cols_to_rows", "block_to_rows", "rows_to_block",
         "block_to_cols", "cols_to_block")


def _np(t):
    return t.detach().cpu().numpy()


def _rng(seed):
    """A generator whose draws differ between ranks."""
    return np.random.default_rng([seed, dist.get_rank()])


def _randn(rng, shape, complex_=False):
    a = rng.standard_normal(shape)
    if complex_:
        a = a + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a)


def _dot(a, b):
    """The real inner product <a, b> (of the real and imaginary parts for
    complex tensors), in fp64."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a * b).sum())


def _total(x: float) -> float:
    t = torch.tensor(x, dtype=F64)
    dist.all_reduce(t)
    return float(t)


def _adjoint(op, x, y, x_replicated=False, y_replicated=False):
    """(sum over ranks of <op(x), y>, sum over ranks of <x, op^T y>, the
    transpose bitwise the same in two runs, op(x) without grad bitwise the
    tracked op(x) and untracked).  A replicated side counts once."""
    def run():
        xt = x.clone().requires_grad_()
        out = op(xt)
        (g,) = torch.autograd.grad(out, xt, y)
        return out.detach(), g

    out, g = run()
    _, g2 = run()
    with torch.no_grad():
        plain = op(x)
    lhs, rhs = _dot(out, y), _dot(x, g)
    lhs = lhs if y_replicated else _total(lhs)
    rhs = rhs if x_replicated else _total(rhs)
    return {"lhs": lhs, "rhs": rhs, "bitwise": torch.equal(g, g2),
            "nograd": torch.equal(plain, out) and plain.grad_fn is None}


def _layout(mesh, name, shape):
    """(source tensor shape, plan) of the move `name` of a global `shape`."""
    src = {"rows": transpose.row_parts, "cols": transpose.col_parts,
           "block": transpose.block_parts}[name.split("_to_")[0]]
    return src(mesh, shape)[dist.get_rank()].shape, \
        getattr(transpose, name)(mesh, shape)


def adjoints(mesh):
    """The adjoint identity of every collective and move on this mesh."""
    rng = _rng(20)
    line = mesh_lib.make_mesh("cpu", ("x",))
    out = {}
    for w in (1, 2):
        x = _randn(rng, (2, *BLOCK))
        y = _randn(rng, (2, BLOCK[0] + 2 * w, BLOCK[1] + 2 * w))
        out[f"halo_2d_w{w}"] = _adjoint(
            lambda t, w=w: halo.halo_exchange_periodic(t, mesh, w), x, y)
    x, y = _randn(rng, (3, 7)), _randn(rng, (3, 13))
    out["halo_1d_w3"] = _adjoint(
        lambda t: halo.halo_exchange_1d_periodic(t, line, "x", 3), x, y)
    px, py = mesh.shape
    for axis, dim, n in (("x", 0, px), ("y", 1, py)):
        x = _randn(rng, BLOCK)
        gathered = list(BLOCK)
        gathered[dim] *= n
        y = _randn(rng, gathered)
        out[f"gather_{axis}"] = _adjoint(
            lambda t, axis=axis, dim=dim: halo.all_gather_axis(t, mesh, axis,
                                                               dim), x, y)
    same = np.random.default_rng(21)
    x, y = _randn(rng, (4,)), torch.from_numpy(same.standard_normal(4))
    out["all_reduce_sum"] = _adjoint(halo.all_reduce_sum, x, y,
                                     y_replicated=True)
    x, y = torch.from_numpy(same.standard_normal(3)), _randn(rng, (3,))
    out["replicate"] = _adjoint(lambda t: halo.replicate(t, mesh), x, y,
                                x_replicated=True)
    for key, shape in TRANSPOSE_SHAPES.items():
        for name in MOVES:
            if name.startswith("block") or name.endswith("block"):
                if shape[0] % px or shape[1] % py:
                    continue
            src_shape, plan = _layout(mesh, name, shape)
            x = _randn(rng, (2, *src_shape), complex_=True)
            y = _randn(rng, (2, *plan.shape), complex_=True)
            out[f"{name}_{key}"] = _adjoint(
                lambda t, plan=plan: transpose.move(t, plan), x, y)
    return out


def _cavity_cfg(inp, poisson):
    return cavity.CavityConfig(nx=inp["n"], ny=inp["n"], poisson=poisson)


def _cavity_run(step, w0, steps):
    state = (w0, torch.zeros_like(w0), torch.zeros((), dtype=F64))
    for _ in range(steps):
        state = step(state)
    return state


def _cavity_loss(state):
    return (state[1] ** 2).sum() + (state[0] ** 2).sum()


def cavity_grads(device, inp, mesh, poisson):
    """d loss/dRe (a 0-d tensor Re) and d loss/d(initial w) of the mesh
    step (the padded blocks gathered), loss = sum psi^2 + sum w^2 after
    the run, and the step's output without grad and tracked, bitwise."""
    cfg = _cavity_cfg(inp, poisson)
    shape = mesh_lib.padded_shape((cfg.nx + 1, cfg.ny + 1), mesh)
    w_np = np.zeros(shape)
    w_np[:cfg.nx + 1, :cfg.ny + 1] = inp["cavity_w0"]
    w0 = sharded.place(torch.from_numpy(w_np).to(device), mesh)
    if poisson == "matmul":
        re = None
        step = sharded.make_sharded_cavity_step(
            dataclasses.replace(cfg, re=inp["re"]), mesh, F64, device)
    else:
        re = torch.tensor(inp["re"], dtype=F64, requires_grad=True)
        step = cavity.make_step_fn(cfg, F64, device, re=re, mesh=mesh)
    x = w0.clone().requires_grad_()
    final = _cavity_run(step, x, inp["cavity_steps"])
    halo.all_reduce_sum(_cavity_loss(final)).backward()
    with torch.no_grad():
        plain = _cavity_run(step, w0, inp["cavity_steps"])
    out = {"w_grad": _np(sharded.gather(x.grad, mesh)),
           "nograd": all(torch.equal(a, b.detach()) and a.grad_fn is None
                         for a, b in zip(plain, final))}
    if re is not None:
        out["re_grad"] = float(re.grad)
    return out


def single_cavity_grads(device, inp, poisson):
    """The single-device step's gradients of cavity_grads's loss."""
    cfg = _cavity_cfg(inp, poisson)
    re = torch.tensor(inp["re"], dtype=F64, requires_grad=True)
    step = cavity.make_step_fn(cfg, F64, device, re=re)
    x = torch.from_numpy(inp["cavity_w0"]).to(device).requires_grad_()
    _cavity_loss(_cavity_run(step, x, inp["cavity_steps"])).backward()
    return {"re_grad": float(re.grad), "w_grad": _np(x.grad)}


def _fdm_cfg(inp):
    return vortex.VortexConfig(nx=inp["n"], ny=inp["n"], solver="fdm",
                               dt=inp["full_dt"])


def fdm_grad(device, inp, mesh):
    """d sum(w^2)/dRe after SSP-RK3 steps over make_fdm_rhs(mesh=, re=a
    0-d tensor), and the run without grad bitwise the tracked one."""
    cfg = _fdm_cfg(inp)
    re = torch.tensor(inp["fdm_re"], dtype=F64, requires_grad=True)
    rhs = vortex.make_fdm_rhs(cfg, F64, device, re=re, mesh=mesh)
    w0 = sharded.place(torch.from_numpy(inp["w0"]).to(device), mesh)

    def run(w):
        for _ in range(inp["cavity_steps"]):
            w = ssprk3.ssprk3_step(rhs, w, cfg.dt)
        return w

    w = run(w0)
    halo.all_reduce_sum((w ** 2).sum()).backward()
    with torch.no_grad():
        plain = run(w0)
    return {"re_grad": float(re.grad),
            "nograd": torch.equal(plain, w.detach()) and plain.grad_fn is None}


def _half_loss(step, w0, n, steps, mesh=None):
    h = vortex.half_init(w0, mesh)
    for _ in range(steps):
        h = step(h)
    return (vortex.half_decode(h, n, n, mesh) ** 2).sum()


def half_grad(device, inp, mesh):
    """d sum(w^2)/d(initial w) of the ps23 half step on row slabs (the
    slabs gathered), and the loss without grad bitwise the tracked one."""
    n = inp["n"]
    cfg = vortex.VortexConfig(nx=n, ny=n, solver="ps23", dt=inp["half_dt"])
    step = vortex.make_spectral_step_half(cfg, F64, device, mesh=mesh)
    w0 = mesh_lib.place_slab(torch.from_numpy(inp["w0"]).to(device), mesh)
    x = w0.clone().requires_grad_()
    local = _half_loss(step, x, n, inp["steps"], mesh)
    halo.all_reduce_sum(local).backward()
    with torch.no_grad():
        plain = _half_loss(step, w0, n, inp["steps"], mesh)
    return {"w_grad": _np(sharded.gather_slab(x.grad, mesh, (n, n))),
            "nograd": torch.equal(plain, local.detach())}


def single_half_grad(device, inp):
    n = inp["n"]
    cfg = vortex.VortexConfig(nx=n, ny=n, solver="ps23", dt=inp["half_dt"])
    step = vortex.make_spectral_step_half(cfg, F64, device)
    x = torch.from_numpy(inp["w0"]).to(device).requires_grad_()
    _half_loss(step, x, n, inp["steps"]).backward()
    return _np(x.grad)


def matmul_refusal(device, inp, mesh):
    """The message of the matmul mesh step given a tensor Re."""
    try:
        sharded.make_sharded_cavity_step(
            _cavity_cfg(inp, "matmul"), mesh, F64, device,
            re=torch.tensor(inp["re"], dtype=F64))
    except ValueError as e:
        return str(e)
    return None


def all_cases(device, inp):
    mesh = mesh_lib.make_mesh("cpu")
    out = {"mesh_shape": tuple(mesh.shape), "adjoint": adjoints(mesh),
           "cavity": {p: cavity_grads(device, inp, mesh, p)
                      for p in ("fst", "fst_half", "matmul")},
           "fdm": fdm_grad(device, inp, mesh),
           "half": half_grad(device, inp, mesh),
           "matmul_refusal": matmul_refusal(device, inp, mesh)}
    if dist.get_world_size() == 1:
        out["single"] = {
            "cavity": {p: single_cavity_grads(device, inp, p)
                       for p in ("fst", "fst_half")},
            "half": single_half_grad(device, inp)}
    return out
