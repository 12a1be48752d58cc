"""Rank programs of tests/test_torch_parallel_spectral.py, one spawned group
a world size.  This module imports neither JAX nor cfd_julia_tpu: every
rank imports it to find its function (parallel/launch.py spawns them).

`all_cases` runs every case of the spectral mesh slice on the rank's mesh
in fp64 on the CPU and returns the gathered global results as numpy, then
runs one step of each path again with every gather made to raise.
"""
import numpy as np
import torch
import torch.distributed as dist

from cfd_julia_torch import interop
from cfd_julia_torch.models import cavity, vortex
from cfd_julia_torch.ops import spectral
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.parallel import sharded, transpose
from cfd_julia_torch.poisson import direct

F64 = torch.float64
SOLVERS = ("ps23", "ps32", "hybrid", "fdm")
HALF_SOLVERS = ("ps23", "ps32", "hybrid")


def _np(t):
    return t.detach().cpu().numpy()


def _rows(a, mesh):
    return interop.slab_from_numpy(a, mesh, -2, F64)


def _cols(a, mesh):
    return interop.slab_from_numpy(a, mesh, -1, F64)


def _from_rows(t, mesh, shape):
    return _np(sharded.gather_slab(t, mesh, shape, -2))


def _from_cols(t, mesh, shape):
    return _np(sharded.gather_slab(t, mesh, shape, -1))


def _transposes(inp, mesh):
    """Each move of parallel/transpose.py against the global array's slices
    (bitwise), and the round trips."""
    out = {}
    for key, g in inp["transpose"].items():
        shape = g.shape[-2:]
        gt = interop.field_from_numpy(g, F64)
        rows, cols = _rows(g, mesh), _cols(g, mesh)
        pencil = transpose.pencil(mesh, shape)
        to_cols = transpose.move(rows, pencil.to_cols)
        back = transpose.move(to_cols, pencil.to_rows)
        res = {"rows_to_cols": torch.equal(to_cols, cols),
               "cols_to_rows": torch.equal(transpose.move(
                   cols, pencil.to_rows), rows),
               "round_trip": torch.equal(back, rows),
               "rows_are_slices": torch.equal(
                   _np_tensor(_from_rows(rows, mesh, shape)), gt),
               "cols_are_slices": torch.equal(
                   _np_tensor(_from_cols(cols, mesh, shape)), gt)}
        px, py = mesh.shape
        if shape[0] % px == 0 and shape[1] % py == 0:
            block = sharded.place(gt, mesh)
            for name, src, want in [("block_to_rows", block, rows),
                                    ("rows_to_block", rows, block),
                                    ("block_to_cols", block, cols),
                                    ("cols_to_block", cols, block)]:
                plan = getattr(transpose, name)(mesh, shape)
                res[name] = torch.equal(transpose.move(src, plan), want)
        out[key] = res
    return out


def _np_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _transforms(inp, mesh):
    out = {}
    for key, x in inp["transform"].items():
        shape = x.shape
        nx, ny = shape
        half = (nx, ny // 2 + 1)
        xr = _rows(x, mesh)
        full = transpose.pencil(mesh, shape)
        hp = transpose.pencil(mesh, half)
        out[key] = {
            "fft2": _from_cols(spectral.fft2(xr, full), mesh, shape),
            "ifft2": _from_rows(spectral.ifft2(
                _cols(inp["spectrum"][key], mesh), full), mesh, shape),
            "rfft2": _from_cols(spectral.rfft2(xr, hp), mesh, half),
            "irfft2": _from_rows(spectral.irfft2(
                _cols(inp["half"][key], mesh), nx, ny, hp), mesh, shape)}
    v = inp["dst"]
    shape = v.shape
    pencil = transpose.pencil(mesh, shape)
    for impl in ("rfft", "half"):
        out[f"dst_{impl}"] = {
            "axis-1": _from_rows(spectral.dst1(_rows(v, mesh), -1, impl,
                                               mesh=mesh), mesh, shape),
            "axis-2": _from_cols(spectral.dst1(_cols(v, mesh), -2, impl,
                                               mesh=mesh), mesh, shape),
            "dst1_2d": _from_cols(spectral.dst1_2d(_rows(v, mesh), impl,
                                                   pencil), mesh, shape),
            "idst1_2d": _from_rows(spectral.idst1_2d(
                _cols(v, mesh), 7, 9, impl, pencil), mesh, shape),
            "fst": _from_rows(spectral.fst_poisson_dirichlet(
                _rows(v, mesh), inp["dx"], inp["dy"], impl, mesh, shape),
                mesh, shape)}
    f = inp["periodic"]
    out["fft_poisson"] = {eigen: _from_rows(spectral.fft_poisson_periodic(
        _rows(f, mesh), inp["dx"], inp["dy"], eigen, mesh=mesh,
        shape=f.shape), mesh, f.shape) for eigen in ("fdm", "spectral")}
    grid = inp["grid"]
    padded = sharded.pad_to_mesh(interop.field_from_numpy(grid, F64), mesh)
    block = sharded.place(padded, mesh)
    out["solve_fft"] = _np(sharded.gather(direct.solve_fft(
        block, inp["dx"], inp["dy"], mesh=mesh, shape=grid.shape), mesh))
    for impl in ("rfft", "half"):
        out[f"solve_fst_{impl}"] = _np(sharded.gather(direct.solve_fst(
            block, inp["dx"], inp["dy"], impl, mesh, grid.shape), mesh))
    return out


def _vortex_cfg(solver, dt):
    return vortex.VortexConfig(nx=32, ny=32, solver=solver, dt=dt)


def _full_steps(inp, mesh, steps):
    out = {}
    for solver in SOLVERS:
        cfg = _vortex_cfg(solver, inp["full_dt"])
        step = sharded.make_sharded_vortex_step(cfg, mesh, F64, "cpu")
        x0 = inp["w0"] if solver == "fdm" else inp["wf0"]
        x = interop.block_from_numpy(x0, mesh, F64)
        for _ in range(steps):
            x = step(x)
        out[solver] = _np(sharded.gather(x, mesh))
    return out


def _fdm_rhs_tensor_re(inp, mesh):
    """vortex.make_fdm_rhs with a 0-d fp64 tensor Re (not cfg.re) on this
    rank's block of w0, gathered."""
    cfg = _vortex_cfg("fdm", inp["full_dt"])
    re = torch.tensor(inp["fdm_re"], dtype=F64)
    rhs = vortex.make_fdm_rhs(cfg, F64, "cpu", re=re, mesh=mesh)
    return _np(sharded.gather(rhs(interop.block_from_numpy(inp["w0"], mesh,
                                                           F64)), mesh))


def _half_steps(inp, mesh, steps):
    """The three half steps from h0; and half_init / half_decode on row
    slabs, as "init" and "decode"."""
    out = {"init": _from_rows(vortex.half_init(_rows(inp["w0"], mesh), mesh),
                              mesh, inp["h0"].shape),
           "decode": _from_rows(vortex.half_decode(_rows(inp["h0"], mesh),
                                                   32, 32, mesh), mesh,
                                (32, 32))}
    for solver in HALF_SOLVERS:
        cfg = _vortex_cfg(solver, inp["half_dt"])
        step = sharded.make_sharded_vortex_step_half(cfg, mesh, F64, "cpu")
        h = _rows(inp["h0"], mesh)
        for _ in range(steps):
            h = step(h)
        out[solver] = _from_rows(h, mesh, inp["h0"].shape)
    return out


def _cavity_state(inp, mesh):
    w0 = sharded.pad_to_mesh(interop.field_from_numpy(inp["cavity_w0"], F64),
                             mesh)
    w = sharded.place(w0, mesh)
    return (w, torch.zeros_like(w), torch.zeros((), dtype=F64))


def _cavity(inp, mesh, steps):
    out = {}
    for poisson in ("fst", "fst_half"):
        cfg = cavity.CavityConfig(nx=32, ny=32, poisson=poisson)
        step = cavity.make_step_fn(cfg, F64, "cpu", mesh=mesh)
        state = _cavity_state(inp, mesh)
        for _ in range(steps):
            state = step(state)
        out[poisson] = (_np(sharded.gather(state[0], mesh)),
                        _np(sharded.gather(state[1], mesh)),
                        float(state[2]))
    return out


def _refusals(mesh):
    """The messages of the mesh paths' refusals."""
    cases = {
        "cavity_poisson": lambda: sharded.make_sharded_cavity_step(
            cavity.CavityConfig(nx=32, ny=32, poisson="matmul_bf16x3"),
            mesh, F64, "cpu"),
        "step_fn_matmul": lambda: cavity.make_step_fn(
            cavity.CavityConfig(nx=32, ny=32, poisson="matmul"), F64, "cpu",
            mesh=mesh),
        "ragged_grid": lambda: sharded.make_sharded_vortex_step(
            vortex.VortexConfig(nx=33, ny=33, solver="ps23"), mesh, F64,
            "cpu"),
        "half_fdm": lambda: sharded.make_sharded_vortex_step_half(
            vortex.VortexConfig(nx=32, ny=32, solver="fdm"), mesh, F64,
            "cpu"),
        "no_shape": lambda: spectral.fft_poisson_periodic(
            torch.zeros(8, 8, dtype=F64), 1.0, 1.0, mesh=mesh),
        "dst_axis": lambda: spectral.dst1(torch.zeros(2, 8, 8, dtype=F64),
                                          0, mesh=mesh),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)
        else:
            out[name] = None
    return out


def _no_gather(inp, mesh):
    """One step of every mesh path with the collectives that can gather a
    field made to raise (all_gather in its tensor and object forms,
    broadcast, an all_reduce of more than one element), and every
    transpose checked: the all-to-all of a move sends at most the
    elements of the tensor it moves and receives at most those of the
    tensor it returns (each element once: a transpose, not a gather).
    Returns, for each path, None if it ran, else the error; and the
    number of all-to-alls."""
    moves, calls = [], []
    real = {name: getattr(dist, name) for name in
            ("all_gather", "all_gather_into_tensor", "all_gather_object",
             "broadcast", "all_reduce", "all_to_all_single")}
    real_move = transpose.move

    def forbidden(*args, **kwargs):
        raise RuntimeError("a gather ran inside a step")

    def all_reduce(t, *args, **kwargs):
        if t.numel() > 1:
            raise RuntimeError(f"an all_reduce of {t.numel()} elements ran "
                               "inside a step")
        return real["all_reduce"](t, *args, **kwargs)

    def all_to_all_single(output, input, *args, **kwargs):
        calls.append((output.numel(), input.numel()))
        return real["all_to_all_single"](output, input, *args, **kwargs)

    def move(x, *args, **kwargs):
        n_calls = len(calls)
        out = real_move(x, *args, **kwargs)
        per = 2 if x.is_complex() else 1
        if len(calls) > n_calls:
            got, sent = calls[-1]
            if sent > per * x.numel() or got > per * out.numel():
                raise RuntimeError(f"a move of {tuple(x.shape)} -> "
                                   f"{tuple(out.shape)} sent {sent} and got "
                                   f"{got} elements")
        return out

    paths = {}
    for solver in SOLVERS:
        paths[f"full_{solver}"] = (
            sharded.make_sharded_vortex_step(
                _vortex_cfg(solver, inp["full_dt"]), mesh, F64, "cpu"),
            interop.block_from_numpy(
                inp["w0"] if solver == "fdm" else inp["wf0"], mesh, F64))
    for solver in HALF_SOLVERS:
        paths[f"half_{solver}"] = (
            sharded.make_sharded_vortex_step_half(
                _vortex_cfg(solver, inp["half_dt"]), mesh, F64, "cpu"),
            _rows(inp["h0"], mesh))
    for poisson in ("fst", "fst_half"):
        paths[f"cavity_{poisson}"] = (
            cavity.make_step_fn(cavity.CavityConfig(nx=32, ny=32,
                                                    poisson=poisson),
                                F64, "cpu", mesh=mesh),
            _cavity_state(inp, mesh))
    out = {}
    try:
        for name in ("all_gather", "all_gather_into_tensor",
                     "all_gather_object", "broadcast"):
            setattr(dist, name, forbidden)
        dist.all_reduce = all_reduce
        dist.all_to_all_single = all_to_all_single
        transpose.move = move
        for name, (step, state) in paths.items():
            try:
                step(state)
            except RuntimeError as e:
                out[name] = str(e)
            else:
                out[name] = None
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        transpose.move = real_move
    return out, len(calls)


def all_cases(device, inp):
    mesh = mesh_lib.make_mesh(device.type)
    out = {"mesh_shape": tuple(mesh.shape)}
    out["transpose"] = _transposes(inp, mesh)
    out["transform"] = _transforms(inp, mesh)
    out["full"] = _full_steps(inp, mesh, inp["steps"])
    out["fdm_rhs_re"] = _fdm_rhs_tensor_re(inp, mesh)
    out["half"] = _half_steps(inp, mesh, inp["steps"])
    out["cavity"] = _cavity(inp, mesh, inp["cavity_steps"])
    out["refusals"] = _refusals(mesh)
    out["no_gather"] = _no_gather(inp, mesh)
    return out
