"""The multigrid solve's residual sum (cuda_kernels.residual_ssq) on the CPU.

residual_ssq stands in for the JAX solve's XLA-fused
_rms_from_full(residual_full(f, u, ...)) (cfd_julia_tpu/poisson/
multigrid.py:465, its rms0; :526, an unfused cycle's check; :412,
fmg_start's right-hand side g).  Here:
  - its plain twin against those JAX functions in fp64 (rel 1e-12: the
    operation order is the only difference), bf16 rounding once;
  - the CPU solve (the twin's route) bitwise the solve as it was before the
    residual sum existed (_rms_from_full of residual_full, fmg_start
    computing its own g), fused, fmg and off;
  - the CUDA kernel's schedule (csrc/multigrid.cu residual_ssq_kernel and
    sum_kernel: kResidCols x kResidRows blocks, each thread's rows in
    order, a butterfly a warp, the warps in order, one partial a block,
    then one block of kReduceThreads strided and a tree), emulated with
    its constants read from the .cu, against the twin in fp64 (rel
    1e-12), with two broken schedules caught;
  - the wrappers' contracts: CPU calls are the twin and count nothing,
    bad arguments raise, and prolong_correct_smooth_fused's out= writes
    its result where it is told and refuses an alias.
The kernel itself is held against the twin on a GPU in
tests/test_torch_cuda.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.models import poisson2d
from cfd_julia_torch.ops import _cuda_build, cuda_kernels
from cfd_julia_torch.poisson import iterative, multigrid
from cfd_julia_tpu.poisson import iterative as jax_iterative

torch.set_num_threads(1)

SHAPES = [(5, 5), (33, 65), (131, 67), (301, 261)]


def _constants():
    """kResidCols, kResidRows, kResidBatch and kReduceThreads of
    csrc/multigrid.cu."""
    src = (_cuda_build.CSRC / "multigrid.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1))
                 for name in ("kResidCols", "kResidRows", "kResidBatch",
                              "kReduceThreads"))


COLS, ROWS, BATCH, REDUCE = _constants()
WARP = 32


def _fields(shape, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [interop.field_from_numpy(rng.standard_normal(shape), dtype)
            for _ in range(2)]


def _spacing(shape):
    return 1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1)


def _assert_rel(got, ref, rel=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ------------------------------------------------- the twin against JAX

@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape):
    """ssq against JAX's _rms_from_full (as sqrt(ssq / interior nodes))
    and r against its residual_full, fp64."""
    u, f = _fields(shape, seed=31)
    dx, dy = _spacing(shape)
    nx, ny = shape[0] - 1, shape[1] - 1
    ju, jf = jnp.asarray(u.numpy()), jnp.asarray(f.numpy())
    jr = jax_iterative.residual_full(
        jf, ju, dx, dy, jax_iterative.interior_mask(nx, ny, ju.dtype))
    jrms = jax_iterative._rms_from_full(jr, nx, ny)
    ssq, r = cuda_kernels.residual_ssq_plain(u, f, dx, dy, want_r=True)
    assert ssq.dtype == torch.float64 and ssq.dim() == 0
    _assert_rel(r.numpy(), jr)
    np.testing.assert_allclose(float(torch.sqrt(ssq / (nx - 1) / (ny - 1))),
                               float(jrms), rtol=1e-12)
    alone, none = cuda_kernels.residual_ssq_plain(u, f, dx, dy)
    assert none is None and torch.equal(alone, ssq)


def test_plain_bf16_rounds_once():
    """bf16 fields: r is the fp32 residual rounded once, ssq the fp32 sum
    of the unrounded r (the `_c32` contract)."""
    u, f = (t.to(torch.bfloat16) for t in _fields((33, 65), seed=32,
                                                  dtype=torch.float32))
    ssq, r = cuda_kernels.residual_ssq_plain(u, f, 0.1, 0.2, want_r=True)
    ssq32, r32 = cuda_kernels.residual_ssq_plain(u.float(), f.float(), 0.1,
                                                 0.2, want_r=True)
    assert ssq.dtype == torch.float32 and r.dtype == torch.bfloat16
    assert torch.equal(ssq, ssq32)
    assert torch.equal(r, r32.to(torch.bfloat16))


# ---------------------------------------- the CPU solve, bitwise as before

def _solve_as_before(f, u0, dx, dy, cfg):
    """multigrid.solve's eager loop as it was before residual_ssq: rms0
    and an unfused cycle's rms by _rms_from_full(residual_full(...)), and
    fmg_start computing its own right-hand side."""
    impl = multigrid.impl_choice(cfg.impl, f.device)
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    levels = multigrid._build_levels(nx, ny, dx, dy, cfg.n_levels)
    imasks = [iterative.interior_mask(lv[0], lv[1], f.dtype, f.device)
              for lv in levels]
    fused_rms = len(levels) > 1 and multigrid._fused(cfg)
    rms0 = iterative._rms_from_full(
        iterative.residual_full(f, u0, dx, dy, imasks[0]), nx, ny)
    if cfg.fmg:
        u0 = multigrid.fmg_start(f, u0, levels, imasks, cfg, impl)
    hist = torch.full((cfg.max_cycles + 1, 3), float("nan"), dtype=f.dtype)
    u, it, rel, nrec = u0, 0, rms0 / rms0, 0
    while it < cfg.max_cycles and float(rel) > cfg.tol:
        if fused_rms:
            u, ssq = multigrid.v_cycle(u, f, levels, imasks, cfg, impl,
                                       want_rms=True)
            rms = torch.sqrt(ssq / ((nx - 1) * (ny - 1))).to(f.dtype)
        else:
            u = multigrid.v_cycle(u, f, levels, imasks, cfg, impl)
            rms = iterative._rms_from_full(
                iterative.residual_full(f, u, dx, dy, imasks[0]), nx, ny)
        rel = rms / rms0
        it += 1
        iterative._record(hist, nrec, it, rms, rel)
        nrec += 1
    return u, rms0, hist, it


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx,ny", [(64, 64), (64, 32)])
@pytest.mark.parametrize("opts", [dict(), dict(fmg=True),
                                  dict(fused="off"),
                                  dict(fused="off", fmg=True)],
                         ids=["fused", "fmg", "off", "off_fmg"])
def test_cpu_solve_is_bitwise_as_before(opts, nx, ny, dtype):
    cfg = poisson2d.PoissonConfig(nx=nx, ny=ny, solver="multigrid",
                                  problem="poly")
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, dtype, "cpu")
    u0 = poisson2d._dirichlet_init(ue)
    mgc = multigrid.MGConfig(tol=1e-9 if dtype == torch.float64 else 1e-5,
                             max_cycles=30, **opts)
    got = multigrid.solve(f, u0, cfg.dx, cfg.dy, mgc)
    u, rms0, hist, it = _solve_as_before(f, u0, cfg.dx, cfg.dy, mgc)
    assert got.iterations == it > 1
    assert torch.equal(got.u, u) and torch.equal(got.rms0, rms0)
    torch.testing.assert_close(got.history, hist, rtol=0, atol=0,
                               equal_nan=True)


def test_one_level_solve_takes_an_even_grid():
    """A one-level pyramid of an odd nx has even sides: the residual sum
    takes any extent of at least 3 a side."""
    cfg = poisson2d.PoissonConfig(nx=63, ny=31, solver="multigrid",
                                  problem="poly")
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, torch.float64, "cpu")
    u0 = poisson2d._dirichlet_init(ue)
    mgc = multigrid.MGConfig(max_cycles=3)
    got = multigrid.solve(f, u0, cfg.dx, cfg.dy, mgc)
    u, rms0, hist, it = _solve_as_before(f, u0, cfg.dx, cfg.dy, mgc)
    assert got.iterations == it == 3
    assert torch.equal(got.u, u) and torch.equal(got.rms0, rms0)
    torch.testing.assert_close(got.history, hist, rtol=0, atol=0,
                               equal_nan=True)


# ------------------------------------------ the kernel's schedule emulated

def _kernel_residual(u, f, dx, dy):
    """The kernel's residual at every node in its operation order (1/dx^2
    and 1/dy^2 as the wrapper passes them), 0 off the interior."""
    dx2i, dy2i = 1.0 / dx**2, 1.0 / dy**2
    c = u[1:-1, 1:-1]
    lap = ((u[:-2, 1:-1] - 2.0 * c + u[2:, 1:-1]) * dx2i
           + (u[1:-1, :-2] - 2.0 * c + u[1:-1, 2:]) * dy2i)
    r = torch.zeros_like(u)
    r[1:-1, 1:-1] = f[1:-1, 1:-1] - lap
    return r


def _sum_kernel(partials):
    """sum_kernel: REDUCE threads sum strided partials in index order,
    then a tree (buf[t] += buf[t + s], s = REDUCE/2 ... 1)."""
    n = partials.numel()
    buf = torch.zeros(REDUCE, dtype=partials.dtype)
    for k0 in range(0, n, REDUCE):
        chunk = partials[k0:k0 + REDUCE]
        buf[:chunk.numel()] = buf[:chunk.numel()] + chunk
    s = REDUCE // 2
    while s > 0:
        buf[:s] = buf[:s] + buf[s:2 * s]
        s //= 2
    return buf[0]


def emulate_residual_ssq(u, f, dx, dy, summed_rows=ROWS,
                         drop_last_col_block=False):
    """(ssq, r) as residual_ssq_kernel and sum_kernel compute them: the
    grid of ceil(nc / COLS) x ceil(nr / rows) blocks, each thread's column
    of its block's rows squared and summed in row order (BATCH rows'
    loads at a time changes no value), a butterfly in each warp, the
    warps in order, one partial a block in index order, then sum_kernel.
    summed_rows (< ROWS: each block's last rows left out) and
    drop_last_col_block (the column grid rounded down) break the schedule
    on purpose."""
    nr, nc = u.shape
    rows = ROWS
    r = _kernel_residual(u, f, dx, dy)
    gx, gy = -(-nc // COLS), -(-nr // rows)
    if drop_last_col_block:
        gx = nc // COLS
    padded = torch.zeros(gy * rows, gx * COLS, dtype=r.dtype)
    h, w = min(nr, gy * rows), min(nc, gx * COLS)
    padded[:h, :w] = r[:h, :w]
    blocks = padded.reshape(gy, rows, gx, COLS)
    acc = torch.zeros(gy, gx, COLS, dtype=r.dtype)
    for k in range(summed_rows):
        v = blocks[:, k]
        acc = acc + v * v
    lanes = acc.reshape(gy, gx, COLS // WARP, WARP)
    o = WARP // 2
    while o > 0:
        lanes = lanes + lanes[..., torch.arange(WARP) ^ o]
        o //= 2
    warps = lanes[..., 0]
    block = warps[..., 0]
    for wi in range(1, COLS // WARP):
        block = block + warps[..., wi]
    return _sum_kernel(block.reshape(-1)), r


def test_constants_read_from_the_source():
    """The block is whole warps, its rows whole batches, and the warp
    butterfly and the reduction tree are powers of two."""
    assert COLS % WARP == 0 and ROWS % BATCH == 0
    assert REDUCE & (REDUCE - 1) == 0 and WARP == 32
    src = (_cuda_build.CSRC / "multigrid.cu").read_text()
    assert re.search(r"for \(int o = 16; o > 0; o >>= 1\)\s*\n\s*acc \+= "
                     r"__shfl_xor_sync", src)
    assert "residual_ssq_kernel<C, T><<<g, kResidCols, 0, s>>>" in src


@pytest.mark.parametrize("shape", SHAPES + [(3, 3), (4, 6), (130, 129)])
def test_emulation_matches_twin(shape):
    u, f = _fields(shape, seed=33)
    dx, dy = _spacing(shape)
    ssq, r = emulate_residual_ssq(u, f, dx, dy)
    ref_ssq, ref_r = cuda_kernels.residual_ssq_plain(u, f, dx, dy,
                                                     want_r=True)
    _assert_rel(r.numpy(), ref_r.numpy())
    np.testing.assert_allclose(float(ssq), float(ref_ssq), rtol=1e-12)


@pytest.mark.parametrize("mistake", ["rows_one_short", "last_column_block"])
def test_a_broken_schedule_is_caught(mistake):
    """Each block summing one row short of its rows, and a column grid
    rounded down (the ragged last block left out), both miss the twin by
    far more than rel 1e-12."""
    shape = (131, 67 + COLS)
    u, f = _fields(shape, seed=34)
    dx, dy = _spacing(shape)
    ref, _ = cuda_kernels.residual_ssq_plain(u, f, dx, dy)
    ssq, _ = emulate_residual_ssq(
        u, f, dx, dy, summed_rows=ROWS - (mistake == "rows_one_short"),
        drop_last_col_block=mistake == "last_column_block")
    assert abs(float(ssq) - float(ref)) > 1e-6 * float(ref)


# ------------------------------------------------------ wrapper contracts

def test_wrapper_cpu_is_plain_and_uncounted():
    u, f = _fields((17, 10), seed=35)
    before = dict(cuda_kernels.LAUNCHES)
    for want_r in (False, True):
        got = cuda_kernels.residual_ssq(u, f, 0.1, 0.2, want_r=want_r)
        ref = cuda_kernels.residual_ssq_plain(u, f, 0.1, 0.2, want_r=want_r)
        assert torch.equal(got[0], ref[0])
        assert (got[1] is None) == (not want_r)
        if want_r:
            assert torch.equal(got[1], ref[1])
    assert cuda_kernels.LAUNCHES == before
    assert "residual_ssq" in cuda_kernels.LAUNCHES


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError), ("mixed_dtype", TypeError), ("1d", ValueError),
    ("shape_mismatch", ValueError), ("two_rows", ValueError),
    ("two_cols", ValueError), ("meta_device", ValueError),
])
def test_wrapper_rejects(case, exc):
    a = torch.zeros(9, 8, dtype=torch.float64)
    u, f = {
        "float16": (a.half(), a.half()),
        "mixed_dtype": (a, a.float()),
        "1d": (a[0], a[0]),
        "shape_mismatch": (a, a[:7]),
        "two_rows": (a[:2], a[:2]),
        "two_cols": (a[:, :2], a[:, :2]),
        "meta_device": (a.to("meta"), a.to("meta")),
    }[case]
    with pytest.raises(exc):
        cuda_kernels.residual_ssq(u, f, 0.1, 0.1)


def _edge_inputs():
    u, f = _fields((17, 9), seed=36)
    uc = _fields((9, 5), seed=37)[0]
    return u, f, uc


@pytest.mark.parametrize("want_rms", [False, True])
def test_out_takes_the_result(want_rms):
    """out= returns out itself, holding the fresh call's result bit for
    bit (and the same residual sum)."""
    u, f, uc = _edge_inputs()
    out = torch.full_like(u, float("nan"))
    got = cuda_kernels.prolong_correct_smooth_fused(
        u, f, uc, 1 / 16, 1 / 8, 2, want_rms=want_rms, out=out)
    ref = cuda_kernels.prolong_correct_smooth_fused(
        u, f, uc, 1 / 16, 1 / 8, 2, want_rms=want_rms)
    got = got if want_rms else (got,)
    ref = ref if want_rms else (ref,)
    assert got[0] is out
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("case,exc", [
    ("is_u", ValueError), ("is_f", ValueError), ("overlaps_uc", ValueError),
    ("view_of_u", ValueError), ("dtype", TypeError), ("shape", ValueError),
    ("strided", ValueError), ("device", ValueError),
])
def test_out_refusals(case, exc):
    u, f, uc = _edge_inputs()
    buf = torch.zeros(2 * u.numel(), dtype=u.dtype)
    u_in_buf = buf[:u.numel()].view(u.shape).copy_(u)
    out = {
        "is_u": u,
        "is_f": f,
        # a field whose first bytes are uc's
        "overlaps_uc": torch.cat([uc.reshape(-1), torch.zeros(
            u.numel() - uc.numel(), dtype=u.dtype)]).view(u.shape),
        "view_of_u": buf[3:3 + u.numel()].view(u.shape),
        "dtype": torch.zeros_like(u, dtype=torch.float32),
        "shape": torch.zeros(17, 11, dtype=u.dtype),
        "strided": torch.zeros(17, 18, dtype=u.dtype)[:, ::2],
        "device": torch.zeros_like(u, device="meta"),
    }[case]
    src = u_in_buf if case == "view_of_u" else u
    if case == "overlaps_uc":
        uc = out.reshape(-1)[:uc.numel()].view(uc.shape)
    with pytest.raises(exc):
        cuda_kernels.prolong_correct_smooth_fused(src, f, uc, 1 / 16, 1 / 8,
                                                  2, out=out)


def test_out_disjoint_view_is_taken():
    """A view of the same buffer that shares no byte with the inputs is a
    valid out."""
    u, f, uc = _edge_inputs()
    buf = torch.zeros(2 * u.numel(), dtype=u.dtype)
    src = buf[:u.numel()].view(u.shape).copy_(u)
    out = buf[u.numel():].view(u.shape)
    got = cuda_kernels.prolong_correct_smooth_fused(src, f, uc, 1 / 16,
                                                    1 / 8, 2, out=out)
    assert got is out
    assert torch.equal(out, cuda_kernels.prolong_correct_smooth_fused(
        u, f, uc, 1 / 16, 1 / 8, 2))


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_v_cycle_out(fused):
    """A fused cycle's finest ascend edge writes `out` and returns it; an
    unfused cycle ignores it.  Both equal the cycle without out."""
    cfg = multigrid.MGConfig(fused=fused)
    shape = (33, 33)
    u, f = _fields(shape, seed=38)
    levels = multigrid._build_levels(32, 32, 1 / 32, 1 / 32, 0)
    imasks = [iterative.interior_mask(lv[0], lv[1], u.dtype)
              for lv in levels]
    out = torch.empty_like(u)
    got = multigrid.v_cycle(u, f, levels, imasks, cfg, "torch", out=out)
    ref = multigrid.v_cycle(u, f, levels, imasks, cfg, "torch")
    assert (got is out) == (fused == "auto")
    assert torch.equal(got, ref)
