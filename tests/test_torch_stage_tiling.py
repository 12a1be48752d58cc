"""The packed cavity's stage kernel's walk, emulated in numpy on the CPU.

The CUDA kernel behind cavity_fused_stage (cfd_julia_torch/csrc/
cavity_stage.cu) cuts the (P, Q) buffers into walkers: a warp of LANES
lanes, each owning VEC = VEC_BYTES / itemsize adjacent columns of ROWS
output rows, WALKERS walkers a block stacked along axis 0.  A lane loads
each row of its window (rows a0-1 .. a0+ROWS) as one vector, takes the
columns beside its own from the neighbouring lanes (lane 0 and lane 31
from the warp's two halo loads), and a walker whose window leaves the
logical interior clamps its addresses and replaces each value by its wall
value.  This file replays that data path in numpy, with the constants read
from the source, and holds:

- the windows the lanes assemble to decode_state's full grid (w with its
  walls, psi with zero walls) at every slot inside it, and the interior
  walkers' raw loads to need no clamping and no wall logic;
- every point of the buffer and every wall-vector entry to be written
  exactly once;
- the emulated stage to the plain twin within 1e-12 in fp64.

The card test (tests/test_torch_cuda.py) compares the library's exported
constants with these, and the kernel with the twin.
"""
import re

import numpy as np
import pytest
import torch

from cfd_julia_torch.models import cavity, cavity_fused
from cfd_julia_torch.ops import _cuda_build, cuda_kernels

torch.set_num_threads(1)

_SOURCE = (_cuda_build.CSRC / "cavity_stage.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE).group(1))


ROWS = _constant("kRows")
WALKERS = _constant("kWalkers")
VEC_BYTES = _constant("kVecBytes")
LANES = _constant("kWarp")
# (nx, ny) of the packed cavity: the phase 2 / card shapes (m = P at 33x47
# and 9x129, n = Q at 9x129, both at 1025^2), and m = n = 2
STAGE_SHAPES = [(1024, 1024), (16, 16), (24, 16), (33, 47), (34, 130),
                (9, 129), (1025, 1025), (3, 3)]
# raw buffers (P, Q, m, n) the packed layout never makes, which the kernel
# takes: a ragged last walker, m = P with n = Q, one lane's columns
RAW_SHAPES = [(13, 128, 11, 100), (13, 128, 13, 128), (5, 264, 2, 2),
              (21, 72, 20, 70)]


def test_constants_read_from_the_source():
    """A warp's lanes, a 16-byte row load, at least one row and walker."""
    assert LANES == 32 and VEC_BYTES == 16
    assert ROWS >= 1 and WALKERS >= 1


def _inputs(P, Q, m, n, seed):
    """Fields of scale 1 on the logical interior, zero padding; wall vectors
    zero past it (fp64 numpy)."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(3):
        a = np.zeros((P, Q))
        a[:m, :n] = rng.standard_normal((m, n))
        fields.append(a)
    walls = []
    for size, L in ((Q, n), (Q, n), (P, m), (P, m)):
        v = np.zeros(size)
        v[:L] = rng.standard_normal(L)
        walls.append(v)
    return (*fields, walls)


def _wall_w(v, g, c, m, n, rlc, rhc, clg, chg, lid):
    """csrc/cavity_stage.cu wall_w, elementwise."""
    gin = (g >= 0) & (g < m)
    cin = (c >= 0) & (c < n)
    wall_row = np.where(cin, np.where(g < 0, rlc, rhc),
                        np.where(c == n, lid, 0.0))
    wall_col = np.where(c == -1, clg, np.where(c == n, chg, 0.0))
    return np.where(gin & cin, v,
                    np.where((g == -1) | (g == m), wall_row,
                             np.where(gin, wall_col, 0.0)))


def _wall_value(s0, s1, h2, order):
    return (-2.0 * s0 / h2) if order == 1 else (-4.0 * s0 + 0.5 * s1) / h2


def emulate(w, wt, s, walls, stage, dt, dx, dy, re, m, n, order, itemsize,
            halo_shift=0):
    """The kernel's walk on numpy buffers: returns (out, walls_out, counts
    of the writes to out and to each wall vector, windows) where windows
    holds, for every walker, the assembled w and psi slots with their
    logical rows and columns and whether the walker is interior.
    halo_shift moves the right halo load (a wrong kernel, to show that the
    comparisons see it)."""
    P, Q = w.shape
    V = VEC_BYTES // itemsize
    assert Q % V == 0
    seg = LANES * V
    rl, rh, cl, ch = walls
    lid = -3.0 / dy if order == 2 else -2.0 / dy
    # the launch: blockIdx.x a column segment, (blockIdx.y, threadIdx.y) a
    # walker; warps whose rows start past the buffer return
    walkers = -(-P // ROWS)
    blocks_y = -(-walkers // WALKERS)
    a0 = ((np.arange(blocks_y)[:, None] * WALKERS
           + np.arange(WALKERS)[None, :]).ravel() * ROWS)
    a0 = a0[a0 < P]
    c0 = np.arange(-(-Q // seg)) * seg
    interior = ((a0[None, :] >= 1) & (a0[None, :] + ROWS <= m - 1)
                & (c0[:, None] >= 1) & (c0[:, None] + seg <= n - 1))
    # axes: (segment, walker, window row, lane, slot)
    lane = np.arange(LANES)
    c = c0[:, None] + lane[None, :] * V                        # (S, L)
    g = a0[:, None] - 1 + np.arange(ROWS + 2)[None, :]         # (A, R+2)
    hc = np.where(lane[None, :] == 0, c0[:, None] - 1,
                  c0[:, None] + seg + halo_shift)
    gv, cv, hcv = np.clip(g, 0, P - 1), np.minimum(c, Q - V), \
        np.clip(hc, 0, Q - 1)
    # an interior walker's addresses need no clamp
    inner = interior[:, :, None, None]
    assert np.all(~inner | (g[None, :, :, None] == gv[None, :, :, None]))
    assert np.all(~interior[:, :, None] | (c == cv)[:, None, :])
    assert np.all(~interior[:, :, None] | (hc == hcv)[:, None, :])

    def window(field):
        own = field[gv[None, :, :, None, None],
                    (cv[:, :, None] + np.arange(V))[:, None, None, :, :]]
        halo = field[gv[None, :, :, None], hcv[:, None, None, :]]
        # __shfl_up_sync / __shfl_down_sync by one lane; lane 0 takes the
        # halo left of the segment, lane 31 the one right of it
        left = np.concatenate([halo[..., :1], own[..., :-1, V - 1]], -1)
        right = np.concatenate([own[..., 1:, 0], halo[..., -1:]], -1)
        return np.concatenate([left[..., None], own, right[..., None]], -1)

    cj = (c[:, :, None] - 1 + np.arange(V + 2))[:, None, None, :, :]
    gg = g[None, :, :, None, None]
    cjv = np.clip(cj, 0, Q - 1)
    raw_w, raw_s = window(wt), window(s)
    fix_w = _wall_w(raw_w, gg, cj, m, n, rl[cjv], rh[cjv],
                    cl[np.clip(gg, 0, P - 1)], ch[np.clip(gg, 0, P - 1)],
                    lid)
    fix_s = np.where((gg >= 0) & (gg < P) & (cj >= 0) & (cj < Q), raw_s, 0.0)
    # an interior walker's window needs no wall logic
    assert np.array_equal(np.where(inner[..., None], fix_w, raw_w), raw_w)
    assert np.array_equal(np.where(inner[..., None], fix_s, raw_s), raw_s)
    ws = np.where(inner[..., None], raw_w, fix_w)
    ss = np.where(inner[..., None], raw_s, fix_s)

    # the stage: rows W, C, E of each output row, slots j-1, j, j+1
    a = a0[:, None] + np.arange(ROWS)[None, :]                 # (A, R)
    b = c[:, :, None] + np.arange(V)                           # (S, L, V)
    Wr, Cr, Er = (x[:, :, k:k + ROWS] for x in (ws,) for k in (0, 1, 2))
    Ws, Cs, Es = (x[:, :, k:k + ROWS] for x in (ss,) for k in (0, 1, 2))
    j = slice(1, V + 1)
    jm, jp = slice(0, V), slice(2, V + 2)
    wc, wE, wW = Cr[..., j], Er[..., j], Wr[..., j]
    wN, wS = Cr[..., jp], Cr[..., jm]
    wNE, wSW, wNW, wSE = Er[..., jp], Wr[..., jm], Wr[..., jp], Er[..., jm]
    sE, sW = Es[..., j], Ws[..., j]
    sN, sS = Cs[..., jp], Cs[..., jm]
    sNE, sSW, sNW, sSE = Es[..., jp], Ws[..., jm], Ws[..., jp], Es[..., jm]
    j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW)
    j2 = (wE * (sNE - sSE) - wW * (sNW - sSW)
          - wN * (sNE - sNW) + wS * (sSE - sSW))
    j3 = (wNE * (sN - sE) - wSW * (sW - sS)
          - wNW * (sN - sW) + wSE * (sE - sS))
    jac = (1.0 / (4.0 * dx * dy)) * (j1 + j2 + j3) / 3.0
    lap = (wE - 2.0 * wc + wW) / dx**2 + (wN - 2.0 * wc + wS) / dy**2
    rhs = -jac + lap / re
    aa = a[None, :, :, None, None]
    bb = b[:, None, None, :, :]
    w0 = w[np.clip(aa, 0, P - 1), np.minimum(bb, Q - 1)]
    if stage == 1:
        raw = wc + dt * rhs
    elif stage == 2:
        raw = 0.75 * w0 + 0.25 * wc + 0.25 * dt * rhs
    else:
        raw = (w0 + 2.0 * wc + 2.0 * dt * rhs) / 3.0
    res = np.where((aa < m) & (bb < n), raw, 0.0)

    # the stores: a row inside the buffer, a lane inside it
    stored = np.broadcast_to((aa < P) & (c[:, None, None, :, None] < Q),
                             res.shape)
    A, B = np.broadcast_to(aa, res.shape), np.broadcast_to(bb, res.shape)
    out = np.full((P, Q), np.nan)
    count = np.zeros((P, Q), int)
    out[A[stored], B[stored]] = res[stored]
    np.add.at(count, (A[stored], B[stored]), 1)
    # the edge path's wall vectors, from the centre row's psi slots
    walls_out = [np.full(Q, np.nan), np.full(Q, np.nan), np.full(P, np.nan),
                 np.full(P, np.nan)]
    counts = [np.zeros(Q, int), np.zeros(Q, int), np.zeros(P, int),
              np.zeros(P, int)]
    edge = np.broadcast_to(~inner[..., None], res.shape) & stored
    for k, (cond, val, idx) in enumerate((
            (A == 0, _wall_value(Cs[..., j], Es[..., j], dx**2, order), B),
            (A == m - 1, _wall_value(Cs[..., j], Ws[..., j], dx**2, order),
             B),
            (B == 0, np.where(A < m, _wall_value(Cs[..., j], Cs[..., jp],
                                                 dy**2, order), 0.0), A),
            (B == n - 1, np.where(A < m, _wall_value(Cs[..., j],
                                                     Cs[..., jm], dy**2,
                                                     order) + lid, 0.0),
             A))):
        hit = edge & cond
        walls_out[k][idx[hit]] = np.broadcast_to(val, res.shape)[hit]
        np.add.at(counts[k], idx[hit], 1)
    windows = dict(w=ws, s=ss, g=np.broadcast_to(gg, ws.shape),
                   c=np.broadcast_to(cj, ws.shape),
                   interior=np.broadcast_to(inner[..., None], ws.shape))
    return out, walls_out, count, counts, windows


def _check_walk(P, Q, m, n, itemsize, packed=True, stage=2, order=2,
                seed=0, halo_shift=0):
    """The emulated walk against the write counts, the twin and, for a
    packed buffer, decode_state's full grid."""
    w, wt, s, walls = _inputs(P, Q, m, n, seed)
    if stage == 1:
        wt = w
    cfg = cavity.CavityConfig(nx=m + 1, ny=n + 1, bc_order=order)
    args = (stage, 2e-3, cfg.dx, cfg.dy, 100.0, m, n, order)
    out, walls_out, count, counts, win = emulate(
        w, wt, s, walls, *args, itemsize=itemsize, halo_shift=halo_shift)
    assert np.all(count == 1)
    for k in counts:
        assert np.all(k == 1)
    ref, ref_walls = cuda_kernels.cavity_fused_stage_plain(
        *(torch.as_tensor(x) for x in (w, wt, s)),
        tuple(torch.as_tensor(v) for v in walls), *args)
    ref = ref.numpy()
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()
    for got, rv in zip(walls_out, ref_walls):
        rv = rv.numpy()
        assert np.abs(got - rv).max() <= 1e-12 * max(np.abs(rv).max(), 1.0)
    if packed:
        state = (*(torch.as_tensor(x) for x in (wt, s)),
                 *(torch.as_tensor(v) for v in walls), torch.zeros(()))
        w_full, s_full = (x.numpy() for x in
                          cavity_fused.decode_state(cfg, state))
        inside = ((win["g"] >= -1) & (win["g"] <= m) & (win["c"] >= -1)
                  & (win["c"] <= n))
        gi, ci = win["g"][inside] + 1, win["c"][inside] + 1
        assert np.array_equal(win["w"][inside], w_full[gi, ci])
        assert np.array_equal(win["s"][inside], s_full[gi, ci])
    return win


@pytest.mark.parametrize("itemsize", [4, 8], ids=["fp32", "fp64"])
@pytest.mark.parametrize("nx,ny", STAGE_SHAPES)
def test_walk_assembles_the_full_grid(nx, ny, itemsize):
    """At every packed shape and both dtypes' geometry: the windows equal
    decode_state's full grid, each point and wall entry is written once,
    and the emulated stage 2 equals the twin."""
    m, n = nx - 1, ny - 1
    P, Q = cavity_fused.padded_extents(nx, ny)
    win = _check_walk(P, Q, m, n, itemsize, seed=nx + ny)
    if (nx, ny) == (1024, 1024):
        # only the first and last column segments and row walkers take the
        # edge path
        assert 0 < win["interior"].mean() < 1


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("itemsize", [4, 8], ids=["fp32", "fp64"])
def test_walk_stages_match_twin(itemsize, stage, order):
    """Every stage and wall-BC order at 34x130 (two column segments in
    fp32, four in fp64, two walker blocks)."""
    P, Q = cavity_fused.padded_extents(34, 130)
    _check_walk(P, Q, 33, 129, itemsize, stage=stage, order=order,
                seed=10 * stage + order)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["fp32", "fp64"])
@pytest.mark.parametrize("P,Q,m,n", RAW_SHAPES)
def test_walk_on_raw_buffers(P, Q, m, n, itemsize):
    """Buffers the packed layout does not make but the kernel takes: a
    last walker past the buffer's end, m = P and n = Q, m = n = 2, Q not a
    multiple of a segment (lanes past the buffer load in bounds and store
    nothing)."""
    _check_walk(P, Q, m, n, itemsize, packed=False, seed=P * Q + m)


def test_emulation_sees_a_wrong_halo():
    """The comparisons see a walk that takes the right halo column one too
    far: the emulated stage then misses the twin."""
    P, Q = cavity_fused.padded_extents(34, 130)
    with pytest.raises(AssertionError):
        _check_walk(P, Q, 33, 129, 4, seed=3, halo_shift=1)
