"""The RHS kernels' schedules, and their division, emulated on the CPU.

The CUDA kernels behind arakawa_rhs_fused (cfd_julia_torch/csrc/
arakawa_rhs.cu) and euler_rhs_fused (csrc/euler_rhs.cu) cut their work in
ways that a wrong index would still make plausible, so this file emulates
each schedule in PyTorch and holds it, in fp64, to rel 1e-12 against the
plain twins (the operation order is the only difference) and against the
JAX package's Pallas kernels in interpret mode:

- the Arakawa RHS: blocks of BLOCK_X columns and BLOCK_Y column walkers,
  each walker a register window of the ROWS + 2 rows (three columns j-1,
  j, j+1 of each field) around its ROWS output rows, with the periodic
  wrap of rows and columns resolved at the load, rows past the array's
  end read as row 0, and only rows inside the array stored;
- the Arakawa RHS's backward (its adjoint in w, s and each member's Re):
  a warp a walker of a strip of rows (as many rows as the launcher takes
  for the card's resident walkers, MIN_ROWS .. MAX_ROWS), each lane
  owning VEC columns where rows are 16-byte aligned (else one column),
  the columns beside its own from the lanes beside it and the segment's
  two halo loads, the ragged last segment's lanes past the end; and the Re
  gradient's fold: a block's sum written to its own slot, a ticket from a
  completion counter, and the last block's fixed-order sum of each
  member's slots;
- the Euler RHS: blocks of CELLS cells that stage cells c0-3 .. c0+CELLS+2
  through the mirror map (clamped past the last block's ghosts), compute
  the CELLS+1 interfaces of the tile from the staged cells (the spectral
  wavespeed from the staged cells' radii at clamp(j, 1, nx-1)) and write
  the divergence of their own cells.

The tile constants are read from the .cu sources, so the emulation follows
the kernels.  Both kernels divide with div_rn (csrc/div_rn.cuh): x / d from
the correctly rounded reciprocal and one FMA correction; the last tests
hold that formula, in exact rational arithmetic rounded once per operation,
to the IEEE quotient over the operands the kernels divide.  The CUDA
kernels themselves are held against the twins on a GPU in
tests/test_torch_cuda.py.
"""
import functools
import math
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch.ops import _cuda_build, cuda_kernels, riemann, weno
from cfd_julia_tpu.ops import pallas_kernels

torch.set_num_threads(1)

RE = 100.0
GAMMA = 1.4


def _constant(source, name):
    text = (_cuda_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BLOCK_X = _constant("arakawa_rhs.cu", "kBlockX")
BLOCK_Y = _constant("arakawa_rhs.cu", "kBlockY")
ROWS = _constant("arakawa_rhs.cu", "kRows")
MIN_ROWS = _constant("arakawa_rhs.cu", "kMinRows")
MAX_ROWS = _constant("arakawa_rhs.cu", "kMaxRows")
MAX_ROWS64 = _constant("arakawa_rhs.cu", "kMaxRows64")
BACK_WALKERS = _constant("arakawa_rhs.cu", "kBackWalkers")
VEC_BYTES = _constant("arakawa_rhs.cu", "kVecBytes")
BACK_AHEAD = _constant("arakawa_rhs.cu", "kBackAhead")
FOLD_COUNTERS = _constant("arakawa.cuh", "kFoldCounters")
CELLS = _constant("euler_rhs.cu", "kCells")
GHOST = _constant("euler_rhs.cu", "kGhost")

# ragged on both axes, 1 and 2 columns (the neighbours alias), and one
# shape with several blocks on both axes
ARAKAWA_SHAPES = [(3, 1), (3, 2), (8, 8), (37, 53), (65, 33),
                  (2 * BLOCK_Y * ROWS + 22, 2 * BLOCK_X + 6)]
# the Pallas kernel takes >= 8 rows (its GUARD)
PALLAS_ARAKAWA_SHAPES = [s for s in ARAKAWA_SHAPES if s[0] >= 8]
EULER_NX = [3, 4, 5, CELLS - 1, CELLS, CELLS + 1, 257]
VARIANTS = [("roe", "roe"), ("hllc", "roe"), ("rusanov", "roe"),
            ("rusanov", "spectral")]
VARIANT_IDS = ["roe", "hllc", "rusanov-roe", "rusanov-spectral"]


def _assert_rel(got, ref, rel=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ------------------------------------------------------------ Arakawa RHS

def emulate_arakawa(w, s, dx, dy, re, wrap=True):
    """arakawa_rhs_fused as the CUDA kernel's walkers compute it: each
    loads rows i0-1 .. i0+ROWS of columns j-1, j, j+1 (row -1 reads nr-1,
    rows nr and past it row 0), then computes its ROWS outputs and stores
    those inside the array.  wrap=False reads row 0 for row -1 (a wrong
    kernel, to show that the comparisons can see it)."""
    nr, nc = w.shape
    gg = 1.0 / (4.0 * dx * dy)
    out = torch.full_like(w, float("nan"))
    walkers = -(-nr // ROWS)
    for bx in range(-(-nc // BLOCK_X)):
        j = torch.arange(bx * BLOCK_X, (bx + 1) * BLOCK_X)
        j = j[j < nc]
        cols = (torch.where(j == 0, nc - 1, j - 1), j,
                torch.where(j + 1 == nc, 0, j + 1))
        for by in range(-(-walkers // BLOCK_Y)):
            for ty in range(BLOCK_Y):
                i0 = (by * BLOCK_Y + ty) * ROWS
                if i0 >= nr:
                    continue
                rows = []
                for g in range(i0 - 1, i0 + ROWS + 1):
                    i = (nr - 1 if wrap else 0) if g < 0 else \
                        (0 if g >= nr else g)
                    rows.append(([w[i, c] for c in cols],
                                 [s[i, c] for c in cols]))
                for r in range(ROWS):
                    # columns [0], [1], [2] are j-1, j, j+1
                    (wSW, wW, wNW), (sSW, sW, sNW) = rows[r]
                    (wS, wc, wN), (sS, _, sN) = rows[r + 1]
                    (wSE, wE, wNE), (sSE, sE, sNE) = rows[r + 2]
                    j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW)
                    j2 = (wE * (sNE - sSE) - wW * (sNW - sSW)
                          - wN * (sNE - sNW) + wS * (sSE - sSW))
                    j3 = (wNE * (sN - sE) - wSW * (sW - sS)
                          - wNW * (sN - sW) + wSE * (sE - sS))
                    jac = gg * (j1 + j2 + j3) / 3.0
                    lap = ((wE - 2.0 * wc + wW) / (dx * dx)
                           + (wN - 2.0 * wc + wS) / (dy * dy))
                    if i0 + r < nr:
                        out[i0 + r, j] = -jac + lap / re
    return out


def _arakawa_fields(shape, seed):
    rng = np.random.default_rng(seed)
    w, s = rng.standard_normal(shape), rng.standard_normal(shape)
    return w, s, 1.0 / (shape[0] - 1), 1.0 / max(shape[1] - 1, 1)


def test_constants_read_from_the_source():
    """The block sizes the emulations use: a warp's columns, and each
    phase's tasks of one kind fit in half an Euler block."""
    assert BLOCK_X == 32 and BLOCK_Y >= 1 and ROWS >= 1
    assert 1 <= MIN_ROWS <= min(MAX_ROWS, MAX_ROWS64)
    # the backward's walk: a warp a walker, 16-byte lane loads; both
    # backward kernels fold the Re sum with a block of their walkers, the
    # block the emulated fold adds its slots with
    assert BACK_WALKERS >= 1 and VEC_BYTES == 16
    assert BACK_AHEAD >= 1 and FOLD_COUNTERS >= 1
    for source, walkers in (("arakawa_rhs.cu", "kBackWalkers"),
                            ("cavity_stage.cu", "kBackWalkers")):
        text = (_cuda_build.CSRC / source).read_text()
        assert f"fold_re_grad<{walkers}>(block_sum<{walkers}>" in text
        assert f"__launch_bounds__(kBlockX * {walkers})" in text or \
            f"__launch_bounds__(kWarp * {walkers})" in text
    assert 32 * BACK_WALKERS <= 1024
    threads = _constant("euler_rhs.cu", "kThreads")
    assert GHOST == 3 and threads % 64 == 0
    assert 3 * (CELLS + 1) <= threads // 2 and CELLS + 2 <= threads // 2


@pytest.mark.parametrize("shape", ARAKAWA_SHAPES)
def test_arakawa_walkers_match_twin(shape):
    w, s, dx, dy = _arakawa_fields(shape, seed=31)
    wt, st = torch.as_tensor(w), torch.as_tensor(s)
    got = emulate_arakawa(wt, st, dx, dy, RE)
    _assert_rel(got, cuda_kernels.arakawa_rhs_fused_plain(wt, st, dx, dy, RE))


@pytest.mark.parametrize("shape", PALLAS_ARAKAWA_SHAPES)
def test_arakawa_walkers_match_pallas(shape):
    w, s, dx, dy = _arakawa_fields(shape, seed=32)
    ref = np.asarray(pallas_kernels.arakawa_rhs_fused(
        jnp.asarray(w), jnp.asarray(s), dx, dy, RE, tile=8, interpret=True))
    got = emulate_arakawa(torch.as_tensor(w), torch.as_tensor(s), dx, dy, RE)
    _assert_rel(got, ref)


def test_arakawa_missing_wrap_is_caught():
    """A walk that starts without the row wrap disagrees with the twin on
    row 0, so the comparisons above can see a wrong wrap."""
    w, s, dx, dy = _arakawa_fields((37, 53), seed=33)
    wt, st = torch.as_tensor(w), torch.as_tensor(s)
    got = emulate_arakawa(wt, st, dx, dy, RE, wrap=False)
    ref = cuda_kernels.arakawa_rhs_fused_plain(wt, st, dx, dy, RE)
    err = (got - ref).abs().amax(dim=1)
    assert err[0] > 1e-6 * float(ref.abs().max())
    assert float(err[1:].max()) <= 1e-12 * float(ref.abs().max())


# ------------------------------------------------- the Arakawa backward

def _jac(a, b, gg):
    """J(a, b) of two neighbourhoods (c, E, W, N, S, NE, SW, NW, SE), in
    the kernel's order."""
    _, aE, aW, aN, aS, aNE, aSW, aNW, aSE = a
    _, bE, bW, bN, bS, bNE, bSW, bNW, bSE = b
    j1 = (aE - aW) * (bN - bS) - (aN - aS) * (bE - bW)
    j2 = aE * (bNE - bSE) - aW * (bNW - bSW) - aN * (bNE - bNW) + \
        aS * (bSE - bSW)
    j3 = aNE * (bN - bE) - aSW * (bW - bS) - aNW * (bN - bW) + \
        aSE * (bE - bS)
    return gg * (j1 + j2 + j3) / 3.0


def _lap(a, dx, dy):
    c, E, W, N, S = a[:5]
    return (E - 2.0 * c + W) / (dx * dx) + (N - 2.0 * c + S) / (dy * dy)


def _warp_sum(v):
    """Lane 0's value of block_sum's shuffle tree over the last (lane) axis
    (__shfl_down_sync past lane 31 returns the lane's own value)."""
    lane = np.arange(BLOCK_X)
    for d in (16, 8, 4, 2, 1):
        v = v + v[..., np.where(lane + d < BLOCK_X, lane + d, lane)]
    return v[..., 0]


def block_sum(v):
    """csrc/arakawa.cuh block_sum on (warps, 32) fp64 values: each warp's
    shuffle tree, then the warps' sums in order."""
    total = 0.0
    for x in _warp_sum(v):
        total += x
    return total


def emulate_fold(totals, re, scale, warps, counters, order, reset=True,
                 partial_slot=None):
    """csrc/arakawa.cuh fold_re_grad over a (batch, gy, gx) grid of blocks
    of 32 x warps threads whose sums are `totals`: blocks arrive in `order`
    (block indices (b gy + y) gx + x), each writes its sum to its slot
    (partial_slot(b, y, x, gy, gx) overrides it: a wrong kernel) and takes
    a ticket from counters[b % FOLD_COUNTERS]; the block that takes a
    counter's last ticket (gy gx tickets for each member on it) adds, for
    each of those members, its slots, thread t its slots t, t + 32 warps,
    ... in turn, then block_sum, and writes gre[b] = -(scale x sum) /
    re[b]^2; then sets the counter to 0 unless reset is False (a wrong
    kernel).  Slots and gre start as NaN (torch.empty's garbage): a fold
    that runs before every slot is written, or never, leaves NaN."""
    batch, gy, gx = totals.shape
    n, threads = gy * gx, 32 * warps
    partials = np.full(batch * n, np.nan)
    gre = np.full(batch, np.nan)
    for block in order:
        b, rest = divmod(block, n)
        y, x = divmod(rest, gx)
        slot = block if partial_slot is None else \
            partial_slot(b, y, x, gy, gx)
        partials[slot] = totals[b, y, x]
        group = b % FOLD_COUNTERS
        members = range(group, batch, FOLD_COUNTERS)
        ticket, counters[group] = counters[group], counters[group] + 1
        if ticket != n * len(members) - 1:
            continue
        for m in members:
            p = partials[m * n:(m + 1) * n]
            acc = np.zeros(threads)
            for k in range(0, n, threads):        # thread t: slots t + k
                part = p[k:k + threads]
                acc[:len(part)] += part
            gre[m] = -(scale * block_sum(acc.reshape(warps, 32))) / \
                (re[m] * re[m])
        if reset:
            counters[group] = 0
    return gre


def lane_columns(nc, itemsize):
    """The backward launcher's lane width for 16-byte-aligned arrays:
    VEC_BYTES / itemsize columns a lane where nc is a multiple of it, else
    one."""
    vec = VEC_BYTES // itemsize
    return vec if nc % vec == 0 else 1


def backward_grid(nr, nc, cols, rows):
    """(gx, gy) of the backward's grid with `cols` columns a lane and
    strips of `rows` rows."""
    return -(-nc // (BLOCK_X * cols)), -(-(-(-nr // rows)) // BACK_WALKERS)


def back_rows(nr, nc, batch, cols, capacity, most=MAX_ROWS):
    """csrc/arakawa_rhs.cu back_rows: the rows of a walker's strip, for a
    card that holds `capacity` walkers at once: the fewest waves that hold
    the call at `most` rows a strip (MAX_ROWS in fp32, MAX_ROWS64 in
    fp64), then as many strips as those waves hold, each as short as that
    allows (at least MIN_ROWS)."""
    units = -(-nc // (BLOCK_X * cols)) * batch
    waves = -(-units * -(-nr // most) // capacity)
    strips = max(1, waves * capacity // units)
    return min(most, max(MIN_ROWS, -(-nr // strips)))


# walkers a card holds at once in the emulations: a few, so that the small
# shapes take long strips, and an H100's 132 SMs x 4 blocks
CAPACITIES = (8, 132 * 4 * BACK_WALKERS)


def _slot_nbhd(W, C, E, j):
    """arakawa.cuh's nbhd at the slots j of window rows W, C, E (slot k is
    column c-1+k): (c, E, W, N, S, NE, SW, NW, SE)."""
    return (C[..., j], E[..., j], W[..., j], C[..., j + 1], C[..., j - 1],
            E[..., j + 1], W[..., j - 1], W[..., j + 1], E[..., j - 1])


def emulate_arakawa_backward(w, s, g, dx, dy, re, cols=1, rows=MIN_ROWS,
                             partial_slot=None, counters=None, reset=True,
                             order_seed=0, wrap_halo=True):
    """arakawa_rhs_backward as csrc/arakawa_rhs.cu computes it on numpy
    (B, nr, nc) fields, one Re a member, `cols` columns a lane (the
    16-byte lanes' VEC, or 1), strips of `rows` rows.  A warp is a walker
    of the rows a0 .. a0+rows-1 (those < nr) over the columns c0 ..
    c0+32 cols-1: each lane loads its
    columns (clamped to nc-cols past nc) and one halo column (lane 0 the
    column left of the segment, the others the one right of its last
    column, wrapped) of the window rows a0-1 .. a0+rows (row -1 reads
    nr-1, rows nr and past it row 0), takes column c-1 from lane l-1
    (__shfl_up_sync) and c+cols from lane l+1 (__shfl_down_sync: that
    lane's first column, or its halo if it lies past nc), lanes 0 and 31
    their own halos, computes, and stores rows < nr of lanes < nc.  Each
    lane's fp64 sum of g lap(w) (rows, then its columns), block_sum, and
    emulate_fold with blocks arriving in a seeded order.  counters: the
    fold's counters (a list kept across calls); partial_slot,
    reset=False and wrap_halo=False (the ragged segment's right halo not
    wrapped to column 0) are wrong kernels.  Returns (gw, gs, gre)."""
    batch, nr, nc = w.shape
    gx, gy = backward_grid(nr, nc, cols, rows)
    seg = BLOCK_X * cols
    gg, dx2, dy2 = 1.0 / (4.0 * dx * dy), dx * dx, dy * dy
    gw, gs = np.full(w.shape, np.nan), np.full(w.shape, np.nan)
    lane = np.arange(BLOCK_X)
    # the walkers of a column of blocks, (blockIdx.y, threadIdx.y) in order
    a0 = (np.arange(gy)[:, None] * BACK_WALKERS
          + np.arange(BACK_WALKERS)[None, :]).ravel() * rows
    live = a0 < nr
    win_rows = a0[:, None] - 1 + np.arange(rows + 2)[None, :]
    wrapped = np.where(win_rows < 0, nr - 1,
                       np.where(win_rows >= nr, 0, win_rows))
    A = (a0[:, None] + np.arange(rows)[None, :])[:, :, None, None]
    j = np.arange(1, cols + 1)
    totals = np.zeros((batch, gy, gx))
    for b in range(batch):
        for bx in range(gx):
            c0 = bx * seg
            c = c0 + lane * cols
            own = c < nc
            cv = np.where(own, c, nc - cols)
            end = min(c0 + seg, nc)
            right_halo = 0 if end == nc and wrap_halo else end
            hc = np.where(lane == 0, nc - 1 if c0 == 0 else c0 - 1,
                          min(right_halo, nc - 1))
            win = []
            for f in (w[b], s[b], g[b]):
                vals = f[wrapped[:, :, None, None],
                         (cv[:, None] + np.arange(cols))[None, None]]
                halo = f[wrapped[:, :, None], hc[None, None, :]]
                present = np.where(own, vals[..., 0], halo)
                up = np.concatenate([vals[..., :1, -1], vals[..., :-1, -1]],
                                    -1)
                down = np.concatenate([present[..., 1:], present[..., -1:]],
                                      -1)
                left = np.where(lane == 0, halo, up)
                right = np.where(lane == BLOCK_X - 1, halo, down)
                win.append(np.concatenate([left[..., None], vals,
                                           right[..., None]], -1))
            # (c, E, ...) of each field at each output row and lane column
            wn, sn, gn = (_slot_nbhd(x[:, :-2], x[:, 1:-1], x[:, 2:], j)
                          for x in win)
            B = (c[:, None] + np.arange(cols))[None, None]
            store = live[:, None, None, None] & (A < nr) & \
                own[None, None, :, None] & (B < nc)
            d_w = -_jac(sn, gn, gg) + _lap(gn, dx, dy) / re[b]
            d_s = -_jac(gn, wn, gg)
            at = tuple(np.broadcast_to(i, store.shape)[store] for i in (A, B))
            gw[b][at] = d_w[store]
            gs[b][at] = d_s[store]
            term = np.where(store, gn[0] * _lap(wn, dx, dy), 0.0)
            acc = np.zeros((len(a0), BLOCK_X))
            for r in range(rows):
                for e in range(cols):
                    acc += term[:, r, :, e]
            sums = _warp_sum(acc).reshape(gy, BACK_WALKERS)
            for y in range(gy):
                total = 0.0
                for k in range(BACK_WALKERS):
                    total += sums[y, k]
                totals[b, y, bx] = total
    order = np.random.default_rng(order_seed).permutation(batch * gy * gx)
    gre = emulate_fold(totals, np.asarray(re, np.float64), 1.0, BACK_WALKERS,
                       [0] * FOLD_COUNTERS if counters is None else counters,
                       order, reset, partial_slot)
    return gw, gs, gre


# a batch of ragged members, and one member on several blocks both ways
BACKWARD_SHAPES = [(2, 3, 1), (3, 17, 33), (1, 37, 53),
                   (2, 2 * BACK_WALKERS * MIN_ROWS + 7, 2 * BLOCK_X + 6)]
# shapes only the warp walk has: nc = 1, 2, 3; nc = 1 and 2 (mod 4: the
# one-column lanes in fp32) with a part-filled last segment; batches whose
# rows take the 16-byte lanes (fp32 136 = 128 + 8, 132 = 128 + 4: one lane
# in the last segment; fp64 70 = 64 + 6) over ragged walkers
WALK_SHAPES = [(1, 5, 1), (2, 5, 2), (1, 6, 3), (2, 11, 37), (1, 9, 38),
               (2, 13, 136), (1, 6, 132), (2, 7, 70)]


def _backward_fields(shape, seed):
    rng = np.random.default_rng(seed)
    w, s, g = (rng.standard_normal(shape) for _ in range(3))
    re = rng.uniform(50.0, 5000.0, shape[0])
    return w, s, g, 1.0 / (shape[1] - 1), 1.0 / max(shape[2] - 1, 1), re


def _check_backward(got, w, s, g, dx, dy, re):
    """The emulated backward against arakawa_rhs_backward_plain, fp64: the
    fields within 1e-12 of their scale (their largest value or their
    Jacobian term's size), each member's d/dre within 1e-12 relative."""
    t = [torch.as_tensor(x) for x in (w, s, g, re)]
    ref = [x.numpy() for x in cuda_kernels.arakawa_rhs_backward_plain(
        t[0], t[1], t[2], dx, dy, t[3])]
    gg = 1.0 / (4.0 * dx * dy)
    jac = (gg * np.abs(s).max() * np.abs(g).max(),
           gg * np.abs(g).max() * np.abs(w).max())
    for mine, want, term in zip(got[:2], ref[:2], jac):
        scale = max(np.abs(want).max(), term)
        assert np.abs(mine - want).max() <= 1e-12 * scale
    assert np.all(np.abs(got[2] - ref[2]) <= 1e-12 * np.abs(ref[2]))


def _geometries(shape):
    """(columns a lane, rows a strip) the launcher can take at `shape`:
    the lanes of 16-byte-aligned fp32 and fp64 rows and one-column lanes,
    each with the shortest strips and the strips it takes at CAPACITIES."""
    batch, nr, nc = shape
    return sorted({(cols, rows)
                   for cols in (lane_columns(nc, 4), lane_columns(nc, 8), 1)
                   for most in (MAX_ROWS, MAX_ROWS64)
                   for rows in (MIN_ROWS, *(back_rows(nr, nc, batch, cols, k,
                                                      most)
                                            for k in CAPACITIES))})


@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_arakawa_backward_walk_matches_plain(shape):
    """The backward's walk against arakawa_rhs_backward_plain in fp64, with
    the lanes the launcher takes for 16-byte-aligned fp32 and fp64 rows
    and with one-column lanes, at each strip length it can take."""
    w, s, g, dx, dy, re = _backward_fields(shape, seed=sum(shape))
    for cols, rows in _geometries(shape):
        _check_backward(emulate_arakawa_backward(w, s, g, dx, dy, re, cols,
                                                 rows), w, s, g, dx, dy, re)


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_arakawa_backward_lane_widths_match_plain(shape):
    """The walk at the widths only it has (nc = 1, 2, 3; part-filled last
    segments; a single lane in the last segment) with each lane width the
    launcher can take there, and the fold's result independent of which
    block finishes last (two arrival orders, bitwise)."""
    w, s, g, dx, dy, re = _backward_fields(shape, seed=3 * sum(shape))
    for cols, rows in _geometries(shape):
        got = emulate_arakawa_backward(w, s, g, dx, dy, re, cols, rows)
        _check_backward(got, w, s, g, dx, dy, re)
        other = emulate_arakawa_backward(w, s, g, dx, dy, re, cols, rows,
                                         order_seed=1)
        assert np.array_equal(other[2], got[2])


def test_arakawa_backward_takes_both_lane_widths():
    """The shapes above reach the 16-byte lanes in fp32 (4 columns) and
    fp64 (2), and the one-column lanes with nc = 1, 2 and 3 (mod 4)."""
    widths = {(nc % 4, lane_columns(nc, size)) for _, _, nc in WALK_SHAPES
              for size in (4, 8)}
    assert {(0, 4), (2, 2), (1, 1), (2, 1), (3, 1)} <= widths


def test_arakawa_backward_members_share_fold_counters():
    """A batch of more members than the fold has counters: members b and b
    + FOLD_COUNTERS take their tickets from one counter, and the block that
    takes its last adds both members' slots.  Each member's gre against the
    plain version, bitwise under two arrival orders, and every counter
    back at 0."""
    shape = (FOLD_COUNTERS + 3, 6, 2)
    w, s, g, dx, dy, re = _backward_fields(shape, seed=11)
    counters = [0] * FOLD_COUNTERS
    got = emulate_arakawa_backward(w, s, g, dx, dy, re, counters=counters)
    _check_backward(got, w, s, g, dx, dy, re)
    assert counters == [0] * FOLD_COUNTERS
    other = emulate_arakawa_backward(w, s, g, dx, dy, re, order_seed=5)
    assert np.array_equal(other[2], got[2])


def test_arakawa_backward_wrong_slot_is_caught():
    """Partial sums written to another member's slots move the Re
    gradients off the plain version's, so the test above can see a wrong
    slot index."""
    w, s, g, dx, dy, re = _backward_fields((2, 17, 33), seed=7)
    got = emulate_arakawa_backward(
        w, s, g, dx, dy, re,
        partial_slot=lambda b, by, bx, gy, gx: ((1 - b) * gy + by) * gx + bx)
    ref = cuda_kernels.arakawa_rhs_backward_plain(
        *(torch.as_tensor(x) for x in (w, s, g)), dx, dy, torch.as_tensor(re))
    assert not np.allclose(got[2], ref[2].numpy(), rtol=1e-6)


def test_arakawa_backward_unreset_counter_is_caught():
    """The fold's counters carry over between calls: reset by each
    member's last block, a second call's gre is the first's bit for bit;
    left at their members' block counts (a wrong kernel), no block of the
    second call takes a last ticket and its gre is never written."""
    w, s, g, dx, dy, re = _backward_fields((2, 17, 33), seed=8)
    for reset in (True, False):
        counters = [0] * FOLD_COUNTERS
        first, second = (emulate_arakawa_backward(
            w, s, g, dx, dy, re, counters=counters, reset=reset,
            order_seed=k)[2] for k in range(2))
        _check_backward(emulate_arakawa_backward(w, s, g, dx, dy, re),
                        w, s, g, dx, dy, re)
        assert np.all(np.isfinite(first))
        assert np.array_equal(first, second) == reset


def test_arakawa_backward_unwrapped_halo_is_caught():
    """A ragged last segment whose right halo reads column nc-1 instead of
    wrapping to column 0 moves the last column's gradients off the plain
    version's, so the comparisons see a wrong neighbour column."""
    w, s, g, dx, dy, re = _backward_fields((1, 9, 37), seed=9)
    with pytest.raises(AssertionError):
        _check_backward(emulate_arakawa_backward(w, s, g, dx, dy, re,
                                                 wrap_halo=False),
                        w, s, g, dx, dy, re)


# --------------------------------------------------------------- Euler RHS

def _mirror(i, nx, reflect=True):
    """The kernel's ghost map: cell i < 0 reads -i-1, i >= nx reads
    2nx-1-i, then clamped into the array (reflect=False: clamp only, a
    wrong kernel)."""
    if reflect:
        i = torch.where(i < 0, -i - 1, torch.where(i >= nx, 2 * nx - 1 - i,
                                                   i))
    return i.clamp(0, nx - 1)


def emulate_euler(q, gamma, dx, solver, wavespeed, reflect=True):
    """euler_rhs_fused as the CUDA kernel's blocks compute it: stage, the
    tile's interface states and fluxes, the divergence of its cells."""
    nx = q.shape[1]
    faces = CELLS + 1
    out = torch.full_like(q, float("nan"))
    for b in range(-(-nx // CELLS)):
        c0 = b * CELLS
        sq = q[:, _mirror(torch.arange(c0 - GHOST, c0 + CELLS + GHOST), nx,
                          reflect)]
        # interface k: L on slots k..k+4, R on slots k+1..k+5
        qL = weno.weno5_L(*(sq[:, i:i + faces] for i in range(5)))
        qR = weno.weno5_R(*(sq[:, i + 1:i + 1 + faces] for i in range(5)))
        fL, fR = riemann.flux(qL, gamma), riemann.flux(qR, gamma)
        if solver == "rusanov" and wavespeed == "spectral":
            # radii of cells c0-1 .. c0+CELLS; cell c at c - c0 + 1
            rho, u, _, p, _ = riemann.primitives(
                sq[:, GHOST - 1:GHOST + CELLS + 1], gamma)
            rad = torch.abs(u) + torch.sqrt(torch.abs(gamma * p / rho))
            jj = (c0 + torch.arange(faces)).clamp(1, nx - 1)
            ps = torch.maximum(rad[jj - c0], rad[jj - c0 + 1])
            f = riemann.rusanov(qL, qR, fL, fR, gamma, ps=ps)
        elif solver == "rusanov":
            f = riemann.rusanov(qL, qR, fL, fR, gamma, wavespeed=wavespeed)
        else:
            f = {"roe": riemann.roe, "hllc": riemann.hllc}[solver](
                qL, qR, fL, fR, gamma)
        n = min(CELLS, nx - c0)
        out[:, c0:c0 + n] = (-(f[:, 1:] - f[:, :-1]) / dx)[:, :n]
    return out


def _euler_state(nx, seed):
    """Physical cells: rho, p in [0.1, 2], u in [-1.5, 1.5]."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.1, 2.0, nx)
    u = rng.uniform(-1.5, 1.5, nx)
    p = rng.uniform(0.1, 2.0, nx)
    return np.stack([rho, rho * u, p / (GAMMA - 1) + 0.5 * rho * u**2])


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("nx", EULER_NX)
def test_euler_tiles_match_twin(nx, variant):
    q = torch.as_tensor(_euler_state(nx, seed=nx))
    got = emulate_euler(q, GAMMA, 1.0 / nx, *variant)
    _assert_rel(got, cuda_kernels.euler_rhs_fused_plain(q, GAMMA, 1.0 / nx,
                                                        *variant))


@functools.lru_cache(maxsize=None)
def _pallas_euler(nx, solver, wavespeed):
    return np.asarray(pallas_kernels.euler_rhs_fused(
        jnp.asarray(_euler_state(nx, seed=nx)), GAMMA, 1.0 / nx, solver,
        interpret=True, rusanov_wavespeed=wavespeed))


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("nx", EULER_NX)
def test_euler_tiles_match_pallas(nx, variant):
    q = torch.as_tensor(_euler_state(nx, seed=nx))
    got = emulate_euler(q, GAMMA, 1.0 / nx, *variant)
    _assert_rel(got, _pallas_euler(nx, *variant))


def test_euler_missing_mirror_is_caught():
    """Ghosts that clamp instead of reflecting change the interfaces near
    both ends, so the comparisons above can see a wrong ghost map."""
    nx = 2 * CELLS + 5
    q = torch.as_tensor(_euler_state(nx, seed=7))
    got = emulate_euler(q, GAMMA, 1.0 / nx, "hllc", "roe", reflect=False)
    ref = cuda_kernels.euler_rhs_fused_plain(q, GAMMA, 1.0 / nx, "hllc")
    err = (got - ref).abs().amax(dim=0)
    scale = float(ref.abs().max())
    assert err[0] > 1e-6 * scale and err[-1] > 1e-6 * scale
    assert float(err[GHOST:-GHOST].max()) <= 1e-12 * scale


# ------------------------------------------------------------------ div_rn

def _round(x: Fraction, bits: int, emin: int) -> Fraction:
    """x rounded once to the nearest binary float with `bits` significant
    bits and least normal exponent emin (ties to even; no overflow)."""
    if x == 0:
        return Fraction(0)
    a = abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    quantum = Fraction(2) ** (max(e, emin) - bits + 1)
    m = a / quantum
    n = math.floor(m)
    if m - n > Fraction(1, 2) or (m - n == Fraction(1, 2) and n % 2):
        n += 1
    return (n * quantum) if x > 0 else -(n * quantum)


FORMATS = {"fp32": (24, -126, np.float32), "fp64": (53, -1022, np.float64)}


def _div_rn(x: Fraction, d: Fraction, fmt: str):
    """div_rn(x, d, rcp_rn(d)) with each operation rounded once:
    rcp = RN(1/d); q = RN(x * rcp); r = RN(x - q * d) (an FMA);
    RN(r * rcp + q) (an FMA)."""
    bits, emin, _ = FORMATS[fmt]

    def rn(v):
        return _round(v, bits, emin)

    rcp = rn(1 / d)
    q = rn(x * rcp)
    r = rn(x - q * d)
    return rn(r * rcp + q), q


def _operands(kind, fmt, n=400):
    """Seeded (x, d) pairs over the ranges a kernel divides: Arakawa's and
    the Euler divergence's constant divisors, the WENO weights and their
    normalisation, the Euler states' rho, and a wide spread."""
    rng = np.random.default_rng(["constants", "weno", "rho", "wide"]
                                .index(kind) + 100 * (fmt == "fp64"))
    dt = FORMATS[fmt][2]

    def logu(lo, hi, size, signed=True):
        v = 10.0 ** rng.uniform(lo, hi, size)
        return v * rng.choice([-1.0, 1.0], size) if signed else v

    if kind == "constants":
        nx = rng.integers(16, 8193, n).astype(np.float64)
        d = np.choose(rng.integers(0, 6, n), [
            np.full(n, 3.0), np.full(n, 6.0), (1.0 / nx) ** 2,
            1.0 / nx, rng.choice([100.0, 1000.0, 3200.0], n),
            np.full(n, 0.4)])
        x = logu(-4, 9, n)
    elif kind == "weno":
        s = np.where(rng.random(n) < 0.1, 0.0, logu(-12, 4, n, False))
        d = (1e-6 + s.astype(dt)) ** 2
        x = np.where(rng.random(n) < 0.5, rng.choice([0.1, 0.3, 0.6], n),
                     logu(-8, 13, n))
    elif kind == "rho":
        d = logu(-3, 1, n)
        x = logu(-6, 2, n)
    else:
        d = logu(-30, 30, n)
        x = logu(-30, 30, n)
    return [(Fraction(float(a)), Fraction(float(b)))
            for a, b in zip(x.astype(dt), d.astype(dt))]


@pytest.mark.parametrize("fmt", ["fp32", "fp64"])
def test_round_is_the_cast(fmt):
    """_round to fp32 agrees with numpy's cast of a double (itself
    correctly rounded); to fp64 with Python's float() of a fraction."""
    rng = np.random.default_rng(5)
    bits, emin, dt = FORMATS[fmt]
    for v in rng.standard_normal(300) * 10.0 ** rng.uniform(-20, 20, 300):
        x = Fraction(float(v)) if fmt == "fp32" else \
            Fraction(float(v)) / 3
        want = float(dt(float(v))) if fmt == "fp32" else float(x)
        assert _round(x, bits, emin) == Fraction(want)


def test_div_rn_header_is_the_emulated_formula():
    text = (_cuda_build.CSRC / "div_rn.cuh").read_text()
    for line in ["const float q = x * rcp;",
                 "return fmaf(fmaf(-q, d, x), rcp, q);",
                 "const double q = x * rcp;",
                 "return fma(fma(-q, d, x), rcp, q);",
                 "rcp_rn(float d) { return __frcp_rn(d); }",
                 "rcp_rn(double d) { return __drcp_rn(d); }"]:
        assert line in text, line


@pytest.mark.parametrize("kind", ["constants", "weno", "rho", "wide"])
@pytest.mark.parametrize("fmt", ["fp32", "fp64"])
def test_div_rn_is_ieee_division(fmt, kind):
    """div_rn equals the correctly rounded quotient on every operand pair,
    and its FMA correction is needed: the uncorrected x * rcp is off on
    some of them."""
    bits, emin, _ = FORMATS[fmt]
    corrected = 0
    for x, d in _operands(kind, fmt):
        got, q = _div_rn(x, d, fmt)
        want = _round(x / d, bits, emin)
        assert got == want, (float(x), float(d), float(got), float(want))
        corrected += q != want
    assert corrected > 0
