"""The packed cavity stage's backward kernel's walk, emulated in numpy on
the CPU.

The CUDA kernel behind cavity_fused_stage_backward (cfd_julia_torch/csrc/
cavity_stage.cu, cavity_stage_backward_kernel) takes the forward's walk to
three fields: a warp of LANES lanes is a walker, each lane owning VEC =
VEC_BYTES / itemsize adjacent columns of BACK_ROWS output rows,
BACK_WALKERS walkers a block stacked along axis 0.  A lane loads each row
of its window (rows a0-1 .. a0+BACK_ROWS) of the cotangent g, wt and psi
as one vector, takes the columns beside its own from the neighbouring
lanes (lane 0 and lane 31 from the warp's two halo loads), and a walker
outside the raw interior clamps its addresses and extends each field its
own way (q by 0 past the logical interior, psi by 0 past the buffer, wt by
its walls).  This file replays that data path in numpy, with the
constants read from the source, and holds:

- every point of gw, gwt and gs and every entry of the four wall-vector
  gradients to be written exactly once;
- the interior walkers to need no clamped address, no extension, no mask
  and no wall term;
- the block grid to give as many Re partials as cavity_stage_backward_
  partials' formula, mirrored here;
- the emulated backward (windows, shuffles, extensions, the next walls'
  adjoint, the frame's gradients, the fp64 per-lane sums, the block sums
  and the last block's fold of them, csrc/arakawa.cuh fold_re_grad, in
  the kernel's orders, with the blocks arriving in a seeded order) to
  equal cavity_fused_stage_backward_plain within 1e-12 in fp64; d/dRe
  within 1e-12 of c sum|q lap W| / re^2, the size of its terms (the two
  sums add ~1e6 terms in other orders).

The card test (tests/test_torch_cuda.py) compares the library's exported
constants and partial count with these, and the kernel with the plain
version.
"""
import re

import numpy as np
import pytest
import torch

from cfd_julia_torch.models import cavity_fused
from cfd_julia_torch.ops import _cuda_build, cuda_kernels
# kernel 1's fold of the Re partials (csrc/arakawa.cuh), the same code
from test_torch_rhs_tiling import FOLD_COUNTERS, emulate_fold
# the forward's extension of wt by its walls, the same W
from test_torch_stage_tiling import _wall_w

torch.set_num_threads(1)

_SOURCE = (_cuda_build.CSRC / "cavity_stage.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE).group(1))


BACK_ROWS = _constant("kBackRows")
BACK_WALKERS = _constant("kBackWalkers")
VEC_BYTES = _constant("kVecBytes")
LANES = _constant("kWarp")
# (nx, ny) of the packed cavity: the card's shapes (tests/test_torch_cuda.py
# STAGE_SHAPES); m = P at 33x47 and 9x129, n = Q at 9x129, both at 1025^2
STAGE_SHAPES = [(1024, 1024), (16, 16), (24, 16), (33, 47), (34, 130),
                (9, 129), (1025, 1025), (3, 3)]
# raw buffers (P, Q, m, n) the packed layout never makes, which the kernel
# takes: a ragged last walker, m = P with n = Q, one lane's columns
RAW_SHAPES = [(13, 128, 11, 100), (13, 128, 13, 128), (5, 264, 2, 2),
              (21, 72, 20, 70)]
# every stage and wall-BC order
COMBOS = [(stage, order) for stage in (1, 2, 3) for order in (1, 2)]
# the stage's combine a w + b wt + c r, c a multiple of dt
COEFFS = cuda_kernels._STAGE_COEFFS


def test_constants_read_from_the_source():
    """A warp's lanes, a 16-byte row load, at least one row and walker."""
    assert LANES == 32 and VEC_BYTES == 16
    assert BACK_ROWS >= 1 and BACK_WALKERS >= 1


def grid(P, Q, itemsize):
    """The backward's blocks (x: column segments, y: walker groups)."""
    seg = LANES * VEC_BYTES // itemsize
    walkers = -(-P // BACK_ROWS)
    return -(-Q // seg), -(-walkers // BACK_WALKERS)


def partials(P, Q):
    """cavity_stage_backward_partials(P, Q): the larger grid's blocks."""
    return max(bx * by for bx, by in (grid(P, Q, 4), grid(P, Q, 8)))


def _inputs(P, Q, seed):
    """Fields, wall vectors and cotangents of scale 1 on the whole buffer
    (the padding too: the adjoint must not lean on its zeros)."""
    rng = np.random.default_rng(seed)
    wt, s, g = (rng.standard_normal((P, Q)) for _ in range(3))
    walls, h = ([rng.standard_normal(k) for k in (Q, Q, P, P)]
                for _ in range(2))
    return wt, s, walls, g, h


def _nbhd(W, C, E, j, left=True, right=True):
    """arakawa.cuh's Nbhd at the slots j of the rows W (a-1), C, E (a+1):
    c, E, W, N, S, NE, SW, NW, SE; left / right False: the columns j-1 /
    j+1 taken as 0 (nbhd_left0, nbhd_right0)."""
    z = np.zeros(C.shape[:-1] + (len(j),))
    at = lambda X, k, use=True: X[..., k] if use else z
    return dict(c=at(C, j), E=at(E, j), W=at(W, j), N=at(C, j + 1, right),
                S=at(C, j - 1, left), NE=at(E, j + 1, right),
                SW=at(W, j - 1, left), NW=at(W, j + 1, right),
                SE=at(E, j - 1, left))


def _jacobian(a, b, gg):
    j1 = (a["E"] - a["W"]) * (b["N"] - b["S"]) \
        - (a["N"] - a["S"]) * (b["E"] - b["W"])
    j2 = (a["E"] * (b["NE"] - b["SE"]) - a["W"] * (b["NW"] - b["SW"])
          - a["N"] * (b["NE"] - b["NW"]) + a["S"] * (b["SE"] - b["SW"]))
    j3 = (a["NE"] * (b["N"] - b["E"]) - a["SW"] * (b["W"] - b["S"])
          - a["NW"] * (b["N"] - b["W"]) + a["SE"] * (b["E"] - b["S"]))
    return gg * (j1 + j2 + j3) / 3.0


def _laplacian(a, dx2, dy2):
    return (a["E"] - 2.0 * a["c"] + a["W"]) / dx2 \
        + (a["N"] - 2.0 * a["c"] + a["S"]) / dy2


def _warp_sum(v):
    """block_sum's shuffle tree over the last (lane) axis: lane 0's
    value (__shfl_down_sync past lane 31 returns the lane's own)."""
    lane = np.arange(LANES)
    for d in (16, 8, 4, 2, 1):
        v = v + v[..., np.where(lane + d < LANES, lane + d, lane)]
    return v[..., 0]


def emulate(wt, s, walls, g, h, stage, dt, dx, dy, re, m, n, order,
            itemsize, halo_shift=0):
    """The backward kernel's walk on numpy buffers, one column segment
    (blockIdx.x) at a time.  Returns (outputs, write counts, the Re
    partials, gre, the share of interior walkers), outputs = (gw, gwt, gs,
    g_rl, g_rh, g_cl, g_ch), gw unwritten (NaN) at stage 1.  halo_shift
    moves the right halo load (a wrong kernel, to show that the comparisons
    see it)."""
    P, Q = wt.shape
    V = VEC_BYTES // itemsize
    assert Q % V == 0
    seg = LANES * V
    R = BACK_ROWS
    rl, rh, cl, ch = walls
    h_rl, h_rh, h_cl, h_ch = h
    a_c, b_c, c_c = COEFFS[stage]
    c = c_c * dt
    k0, k1 = (-2.0, 0.0) if order == 1 else (-4.0, 0.5)
    lid = -3.0 / dy if order == 2 else -2.0 / dy
    gg, dx2, dy2 = 1.0 / (4.0 * dx * dy), dx * dx, dy * dy
    bx, by = grid(P, Q, itemsize)
    # the walkers of a column of blocks, (blockIdx.y, threadIdx.y) in order
    a0 = ((np.arange(by)[:, None] * BACK_WALKERS
           + np.arange(BACK_WALKERS)[None, :]).ravel() * R)
    live = a0 < P                     # the others skip to the block sum
    win_g = a0[:, None] - 1 + np.arange(R + 2)[None, :]       # (A, R+2)
    gv = np.clip(win_g, 0, P - 1)
    a = a0[:, None] + np.arange(R)[None, :]                   # (A, R)
    lane = np.arange(LANES)
    outs = [np.full((P, Q), np.nan) for _ in range(3)] + \
        [np.full(k, np.nan) for k in (Q, Q, P, P)]
    counts = [np.zeros(o.shape, int) for o in outs]
    block_sums = np.zeros((by, bx))
    n_interior = 0

    def write(k, idx, val, hit):
        hit = np.broadcast_to(hit, np.broadcast(val, hit).shape)
        idx = tuple(np.broadcast_to(i, hit.shape)[hit] for i in idx)
        outs[k][idx] = np.broadcast_to(val, hit.shape)[hit]
        np.add.at(counts[k], idx, 1)

    for sx in range(bx):
        c0 = sx * seg
        cl_ = c0 + lane * V                                    # (L,)
        interior = (live & (a0 >= 2) & (a0 + R <= m - 2) & (c0 >= 2)
                    & (c0 + seg <= n - 2))                     # (A,)
        n_interior += int(interior.sum())
        hc = np.where(lane == 0, c0 - 1, c0 + seg + halo_shift)
        cv, hcv = np.minimum(cl_, Q - V), np.clip(hc, 0, Q - 1)
        # an interior walker's addresses need no clamp
        inner = interior[:, None]
        assert np.all(~inner | (win_g == gv))
        if interior.any():
            assert np.array_equal(cl_, cv) and np.array_equal(hc, hcv)

        def window(field):
            """(A, R+2, L, V+2): the lane's own vector, the neighbours'
            columns by shuffles, lanes 0 and 31 from the halo loads."""
            own = field[gv[:, :, None, None],
                        (cv[:, None] + np.arange(V))[None, None, :, :]]
            halo = field[gv[:, :, None], hcv[None, None, :]]
            left = np.concatenate([halo[..., :1], own[..., :-1, V - 1]], -1)
            right = np.concatenate([own[..., 1:, 0], halo[..., -1:]], -1)
            return np.concatenate([left[..., None], own, right[..., None]],
                                  -1)

        G = win_g[:, :, None, None]                            # (A,R+2,1,1)
        cj = (cl_[:, None] - 1 + np.arange(V + 2))[None, None]  # (1,1,L,V+2)
        cjv = np.clip(cj, 0, Q - 1)
        raw = dict(q=window(g), w=window(wt), s=window(s))
        ext = dict(q=np.where((G >= 0) & (G < m) & (cj >= 0) & (cj < n),
                              raw["q"], 0.0),
                   s=np.where((G >= 0) & (G < P) & (cj >= 0) & (cj < Q),
                              raw["s"], 0.0),
                   w=_wall_w(raw["w"], G, cj, m, n, rl[cjv], rh[cjv],
                             cl[np.clip(G, 0, P - 1)],
                             ch[np.clip(G, 0, P - 1)], lid))
        inner4 = interior[:, None, None, None]
        win = {}
        for f in ("q", "w", "s"):
            # an interior walker's window needs no extension
            assert np.array_equal(np.where(inner4, ext[f], raw[f]), raw[f])
            win[f] = np.where(inner4, raw[f], ext[f])

        # rows W, C, E of each output row r: (A, R, L, V+2)
        rows = {f: [x[:, k:k + R] for k in range(3)] for f, x in win.items()}
        j = np.arange(1, V + 1)
        qn = _nbhd(*rows["q"], j)
        wn = _nbhd(*rows["w"], j)
        sn = _nbhd(*rows["s"], j)
        A = a[:, :, None, None]                                # (A,R,1,1)
        B = (cl_[:, None] + np.arange(V))[None, None]          # (1,1,L,V)
        edge = ~interior[:, None, None, None]
        gs = c * -_jacobian(qn, wn, gg)
        inb = B < Q
        for cond, hv, idx, kk, h2 in (
                (A == 0, h_rl, B, k0, dx2), (A == 1, h_rl, B, k1, dx2),
                (A == m - 1, h_rh, B, k0, dx2), (A == m - 2, h_rh, B, k1, dx2),
                ((A < m) & (B == 0), h_cl, A, k0, dy2),
                ((A < m) & (B == 1), h_cl, A, k1, dy2),
                ((A < m) & (B == n - 1), h_ch, A, k0, dy2),
                ((A < m) & (B == n - 2), h_ch, A, k1, dy2)):
            hit = cond & inb & live[:, None, None, None]
            # no interior walker meets a wall term
            assert not np.any(hit & ~edge)
            if kk:
                gs = np.where(hit, gs + kk * hv[np.minimum(idx, len(hv) - 1)]
                              / h2, gs)
        valid = (A < m) & (B < n)
        assert np.all(valid | edge)
        d_w = -_jacobian(sn, qn, gg) + _laplacian(qn, dx2, dy2) / re
        gwt = np.where(valid, b_c * qn["c"] + c * d_w, 0.0)
        gw = a_c * qn["c"]
        # the stores: a live walker's rows inside the buffer, lanes inside
        stored = (live[:, None, None, None] & (A < P)
                  & (cl_ < Q)[None, None, :, None])
        for k, val in enumerate((gw, gwt, gs)):
            if k or stage != 1:       # gw is null at stage 1
                write(k, (A, B), val, stored)
        # the Re sum: each lane's points in order (r, then e) in fp64,
        # then block_sum (the shuffle tree, the walkers in order)
        term = np.where(valid & stored, qn["c"] * _laplacian(wn, dx2, dy2),
                        0.0)
        acc = np.zeros((len(a0), LANES))
        for r in range(R):
            for e in range(V):
                acc += term[:, r, :, e]
        warp = _warp_sum(acc).reshape(by, BACK_WALKERS)
        total = np.zeros(by)
        for w in range(BACK_WALKERS):
            total += warp[:, w]
        block_sums[:, sx] = total

        # the frame: rows -1 (by row 0's walker: a zero row above) and m
        # (by row m-1's: a zero row below); columns -1 (column 0's lane:
        # slot 0, a zero column left) and n (column n-1's: its right slot,
        # a zero column right)
        zero = np.zeros_like(rows["q"][0])
        for k, hit, rw in (
                (3, A == 0, lambda f: (zero, rows[f][0], rows[f][1])),
                (4, A == m - 1, lambda f: (rows[f][1], rows[f][2], zero))):
            d = -_jacobian(_nbhd(*rw("s"), j), _nbhd(*rw("q"), j), gg) \
                + _laplacian(_nbhd(*rw("q"), j), dx2, dy2) / re
            write(k, (B,), np.where(B < n, c * d, 0.0),
                  hit & stored & edge)
        j0 = np.array([0])
        d = -_jacobian(_nbhd(*rows["s"], j0, left=False),
                       _nbhd(*rows["q"], j0, left=False), gg) \
            + _laplacian(_nbhd(*rows["q"], j0, left=False), dx2, dy2) / re
        write(5, (A[..., :1],), np.where(A < m, c * d, 0.0),
              stored[..., :1] & (cl_ == 0)[None, None, :, None] & edge)
        jn = np.arange(2, V + 2)
        d = -_jacobian(_nbhd(*rows["s"], jn, right=False),
                       _nbhd(*rows["q"], jn, right=False), gg) \
            + _laplacian(_nbhd(*rows["q"], jn, right=False), dx2, dy2) / re
        write(6, (A,), np.where(A < m, c * d, 0.0),
              stored & (B == n - 1) & edge)

    p = block_sums.ravel()            # blockIdx.y * gridDim.x + blockIdx.x
    order = np.random.default_rng(len(p)).permutation(len(p))
    gre = emulate_fold(block_sums[None], [re], c, BACK_WALKERS,
                       [0] * FOLD_COUNTERS, order)[0]
    share = n_interior / (bx * live.sum())
    return outs, counts, p, gre, share


def _check(P, Q, m, n, itemsize, stage, order, seed, halo_shift=0):
    """The emulated walk against the write counts, the partial count and
    the plain version; returns the share of interior walkers."""
    wt, s, walls, g, h = _inputs(P, Q, seed)
    dt, dx, dy, re = 2e-3, 1.0 / (m + 1), 1.0 / (n + 1), 100.0
    args = (stage, dt, dx, dy, re, m, n, order)
    outs, counts, p, gre, share = emulate(
        wt, s, walls, g, h, *args, itemsize=itemsize, halo_shift=halo_shift)
    for k, count in enumerate(counts):
        assert np.all(count == (0 if k == 0 and stage == 1 else 1))
    bx, by = grid(P, Q, itemsize)
    assert len(p) == bx * by <= partials(P, Q)
    if itemsize == 8:
        assert len(p) == partials(P, Q)
    t = lambda x: torch.as_tensor(x)
    gw, gwt, gs, gwalls, gre_ref = \
        cuda_kernels.cavity_fused_stage_backward_plain(
            t(wt), t(s), tuple(map(t, walls)), t(g), tuple(map(t, h)), *args)
    for got, ref in zip(outs, (gw, gwt, gs, *gwalls)):
        if ref is None:               # stage 1: wt is w, no gw
            continue
        ref = ref.numpy()
        assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)
    # d/dRe against the size of its terms, c sum|q lap W| / re^2
    lap = cuda_kernels.arakawa.laplacian(torch.nn.functional.pad(
        cuda_kernels._extended_w(t(wt), tuple(map(t, walls)), m, n,
                                 cuda_kernels._lid(dy, order)),
        (1, 1, 1, 1)), dx, dy)[2:m + 2, 2:n + 2].numpy()
    scale = COEFFS[stage][2] * dt * np.abs(g[:m, :n] * lap).sum() / re**2
    assert abs(gre - float(gre_ref)) <= 1e-12 * scale
    return share


@pytest.mark.parametrize("itemsize", [4, 8], ids=["fp32", "fp64"])
@pytest.mark.parametrize("nx,ny", STAGE_SHAPES)
def test_backward_walk_at_packed_shapes(nx, ny, itemsize):
    """At every packed shape and both dtypes' geometry: each output and
    wall-gradient entry written once, the partial count, the emulated
    backward equal to the plain version; every stage and wall-BC order
    below 1024^2 (there stage 2 with Jensen walls, the call a packed
    gradient makes)."""
    m, n = nx - 1, ny - 1
    P, Q = cavity_fused.padded_extents(nx, ny)
    combos = [(2, 2)] if P * Q > 2**18 else COMBOS
    for stage, order in combos:
        share = _check(P, Q, m, n, itemsize, stage, order,
                       seed=nx + 7 * stage + order)
        if (nx, ny) == (1024, 1024):
            # the first and last column segments and row walkers take the
            # edge path, the rest the raw one
            assert 0.5 < share < 1


@pytest.mark.parametrize("itemsize", [4, 8], ids=["fp32", "fp64"])
@pytest.mark.parametrize("P,Q,m,n", RAW_SHAPES)
def test_backward_walk_on_raw_buffers(P, Q, m, n, itemsize):
    """Buffers the packed layout does not make but the kernel takes: a
    last walker past the buffer's end, m = P and n = Q, m = n = 2, Q not a
    multiple of a segment (lanes past the buffer load in bounds and store
    nothing); every stage and wall-BC order."""
    for stage, order in COMBOS:
        _check(P, Q, m, n, itemsize, stage, order,
               seed=P * Q + m + 7 * stage + order)


def test_partials_cover_both_geometries():
    """The Re partials' buffer holds the fp64 grid's blocks, at least as
    many as the fp32 grid's (a walker spans half the columns)."""
    for nx, ny in STAGE_SHAPES:
        P, Q = cavity_fused.padded_extents(nx, ny)
        f32, f64 = (bx * by for bx, by in (grid(P, Q, 4), grid(P, Q, 8)))
        assert f32 <= f64 == partials(P, Q)


def test_emulation_sees_a_wrong_halo():
    """The comparisons see a walk that takes the right halo column one too
    far: the emulated backward then misses the plain version."""
    P, Q = cavity_fused.padded_extents(34, 130)
    with pytest.raises(AssertionError):
        _check(P, Q, 33, 129, 4, 2, 2, seed=3, halo_shift=1)
