"""The multigrid kernels' schedules, emulated in PyTorch on the CPU.

The CUDA kernels behind smooth_residual_restrict_fused and
prolong_correct_smooth_fused (cfd_julia_torch/csrc/multigrid.cu) run every
sweep of a V-cycle edge in one pass over shared-memory tiles: a tile of
(rows x TILE_COLS) nodes, halo included (rows per kernel and word size),
loaded with zeros outside the grid; half-sweep h relaxes only nodes at
least h+1 from the tile's edge; colour and the interior test use global
indices; the descend edge has a halo of 2s+2 and restricts the residual
over the coarse nodes its fine nodes cover, the ascend edge a halo of 2s
(+1 with the residual sum, one partial a tile); more than K sweeps run as
several passes.  A wrong halo, tile origin or colour still gives a
plausible solve, so this file emulates that schedule tile by tile and
holds it, in fp64, to rel 1e-12 against the plain twins (the operation
order is the only difference), and against the JAX package's Pallas
kernels in interpret mode wherever their 8-row GUARD admits the sweeps.
The smoother behind redblack_sweeps_fused takes a level of at most
kLevelNodes nodes whole into one block's shared memory as colour planes,
and runs every half-sweep there by pair slot; a larger level goes through
sweep-only tiles (halo 2s, rows of their own) in passes of K sweeps.  Both are emulated here too: the whole level with
its plane addressing (the words no node owns hold NaN, so a read of one
shows), the tiles with the edges' emulation.
K, the tile sizes and the node limit are read from the .cu source, so the
emulation follows the kernels; the CUDA kernels themselves are held
against the twins on a GPU in tests/test_torch_cuda.py.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch.ops import _cuda_build, cuda_kernels
from cfd_julia_tpu.ops import pallas_kernels

torch.set_num_threads(1)


def _tile_constants():
    """K, the tile width, and the tile rows of the descend kernel, of the
    sweep kernel (the ascend edge and every pass before an edge's last)
    and of the smoother's tile kernel by compute word size, and the most
    nodes of a level that the smoother takes into one block."""
    src = (_cuda_build.CSRC / "multigrid.cu").read_text()
    k = re.search(r"constexpr int kSweepsPerPass = (\d+);", src)
    cols = re.search(r"constexpr int kTileCols = (\d+);", src)

    def rows(fn):
        m = re.search(fn + r"\(\) \{\n\s*return sizeof\(C\) == 4 \? (\d+) : "
                      r"(\d+);", src)
        return {4: int(m.group(1)), 8: int(m.group(2))}

    limit = re.search(r"constexpr int kLevelNodes = (\d+) \* (\d+);", src)
    return (int(k.group(1)), int(cols.group(1)), rows("restrict_rows"),
            rows("sweep_rows"), rows("rb_rows"),
            int(limit.group(1)) * int(limit.group(2)))


(K, TILE_COLS, RESTRICT_ROWS, SWEEP_ROWS, RB_ROWS,
 LEVEL_NODES) = _tile_constants()
# the most dynamic shared memory a Hopper block may use (227 KB)
BLOCK_SMEM_BYTES = 227 * 1024
GUARD = 8                                 # the TPU kernels' halo rows
# not a multiple of the tile on either axis, several tiles on both
SHAPES = [(5, 5), (33, 65), (129, 65), (131, 67), (301, 261)]
SWEEPS = [0, 1, 2, K + 2, 2 * K + 1]      # K+2: two passes; 2K+1: three
# the tiles of the fp32/bf16 kernels and of the fp64 ones
WORDS = pytest.mark.parametrize("word", [4, 8],
                                ids=["fp32_tiles", "fp64_tiles"])


def _passes(sweeps):
    """Sweeps of each pass of an edge call: K a pass, the last the rest."""
    n = 1 if sweeps <= K else -(-sweeps // K)
    return [K] * (n - 1) + [sweeps - K * (n - 1)]


def _tiles(shape, rows, halo):
    """(by, bx, gi0, gj0) of each tile of a pass, in block index order."""
    own_r, own_c = rows - 2 * halo, TILE_COLS - 2 * halo
    for by in range(-(-shape[0] // own_r)):
        for bx in range(-(-shape[1] // own_c)):
            yield by, bx, by * own_r - halo, bx * own_c - halo


def _window(a, gi0, gj0, rows, cols):
    """a over global rows gi0.. and columns gj0.., 0 outside a."""
    out = torch.zeros(rows, cols, dtype=a.dtype)
    i0, j0 = max(gi0, 0), max(gj0, 0)
    i1, j1 = min(gi0 + rows, a.shape[0]), min(gj0 + cols, a.shape[1])
    if i1 > i0 and j1 > j0:
        out[i0 - gi0:i1 - gi0, j0 - gj0:j1 - gj0] = a[i0:i1, j0:j1]
    return out


def _interior(gi, gj, nr, nc):
    return (gi > 0) & (gi < nr - 1) & (gj > 0) & (gj < nc - 1)


def _lap(u, dx2i, dy2i):
    """5-point Laplacian at the tile's inner nodes, 0 on its edge row and
    column (which no kernel step reads)."""
    out = torch.zeros_like(u)
    c = u[1:-1, 1:-1]
    out[1:-1, 1:-1] = ((u[:-2, 1:-1] - 2 * c + u[2:, 1:-1]) * dx2i
                       + (u[1:-1, :-2] - 2 * c + u[1:-1, 2:]) * dy2i)
    return out


class _Tile:
    """One tile: its global indices, the halo-loaded u and f, the sweeps."""

    def __init__(self, u, f, gi0, gj0, rows, halo, dx2i, dy2i):
        self.nr, self.nc = u.shape
        self.halo, self.rows = halo, rows
        self.own_r, self.own_c = rows - 2 * halo, TILE_COLS - 2 * halo
        self.gi = torch.arange(gi0, gi0 + rows)[:, None]
        self.gj = torch.arange(gj0, gj0 + TILE_COLS)[None, :]
        self.inner = _interior(self.gi, self.gj, self.nr, self.nc)
        self.u = _window(u, gi0, gj0, rows, TILE_COLS)
        self.f = _window(f, gi0, gj0, rows, TILE_COLS)
        self.dx2i, self.dy2i = dx2i, dy2i

    def sweep(self, sweeps):
        li = torch.arange(self.rows)[:, None]
        lj = torch.arange(TILE_COLS)[None, :]
        edge = torch.minimum(torch.minimum(li, self.rows - 1 - li),
                             torch.minimum(lj, TILE_COLS - 1 - lj))
        colour = torch.remainder(self.gi + self.gj, 2)
        diag = -2.0 * self.dx2i - 2.0 * self.dy2i
        for h in range(2 * sweeps):
            m = self.inner & (colour == h % 2) & (edge >= h + 1)
            self.u = torch.where(
                m, self.u + (self.f - _lap(self.u, self.dx2i, self.dy2i))
                / diag, self.u)

    def residual(self):
        return torch.where(self.inner,
                           self.f - _lap(self.u, self.dx2i, self.dy2i), 0.0)

    def own(self, a):
        """a's owned nodes that lie inside the grid, and their slices."""
        h = self.halo
        i0, j0 = int(self.gi[h, 0]), int(self.gj[0, h])
        nr_, nc_ = (min(self.own_r, self.nr - i0),
                    min(self.own_c, self.nc - j0))
        return (a[h:h + nr_, h:h + nc_],
                (slice(i0, i0 + nr_), slice(j0, j0 + nc_)))


def _prolong_add(u, uc):
    """u + the bilinear prolongation of uc at interior nodes, node by node
    as the ascend kernel adds it before its sweeps."""
    nr, nc = u.shape
    gi = torch.arange(nr)[:, None]
    gj = torch.arange(nc)[None, :]
    ucp = torch.nn.functional.pad(uc, (0, 1, 0, 1))
    p00, p01 = ucp[gi // 2, gj // 2], ucp[gi // 2, gj // 2 + 1]
    p10, p11 = ucp[gi // 2 + 1, gj // 2], ucp[gi // 2 + 1, gj // 2 + 1]
    ei, ej = gi % 2 == 0, gj % 2 == 0
    corr = torch.where(ei & ej, p00, torch.where(
        ei, 0.5 * (p00 + p01), torch.where(
            ej, 0.5 * (p00 + p10), 0.25 * (p00 + p01 + p10 + p11))))
    return torch.where(_interior(gi, gj, nr, nc), u + corr, u)


def _sweep_pass(u, f, dx, dy, sweeps, rows, rms=False, halo=None):
    """One sweep_tile_kernel pass: (out, [per-tile sum r^2 in block
    order] or None)."""
    halo = 2 * sweeps + int(rms) if halo is None else halo
    out = torch.empty_like(u)
    partials = []
    for _, _, gi0, gj0 in _tiles(u.shape, rows, halo):
        t = _Tile(u, f, gi0, gj0, rows, halo, dx**-2, dy**-2)
        t.sweep(sweeps)
        vals, idx = t.own(t.u)
        out[idx] = vals
        if rms:
            r, _ = t.own(t.residual())
            partials.append(torch.sum(r * r))
    return out, (partials if rms else None)


def emulate_descend(u, f, dx, dy, sweeps, word, halo=None):
    """smooth_residual_restrict_fused as the tile kernels of compute word
    size `word` compute it: the sweep kernel's passes, then the descend
    kernel's."""
    *early, last = _passes(sweeps)
    for s in early:
        u, _ = _sweep_pass(u, f, dx, dy, s, SWEEP_ROWS[word])
    rows = RESTRICT_ROWS[word]
    halo = 2 * last + 2 if halo is None else halo
    nr, nc = u.shape
    ncr, ncc = (nr - 1) // 2 + 1, (nc - 1) // 2 + 1
    out = torch.empty_like(u)
    fc = torch.empty(ncr, ncc, dtype=u.dtype)
    w = [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]
    for by, bx, gi0, gj0 in _tiles(u.shape, rows, halo):
        t = _Tile(u, f, gi0, gj0, rows, halo, dx**-2, dy**-2)
        t.sweep(last)
        vals, idx = t.own(t.u)
        out[idx] = vals
        r = t.residual()
        tcr, tcc = t.own_r // 2, t.own_c // 2
        ic0, jc0 = by * tcr, bx * tcc
        acc = torch.zeros(tcr, tcc, dtype=u.dtype)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                i0, j0 = halo + di, halo + dj
                acc = acc + w[di + 1][dj + 1] * r[i0:i0 + 2 * tcr:2,
                                                  j0:j0 + 2 * tcc:2]
        ic = torch.arange(ic0, ic0 + tcr)[:, None]
        jc = torch.arange(jc0, jc0 + tcc)[None, :]
        acc = torch.where(_interior(ic, jc, ncr, ncc), acc / 16.0, 0.0)
        n_i, n_j = min(tcr, ncr - ic0), min(tcc, ncc - jc0)
        fc[ic0:ic0 + n_i, jc0:jc0 + n_j] = acc[:n_i, :n_j]
    return out, fc


def emulate_ascend(u, f, uc, dx, dy, sweeps, word, want_rms=False):
    """prolong_correct_smooth_fused as the sweep kernel of compute word
    size `word` computes it; the residual sum adds the last pass's tile
    partials in block order."""
    u = _prolong_add(u, uc)
    passes = _passes(sweeps)
    partials = None
    for k, s in enumerate(passes):
        u, partials = _sweep_pass(u, f, dx, dy, s, SWEEP_ROWS[word],
                                  rms=want_rms and k == len(passes) - 1)
    if not want_rms:
        return u
    ssq = torch.zeros((), dtype=u.dtype)
    for p in partials:
        ssq = ssq + p
    return u, ssq


def level_bytes(shape, word):
    """Shared memory of a whole level: u and f as two colour planes each,
    ceil(nc/2) words a row."""
    nr, nc = shape
    return 4 * nr * ((nc + 1) // 2) * word


def one_block(shape):
    """True when the smoother takes the level whole into one block."""
    return shape[0] * shape[1] <= LEVEL_NODES


def quot(q, d):
    """q // d as the level kernel takes it: the high word of q times
    quot_magic(d) = ceil(2^32 / d)."""
    return (q * ((2**32 - 1) // d + 1)) >> 32


def emulate_level(u, f, dx, dy, sweeps):
    """rb_level_kernel: node q = i*nc + j at plane (i + j) % 2, word
    i*W + j//2; half-sweep h relaxes colour h % 2 by pair slot over the
    interior rows, reading the other plane at k -+ W, k - 1 + par and
    k + par."""
    nr, nc = u.shape
    w = (nc + 1) // 2
    planes = 2 * nr * w
    node = torch.arange(nr * nc)
    i = quot(node, nc)
    j = node - i * nc
    word = (i + j) % 2 * (nr * w) + i * w + j // 2
    su = torch.full((planes,), float("nan"), dtype=u.dtype)
    sf = torch.full((planes,), float("nan"), dtype=u.dtype)
    su[word] = u.reshape(-1)
    sf[word] = f.reshape(-1)
    dx2i, dy2i = dx**-2, dy**-2
    diag = -2.0 * dx2i - 2.0 * dy2i
    q = torch.arange((nr - 2) * w)
    qi = 1 + quot(q, w)
    p = q - (qi - 1) * w
    for h in range(2 * sweeps):
        c = h % 2
        par = (c + qi) % 2
        col = 2 * p + par
        ok = (col >= 1) & (col <= nc - 2)
        k, par = (qi * w + p)[ok], par[ok]
        mine, other = c * nr * w + k, (1 - c) * nr * w + k
        uc = su[mine]
        lap = ((su[other - w] - 2 * uc + su[other + w]) * dx2i
               + (su[other - 1 + par] - 2 * uc + su[other + par]) * dy2i)
        su[mine] = uc + (sf[mine] - lap) / diag
    return su[word].reshape(nr, nc)


def emulate_rb_sweeps(u, f, dx, dy, sweeps, word):
    """redblack_sweeps_fused as the smoother of compute word size `word`
    computes it: the whole level in one block, or tile passes."""
    if one_block(u.shape):
        return emulate_level(u, f, dx, dy, sweeps)
    for s in _passes(sweeps):
        u, _ = _sweep_pass(u, f, dx, dy, s, RB_ROWS[word])
    return u


# ----------------------------------------------------------------- tests

def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    coarse = ((shape[0] - 1) // 2 + 1, (shape[1] - 1) // 2 + 1)
    return (rng.standard_normal(shape), rng.standard_normal(shape),
            rng.standard_normal(coarse))


def _spacing(shape):
    return 1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1)


def _assert_rel(got, ref, rel=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_tile_constants_read_from_the_source():
    """K and the tile sizes the emulation uses: K sweeps fit the TPU's
    GUARD (2K+2 <= 8), and every admitted halo leaves owned nodes."""
    assert 2 * K + 2 <= GUARD
    assert TILE_COLS % 64 == 0
    for rows in [*RESTRICT_ROWS.values(), *SWEEP_ROWS.values(),
                 *RB_ROWS.values()]:
        assert rows % 8 == 0 and rows - 2 * (2 * K + 2) >= 8


@pytest.mark.parametrize("sweeps,want", [(0, [0]), (1, [1]), (K, [K]),
                                         (K + 1, [K, 1]), (2 * K, [K, K]),
                                         (2 * K + 1, [K, K, 1])])
def test_passes_split_the_sweeps(sweeps, want):
    assert _passes(sweeps) == want


@WORDS
@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_descend_tiles_match_twin(shape, sweeps, word):
    u, f, _ = (torch.as_tensor(a) for a in _fields(shape, seed=21))
    dx, dy = _spacing(shape)
    got_u, got_fc = emulate_descend(u, f, dx, dy, sweeps, word)
    ref_u, ref_fc = cuda_kernels.smooth_residual_restrict_fused_plain(
        u, f, dx, dy, sweeps)
    _assert_rel(got_u, ref_u)
    _assert_rel(got_fc, ref_fc)


@WORDS
@pytest.mark.parametrize("want_rms", [False, True], ids=["u", "u_ssq"])
@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ascend_tiles_match_twin(shape, sweeps, want_rms, word):
    u, f, uc = (torch.as_tensor(a) for a in _fields(shape, seed=22))
    dx, dy = _spacing(shape)
    got = emulate_ascend(u, f, uc, dx, dy, sweeps, word, want_rms)
    ref = cuda_kernels.prolong_correct_smooth_fused_plain(
        u, f, uc, dx, dy, sweeps, want_rms)
    if not want_rms:
        _assert_rel(got, ref)
        return
    _assert_rel(got[0], ref[0])
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-12)


@functools.lru_cache(maxsize=None)
def _pallas(kind, shape, sweeps):
    u, f, uc = (jnp.asarray(a) for a in _fields(shape, seed=23))
    dx, dy = _spacing(shape)
    if kind == "descend":
        out = pallas_kernels.smooth_residual_restrict_fused(
            u, f, dx, dy, sweeps, tile=16, interpret=True)
    else:
        out = pallas_kernels.prolong_correct_smooth_fused(
            u, f, uc, dx, dy, sweeps, tile=16, interpret=True,
            want_rms=True)
    return tuple(np.asarray(a) for a in out)


# the TPU kernels admit 2s+2 <= GUARD (descend) and 2s+1 <= GUARD (ascend
# with the residual sum): every SWEEPS entry up to 2 here
PALLAS_SWEEPS = [s for s in SWEEPS if 2 * s + 2 <= GUARD]


@WORDS
@pytest.mark.parametrize("sweeps", PALLAS_SWEEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_descend_tiles_match_pallas(shape, sweeps, word):
    u, f, _ = (torch.as_tensor(a) for a in _fields(shape, seed=23))
    dx, dy = _spacing(shape)
    got_u, got_fc = emulate_descend(u, f, dx, dy, sweeps, word)
    ref_u, ref_fc = _pallas("descend", shape, sweeps)
    _assert_rel(got_u, ref_u)
    _assert_rel(got_fc, ref_fc)


@WORDS
@pytest.mark.parametrize("sweeps", PALLAS_SWEEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ascend_tiles_match_pallas(shape, sweeps, word):
    u, f, uc = (torch.as_tensor(a) for a in _fields(shape, seed=23))
    dx, dy = _spacing(shape)
    ref_u, ref_ssq = _pallas("ascend", shape, sweeps)
    _assert_rel(emulate_ascend(u, f, uc, dx, dy, sweeps, word), ref_u)
    got_u, got_ssq = emulate_ascend(u, f, uc, dx, dy, sweeps, word, True)
    _assert_rel(got_u, ref_u)
    np.testing.assert_allclose(float(got_ssq), float(ref_ssq), rtol=1e-10)


@pytest.mark.parametrize("kind", ["descend", "ascend_ssq"])
def test_a_halo_one_short_is_caught(kind):
    """The halos are tight: one node less and the tiles disagree with the
    twin at their seams, so the comparisons above can see a wrong halo."""
    shape, sweeps = (301, 261), 2
    u, f, uc = (torch.as_tensor(a) for a in _fields(shape, seed=24))
    dx, dy = _spacing(shape)
    if kind == "descend":
        got = emulate_descend(u, f, dx, dy, sweeps, 4,
                              halo=2 * sweeps + 1)[1]
        ref = cuda_kernels.smooth_residual_restrict_fused_plain(
            u, f, dx, dy, sweeps)[1]
    else:
        got = sum(_sweep_pass(_prolong_add(u, uc), f, dx, dy, sweeps,
                              SWEEP_ROWS[4], rms=True, halo=2 * sweeps)[1])
        ref = cuda_kernels.prolong_correct_smooth_fused_plain(
            u, f, uc, dx, dy, sweeps, True)[1]
    err = float((torch.as_tensor(got) - ref).abs().max())
    assert err > 1e-6 * float(torch.as_tensor(ref).abs().max())


# the smoother: even-sided and ragged shapes, and shapes on both sides of
# the one-block limit (65x65 and 33x128 on it, 65x66 and 33x129 past it)
RB_SHAPES = [(3, 3), (4, 6), (5, 5), (33, 64), (65, 65), (33, 128),
             (65, 66), (33, 129), (131, 67), (129, 129), (301, 261)]


def test_level_quotients_are_exact():
    """The level kernel's multiply-high quotient is q // d wherever
    q * d < 2^32 (checked outright for d < 1500, q < 2^13), and every
    level of the one-block path keeps its indices (q < nr * nc) and
    divisors (nc, W) inside that."""
    q = np.arange(2**13, dtype=np.uint64)
    for d in range(2, 1500):
        np.testing.assert_array_equal(quot(q, d), q // d)
    assert LEVEL_NODES < 2**13 and LEVEL_NODES // 3 < 1500


def test_smoother_one_block_levels_fit_shared_memory():
    """Every level of the one-block path fits a block's shared memory in
    either word size; RB_SHAPES lie on both sides of the node limit."""
    for nc in range(3, LEVEL_NODES // 3 + 1):
        shape = (LEVEL_NODES // nc, nc)
        assert one_block(shape) and level_bytes(shape, 8) <= BLOCK_SMEM_BYTES
    inside = [s for s in RB_SHAPES if one_block(s)]
    assert (65, 65) in inside and (33, 128) in inside
    assert (65, 66) not in inside and (33, 129) not in inside


@WORDS
@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("shape", RB_SHAPES)
def test_smoother_matches_twin(shape, sweeps, word):
    u, f, _ = (torch.as_tensor(a) for a in _fields(shape, seed=25))
    dx, dy = _spacing(shape)
    got = emulate_rb_sweeps(u, f, dx, dy, sweeps, word)
    assert bool(torch.isfinite(got).all()), "a word no node owns was read"
    _assert_rel(got, cuda_kernels.redblack_sweeps_fused_plain(u, f, dx, dy,
                                                              sweeps))


@functools.lru_cache(maxsize=None)
def _pallas_rb(shape, sweeps):
    u, f, _ = (jnp.asarray(a) for a in _fields(shape, seed=26))
    dx, dy = _spacing(shape)
    return np.asarray(pallas_kernels.redblack_sweeps_fused(
        u, f, dx, dy, sweeps, tile=16, interpret=True))


# the TPU kernel runs GUARD // 2 sweeps a call and any count in several
# calls; interpret mode is slow, so a few shapes, on both paths (131x67
# and 65x66 take tiles), at every count
@WORDS
@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("shape", [(4, 6), (33, 64), (131, 67), (65, 66)])
def test_smoother_matches_pallas(shape, sweeps, word):
    u, f, _ = (torch.as_tensor(a) for a in _fields(shape, seed=26))
    dx, dy = _spacing(shape)
    _assert_rel(emulate_rb_sweeps(u, f, dx, dy, sweeps, word),
                _pallas_rb(shape, sweeps))


def test_smoother_tiles_with_a_halo_one_short_are_caught():
    """The smoother's tile halo (2s) is tight as well."""
    shape, sweeps = (301, 261), 2
    u, f, _ = (torch.as_tensor(a) for a in _fields(shape, seed=27))
    dx, dy = _spacing(shape)
    got, _ = _sweep_pass(u, f, dx, dy, sweeps, RB_ROWS[4],
                         halo=2 * sweeps - 1)
    ref = cuda_kernels.redblack_sweeps_fused_plain(u, f, dx, dy, sweeps)
    assert float((got - ref).abs().max()) > 1e-6 * float(ref.abs().max())
