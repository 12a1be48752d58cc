"""The cavity's bf16 precision tiers in cfd_julia_torch vs cfd_julia_tpu.

A tier (matmul_bf16x3 / _bf16x1, fused_bf16x3 / _bf16x1) runs the sine
matrix products of the Poisson solve as the TPU's matrix unit does: split
bf16 operands (3 passes, XLA's bf16_3x, or 1), fp32 accumulation
(ops/cuda_kernels.tier_matmul; on the CPU its plain twin).  JAX's CPU
backend ignores the precision and runs fp32, so the JAX package's tier
steps here are its fp32 steps, and the port's tiers are held to them within
each tier's error:

* the twin against a numpy emulation written as the JAX package's own
  (tests/test_poisson2d.py:375-388): 1e-6 of max|C| (the same split; only
  the order of fp64 sums differs before the fp32 rounding);
* csrc/tier_gemm.cu emulated in numpy: the split pass bitwise equal to
  _bf16_split (zero pad, B transposed, strided operands), and the GEMM's
  schedule (k-block promotion, the wgmma accumulators' layout, the
  epilogue's masks) against the twin: 1e-6 of max|C| (exact products of
  the same bf16 parts, summed in fp32 as the kernel orders them); a plan
  on the CPU is the twin bitwise; the tiles fit the card and the 128-byte
  swizzle maps a ring stage one to one;
* the 512^2 DST solve of tier bf16x3 within rel 5e-5 (the JAX package's
  bound, tests/test_poisson2d.py:363-428), bf16x1 more than 20x further
  off: that test's recipe (fp64 denominators) against the exact solve, and
  the port's fp32 solve against the JAX package's fp32 one (both fp32
  solves sit 3.1e-4 from the fp64 solve: their fp32 denominators; see
  dst_errors);
* 5 cavity steps of each tier from a seeded random state against JAX's
  fp32 step of the same formulation: bf16x3 within 5e-5 of each field's
  scale (measured up to 1.35e-5, in psi; the port's fp32 steps agree with
  JAX's within 9e-7), bf16x1 within 1e-2 (measured up to 6.8e-3);
* the port's fused tier against its matmul tier from a mid-run state (the
  formulations differ on a random one, whose walls do not follow from its
  psi): within 1e-6 of the scale, as the fp32 fused and matmul steps are;
  measured bitwise equal on the CPU, where each pass is exact in fp64.
"""
import dataclasses
import functools
import json
import math
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop
from cfd_julia_torch.models import cavity, cavity_fused
from cfd_julia_torch.ops import _cuda_build, cuda_kernels
from cfd_julia_torch.poisson import direct
from cfd_julia_torch.stepping import loop
from cfd_julia_tpu.models import cavity as jax_cavity
from cfd_julia_tpu.models import cavity_fused as jax_fused
from cfd_julia_tpu.poisson import direct as jax_direct

torch.set_num_threads(1)

F32 = torch.float32
TIERS = ["matmul_bf16x3", "matmul_bf16x1", "fused_bf16x3", "fused_bf16x1"]
# (M, N, K) of the path (1024^3 fused, 1023^3 matmul) and tiny / ragged ones
SHAPES = [(1024, 1024, 1024), (1023, 1023, 1023), (1, 1, 1), (15, 17, 13),
          (33, 47, 129), (130, 131, 129)]
# bounds of the cavity trajectories, of each field's scale (docstring)
TRAJ_TOL = {"bf16x3": 5e-5, "bf16x1": 1e-2}
FUSED_VS_MATMUL_TOL = 1e-6


def _operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _split(a):
    hi = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    lo = (a - hi).astype(ml_dtypes.bfloat16).astype(np.float32)
    return hi, lo


def _mm_emulated(a, b, passes):
    """tests/test_poisson2d.py's mm3x / mm1x."""
    ah, al = _split(np.asarray(a, np.float32))
    bh, bl = _split(np.asarray(b, np.float32))

    def mm(x, y):
        return (x.astype(np.float64) @ y.astype(np.float64)).astype(
            np.float32)

    if passes == 1:
        return mm(ah, bh)
    return mm(ah, bh) + mm(ah, bl) + mm(al, bh)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_numpy_emulation(shape, passes):
    a, b = _operands(*shape, seed=sum(shape))
    got = cuda_kernels.tier_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                   passes)
    assert got.dtype == F32 and tuple(got.shape) == shape[:2]
    assert _rel(got.numpy(), _mm_emulated(a, b, passes)) <= 1e-6


@pytest.mark.parametrize("passes", [1, 3])
def test_twin_matches_emulation_on_sine_matrices(passes):
    """The path's own operands: the interior sine matrix times a field and
    times itself (S^2 = (n/2) I)."""
    n = 96
    k = torch.arange(1, n, dtype=torch.int32)
    s = direct._sine_entries(k[:, None], k[None, :], n, F32)
    g = torch.from_numpy(_operands(n - 1, n - 1, n - 1, seed=3)[0])
    for a, b in ((s, g), (g, s), (s, s)):
        got = cuda_kernels.tier_matmul(a, b, passes)
        assert _rel(got.numpy(), _mm_emulated(a.numpy(), b.numpy(),
                                              passes)) <= 1e-6
    sq = cuda_kernels.tier_matmul(s, s, 3).double()
    assert (sq - n / 2 * torch.eye(n - 1, dtype=torch.float64)).abs().max() \
        <= 1e-4 * n / 2


def test_tiers_differ_from_fp32_as_bf16_does():
    """bf16x3 is fp32-grade (~1e-5 of max|C|), bf16x1 carries bf16's
    rounding (~1e-3): a tier never runs as plain fp32 in silence."""
    a, b = (torch.from_numpy(x) for x in _operands(64, 64, 256, seed=5))
    ref = (a.double() @ b.double()).numpy()
    e3 = _rel(cuda_kernels.tier_matmul(a, b, 3).numpy(), ref)
    e1 = _rel(cuda_kernels.tier_matmul(a, b, 1).numpy(), ref)
    assert 1e-8 < e3 < 1e-5 < 1e-4 < e1 < 1e-2, (e3, e1)


@pytest.mark.parametrize("args,err", [
    ((torch.zeros(2, 3, dtype=torch.float64), torch.zeros(3, 2), 3),
     TypeError),
    ((torch.zeros(2, 3), torch.zeros(4, 2), 3), ValueError),
    ((torch.zeros(2, 3), torch.zeros(3, 2), 2), ValueError),
    ((torch.zeros(0, 3), torch.zeros(3, 2), 1), ValueError),
])
def test_tier_matmul_refuses_bad_arguments(args, err):
    with pytest.raises(err):
        cuda_kernels.tier_matmul(*args)


# ------------------------------------------- the kernels' schedule, emulated

def _kernel_constants():
    """csrc/tier_gemm.cu's tile and launch constants."""
    src = (_cuda_build.CSRC / "tier_gemm.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kBM", "kBN", "kBK", "kStages", "kConsumers",
                         "kChunk", "kSplitTile", "kSplitThreads")}


def _bf16_bits(x):
    """bf16 (round to nearest even) of fp32 values, as uint16 bits."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).view(
        np.uint16)


def _split_chunk(v):
    """The kernel's split8 on (..., 8) fp32 values: hi and lo bits."""
    hi = _bf16_bits(v)
    back = hi.view(ml_dtypes.bfloat16).astype(np.float32)
    return hi, _bf16_bits(v - back)


def _emulate_split(flat, offset, ld, rows, cols, transpose, out_rows, kp,
                   passes):
    """tier_split's kernels in numpy, on an operand read in place: element
    (r, c) at flat[offset + r * ld + c].  A role (split_rows_kernel): a
    thread per 16-byte chunk of an output row; B role (split_cols_kernel):
    a block per 64 x 64 tile, loaded [k][n] with zeros past the operand,
    written transposed in chunks of 8 k.  Returns (planes, out_rows, kp)
    bits."""
    c = _kernel_constants()
    chunk, tile = c["kChunk"], c["kSplitTile"]
    out = np.full((2 if passes == 3 else 1, out_rows, kp), 0xFFFF,
                  np.uint16)   # every element must be written

    def read(r, col):
        inside = (r < rows) & (col < cols)
        idx = offset + np.where(inside, r, 0) * ld + np.where(inside, col, 0)
        return np.where(inside, flat[idx], np.float32(0))

    if not transpose:
        q = np.arange(out_rows * (kp // chunk))
        r = q // (kp // chunk)
        c0 = (q % (kp // chunk)) * chunk
        v = read(r[:, None], c0[:, None] + np.arange(chunk))
        hi, lo = _split_chunk(v)
        for p, bits in enumerate((hi, lo)[:out.shape[0]]):
            out[p, r[:, None], c0[:, None] + np.arange(chunk)] = bits
        return out
    assert out_rows % tile == 0 and kp % tile == 0
    for n0 in range(0, out_rows, tile):
        for k0 in range(0, kp, tile):
            i = np.arange(tile * tile)
            smem = read(k0 + i // tile, n0 + i % tile).reshape(tile, tile)
            i = np.arange(tile * (tile // chunk))
            nn, kc = i // (tile // chunk), (i % (tile // chunk)) * chunk
            v = smem[kc[:, None] + np.arange(chunk), nn[:, None]]
            hi, lo = _split_chunk(v)
            cols_out = k0 + kc[:, None] + np.arange(chunk)
            for p, bits in enumerate((hi, lo)[:out.shape[0]]):
                out[p, n0 + nn[:, None], cols_out] = bits
    return out


# (M, N, K): the path's 1024^3 (fused) and 1023^3 (matmul) and tiny /
# ragged ones
SPLIT_SHAPES = [(1, 1, 1), (15, 17, 13), (33, 47, 129), (130, 131, 129),
                (1023, 1023, 1023), (1024, 1024, 1024)]


@pytest.mark.parametrize("role", ["A", "B"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_pass_emulation_is_bf16_split(shape, role):
    """The split pass, emulated, bitwise equal to _bf16_split on the
    operand and 0 in the pad, every element written; the B operand
    transposed; the operand read in place through its row stride (the
    interior of a larger field, as the matmul tiers' solve reads it);
    equal to the twin tier_split_plain bitwise, for 1 and 3 passes."""
    m, n, k = shape
    rows, cols = (m, k) if role == "A" else (k, n)
    full = np.random.default_rng(m + 3 * k).standard_normal(
        (rows + 2, cols + 3)).astype(np.float32)
    x = full[1:-1, 2:-1]
    transpose = role == "B"
    out_rows = -(-(n if transpose else m) //
                 (cuda_kernels.TIER_BN if transpose else cuda_kernels.TIER_BM))
    out_rows *= cuda_kernels.TIER_BN if transpose else cuda_kernels.TIER_BM
    kp = -(-k // cuda_kernels.TIER_BK) * cuda_kernels.TIER_BK
    got = _emulate_split(full.reshape(-1), full.shape[1] + 2, full.shape[1],
                         rows, cols, transpose, out_rows, kp, 3)
    hi, lo = cuda_kernels._bf16_split(torch.from_numpy(x.T if transpose
                                                       else x))
    valid = (slice(None, cols if transpose else rows),
             slice(None, rows if transpose else cols))
    for p, ref in enumerate((hi, lo)):
        assert (got[p][valid] == _bf16_bits(ref.numpy())).all()
        pad = np.ones(got[p].shape, bool)
        pad[valid] = False
        assert (got[p][pad] == 0).all()
    for passes in (1, 3):
        plain = cuda_kernels.tier_split_plain(torch.from_numpy(x), transpose,
                                              out_rows, kp, passes)
        assert plain.dtype == torch.bfloat16
        assert (plain.view(torch.int16).numpy().view(np.uint16)
                == got[:plain.shape[0]]).all()


def _emulate_gemm(a, b, passes):
    """tier_gemm_tn in numpy: the operands' planes from the split pass, a
    block per (kBM, kBN) tile of C, two warpgroups of 64 rows; each 64-k
    block's passes (lo hi, hi lo, hi hi) in k16 slices into a fresh fp32
    set (each slice's product exact, then rounded into the set), promoted
    into the fp32 sums once the k-block is done; the accumulators spread
    over the warpgroup's threads as wgmma m64n64 lays them out and stored
    with the epilogue's masks.  Returns C and how often each entry was
    stored."""
    c = _kernel_constants()
    BM, BN, BK = c["kBM"], c["kBN"], c["kBK"]
    (M, K), N = a.shape, b.shape[1]
    mp, np_, kp = (-(-M // BM) * BM, -(-N // BN) * BN, -(-K // BK) * BK)

    def planes(x, transpose, out_rows):
        bits = _emulate_split(x.reshape(-1), 0, x.shape[1], *x.shape,
                              transpose, out_rows, kp, passes)
        return [p.view(ml_dtypes.bfloat16).astype(np.float64) for p in bits]

    pa, pb = planes(a, False, mp), planes(b, True, np_)
    order = [(1, 0), (0, 1), (0, 0)] if passes == 3 else [(0, 0)]
    C = np.zeros((M, N), np.float32)
    stores = np.zeros((M, N), int)
    t = np.arange(c["kConsumers"])
    wg, w, lane = t >> 7, (t >> 5) & 3, t & 31
    for m0 in range(0, mp, BM):
        for n0 in range(0, np_, BN):
            acc = np.zeros((BM, BN), np.float32)
            for k0 in range(0, kp, BK):
                part = np.zeros((BM, BN), np.float32)
                for ia, ib in order:
                    for j in range(k0, k0 + BK, 16):
                        prod = pa[ia][m0:m0 + BM, j:j + 16] @ \
                            pb[ib][n0:n0 + BN, j:j + 16].T
                        part = (part + prod).astype(np.float32)
                acc = acc + part
            for i in range(BN // 8):
                for h in range(2):
                    for e in range(2):
                        r = wg * 64 + w * 16 + (lane >> 2) + 8 * h
                        col = 8 * i + 2 * (lane & 3) + e
                        row, cc = m0 + r, n0 + col
                        ok = (row < M) & (cc < N)
                        C[row[ok], cc[ok]] = acc[r[ok], col[ok]]
                        np.add.at(stores, (row[ok], cc[ok]), 1)
    return C, stores


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("shape", [(1, 1, 1), (15, 17, 13), (33, 47, 129),
                                   (130, 131, 129), (136, 68, 36)])
def test_gemm_schedule_emulation_matches_twin(shape, passes):
    """The k-block promotion order and the epilogue's fragment map: every
    entry of C stored once, and C within 1e-6 of max|C| of the twin: one
    block and many, k-blocks cut by the zero pad, 136 x 68 x 36 with a
    second row and column of blocks."""
    a, b = _operands(*shape, seed=11 * passes + shape[2])
    got, stores = _emulate_gemm(a, b, passes)
    assert (stores == 1).all()
    ref = cuda_kernels.tier_matmul_plain(torch.from_numpy(a),
                                         torch.from_numpy(b), passes)
    assert _rel(got, ref.numpy()) <= 1e-6


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("side", ["left", "right"])
def test_plan_on_cpu_is_the_twin(side, passes):
    """A TierPlan on the CPU is tier_matmul_plain of its constant and the
    field bitwise, the field read as given (a strided interior)."""
    rng = np.random.default_rng(passes)
    const = torch.from_numpy(rng.standard_normal((37, 37)).astype(np.float32))
    full = torch.from_numpy(rng.standard_normal((39, 41)).astype(np.float32))
    field = full[1:-1, 2:-2]
    plan = cuda_kernels.TierPlan(const, passes, side, tuple(field.shape))
    ref = (cuda_kernels.tier_matmul_plain(const, field, passes)
           if side == "left" else
           cuda_kernels.tier_matmul_plain(field, const, passes))
    assert torch.equal(plan(field), ref)
    with pytest.raises(ValueError):
        plan(full)


def test_kernel_tiles_fit_the_card():
    """The tile constants the emulations read: two warpgroups of 64 rows
    and a 64-column wgmma tile a block, 128-byte k rows (the swizzle's
    width), a ring that fits the 232,448 B a block may use for 3 passes,
    and one wave of at most 132 blocks at 1024^2."""
    c = _kernel_constants()
    assert c["kConsumers"] == 2 * 128 and c["kBM"] == 2 * 64
    assert c["kBN"] == 64 and c["kBK"] * 2 == 128 and 3 <= c["kStages"] <= 4
    stage = 2 * (c["kBM"] + c["kBN"]) * c["kBK"] * 2
    assert 1024 + c["kStages"] * (stage + 16) <= 232448
    assert (1024 // c["kBM"]) * (1024 // c["kBN"]) <= 132
    assert c["kSplitTile"] % c["kChunk"] == 0
    assert (cuda_kernels.TIER_BM, cuda_kernels.TIER_BN,
            cuda_kernels.TIER_BK) == (c["kBM"], c["kBN"], c["kBK"])


def _tma_sw128(row, k):
    """Byte offset where TMA's 128-byte swizzle puts bf16 element (row, k)
    of a tile of 128-byte rows (1024-byte aligned): the 16-byte chunk
    k // 8 goes to chunk (k // 8) ^ (row % 8)."""
    return row * 128 + (((k // 8) ^ (row % 8)) << 4) + (k % 8) * 2


@pytest.mark.parametrize("passes", [1, 3])
def test_swizzle_is_a_bijection_and_matches_the_descriptors(passes):
    """On a ring stage (A's and B's planes), the swizzled byte offsets of
    every element are distinct and fill the stage; wgmma's view through a
    descriptor (start + 32 j for the k16 slice j, rows 128 B apart in
    8-row groups of 1024 B, the swizzle XOR applied to the address) finds
    each element where TMA put it."""
    c = _kernel_constants()
    planes = 2 if passes == 3 else 1
    row, k = np.meshgrid(np.arange(c["kBM"]), np.arange(c["kBK"]),
                         indexing="ij")
    a_tile = _tma_sw128(row, k)
    b_tile = _tma_sw128(row[:c["kBN"]], k[:c["kBN"]])
    a_bytes, b_bytes = c["kBM"] * c["kBK"] * 2, c["kBN"] * c["kBK"] * 2
    offsets = [a_tile + p * a_bytes for p in range(planes)] + \
        [b_tile + planes * a_bytes + p * b_bytes for p in range(planes)]
    flat = np.concatenate([o.ravel() for o in offsets])
    assert len(np.unique(flat)) == flat.size
    assert flat.min() == 0 and flat.max() == planes * (a_bytes + b_bytes) - 2
    assert (flat % 2 == 0).all()
    for j in range(c["kBK"] // 16):
        for kk in range(16):
            linear = row[:, 0] * 128 + 32 * j + 2 * kk
            swizzled = linear ^ (((linear >> 7) & 7) << 4)
            assert (swizzled == _tma_sw128(row[:, 0], 16 * j + kk)).all()


# ------------------------------------------- the GEMM's planes epilogue

def _epilogue_constants():
    """csrc/tier_gemm.cu's planes tile pitches and its Epilogue / Op
    enums."""
    src = (_cuda_build.CSRC / "tier_gemm.cu").read_text()
    c = _kernel_constants()
    out = {name: c[base] + int(re.search(
        rf"constexpr int {name} = {base} \+ (\d+);", src).group(1))
        for name, base in (("kTilePitch", "kBN"), ("kTilePitchT", "kBM"))}
    for enum in ("Epilogue", "Op"):
        body = re.search(rf"enum {enum} : int {{([^}}]*)}}", src).group(1)
        out[enum] = {k: int(v) for k, v in
                     re.findall(r"(\w+) = (\d+)", body)}
    return out


def _np_op(c, op):
    """The epilogue's op on fp32 values in numpy (IEEE / and *)."""
    kind, value = op
    if kind == "divide":
        return (c / value).astype(np.float32)
    if kind == "scale":
        return (c * np.float32(value)).astype(np.float32)
    return c


def _emulate_epilogue(c, role, passes, op=("none", None)):
    """tier_gemm_tn_planes's epilogue in numpy, fed the accumulators' values
    c (M, N) (NaN past C: the zero-padded planes' products, which the
    epilogue must not store): a block per (kBM, kBN) tile, the wgmma
    fragments of its two warpgroups with op applied, stored straight from
    the fragments for role C, else written (0 past C) into the tile in the
    ring (transposed for role B), from which each consumer thread reads
    back its turns' chunks, 8 values of a plane row split as split8 splits
    them.  Returns the destination (bf16 planes as uint16 bits, from
    0xFFFF; fp32 C from NaN) and how often each element was stored;
    asserts that the read phase reads only tile slots written once."""
    k, e = _kernel_constants(), _epilogue_constants()
    BM, BN, chunk, threads = k["kBM"], k["kBN"], k["kChunk"], k["kConsumers"]
    M, N = c.shape
    gm, gn = -(-M // BM) * BM, -(-N // BN) * BN
    planes = 2 if passes == 3 else 1
    if role == "C":
        dest = np.full((M, N), np.nan, np.float32)
    else:
        rows, kp = cuda_kernels.tier_plane_extents(role, M, N)
        dest = np.full((planes, rows, kp), 0xFFFF, np.uint16)
    stores = np.zeros(dest.shape, int)
    t = np.arange(threads)
    wg, warp, lane = t >> 7, (t >> 5) & 3, t & 31
    opv = _np_op(c, op)
    transposed = role == "B"
    pitch = e["kTilePitchT"] if transposed else e["kTilePitch"]
    for m0 in range(0, gm, BM):
        for n0 in range(0, gn, BN):
            tile = np.full((BN if transposed else BM) * pitch, np.nan,
                           np.float32)
            written = np.zeros(tile.shape, int)
            for h in range(2):
                for i in range(BN // 8):
                    for j in range(2):
                        r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h
                        cc = 8 * i + 2 * (lane & 3) + j
                        row, col = m0 + r, n0 + cc
                        inside = (row < M) & (col < N)
                        v = np.where(inside, opv[np.minimum(row, M - 1),
                                                 np.minimum(col, N - 1)],
                                     np.float32(0))
                        if role == "C":
                            dest[row[inside], col[inside]] = v[inside]
                            np.add.at(stores, (row[inside], col[inside]), 1)
                            continue
                        slot = cc * pitch + r if transposed else \
                            r * pitch + cc
                        tile[slot] = v
                        np.add.at(written, slot, 1)
            if role == "C":
                continue
            assert written.max() == 1
            n_rows = BN if transposed else BM
            chunks = (BM if transposed else BN) // chunk
            row_base, k_base = (n0, m0) if transposed else (m0, n0)
            for turn in range(n_rows * chunks // threads):
                q = t + turn * threads
                r, kk = q // chunks, (q % chunks) * chunk
                row, col = row_base + r, k_base + kk
                ok = (row < dest.shape[1]) & (col < dest.shape[2])
                slot = (r[ok] * pitch + kk[ok])[:, None] + np.arange(chunk)
                assert (written[slot] == 1).all()
                hi, lo = _split_chunk(tile[slot])
                cols = col[ok][:, None] + np.arange(chunk)
                for pl, bits in enumerate((hi, lo)[:planes]):
                    dest[pl, row[ok][:, None], cols] = bits
                    np.add.at(stores, (pl, row[ok][:, None], cols), 1)
    return dest, stores


EPILOGUE_ROLES = ["A", "B", "C"]
EPILOGUE_OPS = ["none", "divide", "scale"]


def _epilogue_case(shape, op, seed):
    """C of a random product (with 0, -0 and subnormal entries, as GEMM
    outputs may hold) and the op's table or scale."""
    m, n, k = shape
    a, b = _operands(m, n, k, seed)
    rng = np.random.default_rng(seed + 1)
    c = np.array(_mm_emulated(a, b, 3))
    flat = c.reshape(-1)
    specials = np.array([0.0, -0.0, 1e-40, -3e-39, 1e-45], np.float32)
    flat[rng.choice(flat.size, min(flat.size, specials.size),
                    replace=False)] = specials[:min(flat.size,
                                                    specials.size)]
    table = (rng.uniform(0.5, 2.0, (m, n)) * rng.choice([-1, 1], (m, n))
             ).astype(np.float32)
    value = {"none": None, "divide": table, "scale": 4.0 / (m * n + 17)}[op]
    return c, value


def _torch_op(c, op, value):
    """op as the solve writes it in torch: / table, * scale."""
    if op == "divide":
        return c / torch.from_numpy(value)
    if op == "scale":
        return c * value
    return c


@pytest.mark.parametrize("op", EPILOGUE_OPS)
@pytest.mark.parametrize("role", EPILOGUE_ROLES)
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_planes_epilogue_emulation_is_split_of_op(shape, role, op):
    """The planes epilogue's index map, emulated from the wgmma fragments
    through the tile in the ring to each destination slot: every element of the
    destination's padded extents stored exactly once (from 0xFFFF / NaN),
    the pad 0, and the result bitwise tier_split_plain(op(C)) (A: the next
    product's A operand, B: its B operand transposed) or op(C) itself (C,
    from the fragments), op torch's / or * on the same C (zeros and
    subnormals included), for 1 and 3 passes."""
    c, value = _epilogue_case(shape, op, seed=sum(shape) + len(role))
    ref32 = _torch_op(torch.from_numpy(c), op, value)
    for passes in (1, 3):
        got, stores = _emulate_epilogue(c, role, passes, (op, value))
        assert (stores == 1).all()
        if role == "C":
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ref32.numpy().view(np.uint32))
            continue
        ref = cuda_kernels.tier_split_plain(
            ref32, role == "B",
            *cuda_kernels.tier_plane_extents(role, *c.shape), passes)
        assert (ref.view(torch.int16).numpy().view(np.uint16) == got).all()


def test_epilogue_enums_match_the_wrapper():
    """The wrapper's epilogue and op codes are the kernel's enums; the
    planes tiles fit a ring stage of 1 pass and keep their float4 reads
    16-byte aligned."""
    c, e = _kernel_constants(), _epilogue_constants()
    assert e["Epilogue"] == {"kDirectC": 0, "kPlanesA": 1, "kPlanesB": 2}
    assert list(e["Epilogue"].values()) == \
        [cuda_kernels._TIER_EPILOGUE[r] for r in ("C", "A", "B")]
    assert e["Op"] == {"kOpNone": 0, "kOpDivide": 1, "kOpScale": 2}
    assert list(e["Op"].values()) == list(cuda_kernels._TIER_OP.values())
    ring_1pass = c["kStages"] * (c["kBM"] + c["kBN"]) * c["kBK"] * 2
    assert c["kBM"] * e["kTilePitch"] * 4 <= ring_1pass
    assert c["kBN"] * e["kTilePitchT"] * 4 <= ring_1pass
    assert e["kTilePitch"] % 4 == 0 and e["kTilePitchT"] % 4 == 0


@pytest.mark.parametrize("op", EPILOGUE_OPS)
@pytest.mark.parametrize("role", ["A", "B", "C"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (15, 17, 13), (130, 131, 129)])
def test_planes_plain_is_split_of_op_of_the_twin(shape, role, op):
    """tier_gemm_planes_plain is tier_split_plain(op(tier_matmul_plain))
    bitwise, op torch's / or *, for 1 and 3 passes."""
    m, n, k = shape
    a, b = (torch.from_numpy(x) for x in _operands(m, n, k, seed=m + k))
    _, value = _epilogue_case(shape, op, seed=n)
    kw = {"none": {}, "divide": {"table": value},
          "scale": {"scale": value}}[op]
    kw = {key: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for key, v in kw.items()}
    for passes in (1, 3):
        got = cuda_kernels.tier_gemm_planes_plain(a, b, passes, role, **kw)
        c = _torch_op(cuda_kernels.tier_matmul_plain(a, b, passes), op,
                      value)
        want = c if role == "C" else cuda_kernels.tier_split_plain(
            c, role == "B", *cuda_kernels.tier_plane_extents(role, m, n),
            passes)
        assert got.dtype == want.dtype and torch.equal(got, want)


# ------------------------------------------------------- the chained solve

def _sine(n, size=None):
    size = size or n - 1
    k = torch.arange(1, size + 1, dtype=torch.int32)
    return torch.where((k[:, None] < n) & (k[None, :] < n),
                       direct._sine_entries(k[:, None], k[None, :], n, F32),
                       0.0)


def _solve_parts(shape, passes, seed):
    """Plans of two symmetric sine matrices over fields of `shape`, a
    negative den and a field."""
    p, q = shape
    sx, sy = _sine(p + 1), _sine(q + 1)
    rng = np.random.default_rng(seed)
    den = torch.from_numpy(-rng.uniform(1.0, 50.0, shape).astype(np.float32))
    f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    plans = (cuda_kernels.TierPlan(sx, passes, "left", shape),
             cuda_kernels.TierPlan(sy, passes, "right", shape))
    return plans, den, f


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("shape", [(16, 16), (31, 40), (64, 128)])
def test_tier_solve_on_cpu_is_the_composition(shape, passes):
    """A TierSolve on the CPU is the plans' products with torch's / and *
    between them, bitwise (without grad and under autograd, the same psi),
    the same as tier_matmul_plain written out; its gradient is autograd of
    that composition, bitwise."""
    (left, right), den, f = _solve_parts(shape, passes, seed=sum(shape))
    scale = 4.0 / ((shape[0] + 1) * (shape[1] + 1))
    solve = cuda_kernels.TierSolve(left, right, den, scale)
    mm = cuda_kernels.tier_matmul_plain
    coeff = mm(mm(left.const, f, passes), right.const, passes) / den
    want = mm(mm(left.const, coeff, passes), right.const, passes) * scale
    assert torch.equal(solve(f), want)
    assert torch.equal(solve.products(f), want)
    x = f.clone().requires_grad_()
    out = solve(x)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32))
    (got,) = torch.autograd.grad(out, x, g)
    y = f.clone().requires_grad_()
    (ref,) = torch.autograd.grad(solve.products(y), y, g)
    assert torch.equal(got, ref)


def test_tier_solve_refuses_bad_parts():
    (left, right), den, f = _solve_parts((16, 16), 3, seed=1)
    with pytest.raises(ValueError, match="left and a right"):
        cuda_kernels.TierSolve(right, left, den, 1.0)
    with pytest.raises(ValueError, match="den"):
        cuda_kernels.TierSolve(left, right, den[:, :8], 1.0)
    with pytest.raises(ValueError, match="den"):
        cuda_kernels.TierSolve(left, right, den.double(), 1.0)
    other = cuda_kernels.TierPlan(_sine(17), 1, "right", (16, 16))
    with pytest.raises(ValueError, match="one tier"):
        cuda_kernels.TierSolve(left, other, den, 1.0)
    wide = cuda_kernels.TierPlan(torch.ones(16, 8), 3, "left", (8, 16))
    with pytest.raises(ValueError, match="square"):
        cuda_kernels.TierSolve(wide, right, den, 1.0)
    solve = cuda_kernels.TierSolve(left, right, den, 1.0)
    with pytest.raises(ValueError, match="fields"):
        solve(f[:, :8])
    grad_den = cuda_kernels.TierSolve(left, right,
                                      den.clone().requires_grad_(), 1.0)
    with pytest.raises(ValueError, match="no gradient"):
        grad_den(f)
    with pytest.raises(ValueError, match="on the card"):
        left.gemm_into("A")


# the tier solves against the JAX package's fp32 solve (JAX's CPU backend
# ignores mm_precision): rel. to max|u|, the trajectories' bounds
# (measured 1.07e-5 and 1.16e-5 for bf16x3, 7.2e-3 and 8.3e-3 for bf16x1,
# the matmul and fused forms alike)
SOLVE_TOL = {"bf16x3": 5e-5, "bf16x1": 1e-2}


@pytest.mark.parametrize("tier", ["bf16x3", "bf16x1"])
@pytest.mark.parametrize("form", ["matmul", "fused"])
@pytest.mark.parametrize("nx,ny", [(33, 47), (64, 64)])
def test_tier_solve_matches_jax_fp32_solve(nx, ny, form, tier):
    """The matmul tiers' interior solve (make_fst_matmul_interior) and the
    fused tiers' packed solve_neg (cavity_fused.make_solve_neg) against
    the JAX package's solve_fst_matmul_interior(mm_precision="high"), on
    a seeded field: within SOLVE_TOL of max|u|."""
    rng = np.random.default_rng(nx * ny)
    f = np.zeros((nx + 1, ny + 1), np.float32)
    f[1:-1, 1:-1] = rng.standard_normal((nx - 1, ny - 1))
    dx, dy = 1.0 / nx, 1.0 / ny
    ref = np.asarray(jax_direct.solve_fst_matmul_interior(
        jnp.asarray(f), nx, ny, dx, dy, mm_precision="high"))
    ft = torch.from_numpy(f)
    if form == "matmul":
        got = direct.make_fst_matmul_interior(nx, ny, dx, dy, F32, "cpu",
                                              tier=tier)(ft).numpy()
    else:
        cfg = cavity.CavityConfig(nx=nx, ny=ny, poisson=f"fused_{tier}")
        P, Q = cavity_fused.padded_extents(nx, ny)
        wt = torch.zeros((P, Q), dtype=F32)
        wt[:nx - 1, :ny - 1] = -ft[1:-1, 1:-1]
        psi = cavity_fused.make_solve_neg(cfg, F32, "cpu")(wt)
        assert not psi[nx - 1:].any() and not psi[:, ny - 1:].any()
        got = np.zeros_like(f)
        got[1:-1, 1:-1] = psi[:nx - 1, :ny - 1].numpy()
    assert _rel(got, ref) <= SOLVE_TOL[tier]


@pytest.mark.parametrize("tier", TIERS)
def test_chained_solve_gradient_is_the_per_product_one(tier, monkeypatch):
    """d loss/dRe and d loss/d(w0) through 3 fp32 steps at 24^2 with the
    chained solve (one autograd Function a solve) bitwise the gradients
    through the per-product solve (a _TierPlanProduct a product, torch's
    / and * between), and the same loss."""
    cfg = cavity.CavityConfig(nx=24, ny=24, dt=1e-3, poisson=tier)
    rng = np.random.default_rng(3)

    def grads():
        re_t = torch.tensor(100.0, dtype=F32, requires_grad=True)
        if tier.startswith("fused"):
            step = cavity_fused.make_fused_step_fn(cfg, F32, "cpu", re=re_t)
            state = cavity_fused.init_state(cfg, F32, "cpu")
        else:
            step = cavity.make_step_fn(cfg, F32, "cpu", re=re_t)
            state = cavity.initial_state(cfg, F32, "cpu")
        w0 = torch.from_numpy(0.1 * rng.standard_normal(
            tuple(state[0].shape)).astype(np.float32)).requires_grad_()
        final = loop.advance(step, (w0, *state[1:]), 3, graph=False)
        loss = 1e6 * torch.mean(final[1] ** 2)
        return (loss.detach(), *torch.autograd.grad(loss, (re_t, w0)))

    chained = grads()
    rng = np.random.default_rng(3)
    monkeypatch.setattr(cuda_kernels.TierSolve, "__call__",
                        lambda self, f: self.products(f))
    per_product = grads()
    for got, want in zip(chained, per_product):
        assert torch.equal(got, want)
    assert float(chained[1]) != 0.0


# ------------------------------------------------------- the DST solve

def _dst_problem(nx=512, seed=7):
    rng = np.random.default_rng(seed)
    f = np.zeros((nx + 1, nx + 1))
    f[1:-1, 1:-1] = rng.standard_normal((nx - 1, nx - 1))
    return f


@pytest.fixture(scope="module")
def dst_errors():
    """rel errors of 512^2 DST solves (tests/test_poisson2d.py:363-428's
    problem) against fp64 ones:
    * "recipe": that JAX test's own computation (fp64 sine matrices and
      denominator, fp32 operands) with the port's tier products, against
      the exact fp64 solve: the tier's product error alone;
    * "solve": the port's fp32 make_fst_matmul_interior(tier=...) against
      the JAX package's fp32 solve.  Against the fp64 solve both fp32
      solves are ~3.1e-4 off whatever the products: the fp32 denominator
      (cos(pi k/n) - 1 of the lowest modes loses ~11 bits to cancellation),
      which the recipe keeps in fp64."""
    nx = 512
    f = _dst_problem(nx)
    errs = {}
    P = nx + 1
    s = np.asarray(jax_direct.sine_matrix(nx, P, jnp.float64))
    k, l_ = np.arange(P)[:, None], np.arange(P)[None, :]
    valid = (k >= 1) & (k <= nx - 1) & (l_ >= 1) & (l_ <= nx - 1)
    den = np.where(valid, 2.0 * nx**2 * (np.cos(np.pi * k / nx) - 1.0)
                   + 2.0 * nx**2 * (np.cos(np.pi * l_ / nx) - 1.0), 1.0)
    scale = 4.0 / (nx * nx)
    u64 = (s @ ((s @ f @ s) / den) @ s) * scale
    ref32 = np.asarray(jax_direct.solve_fst_matmul_interior(
        jnp.asarray(f, jnp.float32), nx, nx, 1.0 / nx, 1.0 / nx))
    f32 = torch.as_tensor(f, dtype=F32)
    for tier, passes in cuda_kernels.TIER_PASSES.items():
        def mm(a, b):
            return cuda_kernels.tier_matmul(
                torch.as_tensor(np.asarray(a, np.float32)),
                torch.as_tensor(np.asarray(b, np.float32)), passes).numpy()

        coeff = mm(s, mm(f, s)) / den
        errs["recipe", tier] = _rel(mm(s, mm(coeff, s)) * scale, u64)
        u = direct.make_fst_matmul_interior(nx, nx, 1.0 / nx, 1.0 / nx, F32,
                                            "cpu", tier=tier)(f32)
        errs["solve", tier] = _rel(u.numpy(), ref32)
    return errs


@pytest.mark.parametrize("kind", ["recipe", "solve"])
def test_dst_solve_bf16x3_within_the_jax_bound(dst_errors, kind):
    """bf16x3's DST solve within that JAX test's 5e-5 (measured: recipe
    1.98e-5, solve 1.75e-5; the port's fp32 solve is 1.9e-6 from JAX's)."""
    assert dst_errors[kind, "bf16x3"] < 5e-5, dst_errors


@pytest.mark.parametrize("kind", ["recipe", "solve"])
def test_dst_solve_bf16x1_is_far_coarser(dst_errors, kind):
    """bf16x1 more than 20x bf16x3's error (measured 7.3e-3 and 6.6e-3)."""
    assert dst_errors[kind, "bf16x1"] > 20 * dst_errors[kind, "bf16x3"], \
        dst_errors


# ------------------------------------------------------- cavity trajectories

CAVITY_CASES = [(33, 47, 1), (33, 47, 2), (64, 64, 1), (64, 64, 2)]


def _initial(nx, ny, seed=0):
    rng = np.random.default_rng(seed)
    shape = (nx + 1, ny + 1)
    return (0.5 * rng.standard_normal(shape).astype(np.float32),
            0.01 * rng.standard_normal(shape).astype(np.float32))


def _port_run(cfg, w0, s0, nt=5):
    """(w, s) full grid after nt fp32 CPU steps of the port's step for
    cfg.poisson (the packed step for the fused names)."""
    w, s = (torch.from_numpy(x) for x in (w0, s0))
    if cfg.poisson.startswith("fused"):
        step = cavity_fused.make_fused_step_fn(cfg, F32, "cpu")
        state = loop.advance(step, cavity_fused.pack_state(cfg, w, s), nt)
        return [t.numpy() for t in cavity_fused.decode_state(cfg, state)]
    step = cavity.make_step_fn(cfg, F32, "cpu")
    state = loop.advance(step, (w, s, torch.zeros((), dtype=F32)), nt)
    return [t.numpy() for t in state[:2]]


@functools.cache
def _jax_run(jcfg, nt=5):
    """The JAX package's fp32 step of the same formulation (its tier on the
    CPU is exact fp32) from _initial's state; one run a configuration."""
    w, s = (jnp.asarray(x) for x in _initial(jcfg.nx, jcfg.ny))
    if jcfg.poisson.startswith("fused"):
        step = jax.jit(jax_fused.make_fused_step_fn(jcfg))
        state = jax_fused.pack_state(jcfg, w, s)
        for _ in range(nt):
            state = step(state)
        return [np.asarray(x) for x in jax_fused.decode_state(jcfg, state)]
    step = jax.jit(jax_cavity.make_step_fn(jcfg))
    state = (w, s, jnp.zeros((), jnp.float32))
    for _ in range(nt):
        state = step(state)
    return [np.asarray(x) for x in state[:2]]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("nx,ny,bc_order", CAVITY_CASES)
def test_tier_trajectory_matches_jax_fp32(nx, ny, bc_order, tier):
    jcfg = jax_cavity.CavityConfig(nx=nx, ny=ny, dt=1e-3, re=100.0,
                                   bc_order=bc_order, poisson=tier,
                                   rhs_impl="xla")
    cfg = interop.cavity_config_from_jax(jcfg)
    assert cfg.poisson == tier
    w0, s0 = _initial(nx, ny)
    got = _port_run(cfg, w0, s0)
    ref = _jax_run(dataclasses.replace(jcfg, poisson=tier.split("_")[0]))
    tol = TRAJ_TOL[direct.tier_of(tier)]
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        assert _rel(g, r) <= tol


@pytest.mark.parametrize("tier", ["bf16x3", "bf16x1"])
@pytest.mark.parametrize("nx,ny,bc_order", CAVITY_CASES)
def test_fused_tier_matches_matmul_tier(nx, ny, bc_order, tier):
    """The packed step and the full-grid step of one tier split the same
    sine entries; only the zero padding and the stage arithmetic differ."""
    cfg = cavity.CavityConfig(nx=nx, ny=ny, dt=1e-3, re=100.0,
                              bc_order=bc_order)
    # 20 fp64 steps from rest: walls consistent with psi
    state = loop.advance(
        cavity.make_step_fn(dataclasses.replace(cfg, poisson="matmul"),
                            torch.float64, "cpu"),
        cavity.initial_state(cfg, torch.float64, "cpu"), 20)
    w0, s0 = (t.float().numpy() for t in state[:2])
    fused = _port_run(dataclasses.replace(cfg, poisson=f"fused_{tier}"),
                      w0, s0)
    full = _port_run(dataclasses.replace(cfg, poisson=f"matmul_{tier}"),
                     w0, s0)
    for g, r in zip(fused, full):
        assert _rel(g, r) <= FUSED_VS_MATMUL_TOL


@pytest.mark.parametrize("tier", ["fused_bf16x3", "fused_bf16x1"])
def test_solve_routes_fused_tiers(tier):
    """cavity.solve runs a fused tier through the packed step: pack, run,
    decode, the same fields as the step-level run."""
    cfg = cavity.CavityConfig(nx=16, ny=16, dt=2e-3, t_final=0.02,
                              poisson=tier)
    res = cavity.solve(cfg, F32, "cpu")
    step = cavity_fused.make_fused_step_fn(cfg, F32, "cpu")
    state, rms = loop.run_steps(step, cavity_fused.init_state(cfg, F32,
                                                              "cpu"), 10)
    w, s = cavity_fused.decode_state(cfg, state)
    assert torch.equal(res.w, w) and torch.equal(res.s, s)
    assert torch.equal(res.rms_history, rms)


def test_auto_stays_matmul():
    """poisson="auto" is the fp32 matmul step on every device, bit for bit;
    no tier enters it."""
    cfg = cavity.CavityConfig(nx=24, ny=16, dt=1e-3)
    w0, s0 = _initial(24, 16)
    auto = _port_run(cfg, w0, s0)
    matmul = _port_run(dataclasses.replace(cfg, poisson="matmul"), w0, s0)
    for a, m in zip(auto, matmul):
        np.testing.assert_array_equal(a, m)


# ------------------------------------------------------- guards, entry points

@pytest.mark.parametrize("tier", ["fused_bf16x3", "fused_bf16x1"])
def test_make_step_fn_refuses_fused_tiers(tier):
    cfg = cavity.CavityConfig(nx=16, ny=16, poisson=tier)
    with pytest.raises(ValueError, match="fused"):
        cavity.make_step_fn(cfg, F32, "cpu")


@pytest.mark.parametrize("name", ["matmul_bf16x2", "fused_bf16", "bf16x3",
                                  "matmul_tf32"])
def test_unknown_tier_name_raises(name):
    cfg = cavity.CavityConfig(nx=16, ny=16, poisson=name)
    with pytest.raises(ValueError, match="unknown poisson"):
        cavity.make_step_fn(cfg, F32, "cpu")
    with pytest.raises(ValueError, match="unknown poisson"):
        cavity.solve(cfg, F32, "cpu")


@pytest.mark.parametrize("tier", TIERS)
def test_interop_maps_tier(tier):
    jcfg = jax_cavity.CavityConfig(nx=32, ny=24, poisson=tier)
    got = interop.cavity_config_from_jax(jcfg)
    assert got == cavity.CavityConfig(nx=32, ny=24, poisson=tier)


@pytest.mark.parametrize("tier", TIERS)
def test_cli_runs_tier_on_cpu(tier, tmp_path):
    rc = cli.main(["run", "cavity", "--device", "cpu", "--poisson", tier,
                   "--nx", "16", "--ny", "12", "--t_final", "0.004",
                   "--outdir", str(tmp_path)])
    assert rc == 0
    for name in ("res_plot.txt", "field_final.txt", "centerline_u.txt",
                 "centerline_v.txt", "metrics.json"):
        assert (tmp_path / name).exists(), name
    assert len((tmp_path / "res_plot.txt").read_text().splitlines()) == 4
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert math.isfinite(metrics["psi_min"]) and metrics["device"] == "cpu"
