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
  walkers of BACK_ROWS rows over a window of three fields, and the Re
  gradient's partial sums, a block's written to its own slot and a
  member's slots added by a one-block second launch;
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
BACK_ROWS = _constant("arakawa_rhs.cu", "kBackRows")
SUM_THREADS = _constant("arakawa.cuh", "kSumThreads")
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
    assert BLOCK_X == 32 and BLOCK_Y >= 1 and ROWS >= 1 and BACK_ROWS >= 1
    # the Re gradient's second launch halves its sums down to one
    assert SUM_THREADS & (SUM_THREADS - 1) == 0
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
    """Lane 0's value after __shfl_down_sync steps 16, 8, 4, 2, 1 (a lane
    past the warp keeps its own value)."""
    v = v.clone()
    for d in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[d:], v[32 - d:]])
    return v[0]


def emulate_arakawa_backward(w, s, g, dx, dy, re, partial_slot=None):
    """arakawa_rhs_backward as csrc/arakawa_rhs.cu computes it on (B, nr,
    nc) fields with one Re a member: walkers of BACK_ROWS rows with a
    window of w, s, g (rows wrapped as the forward's), each thread's fp64
    sum of g lap(w) over its stored rows, a block's sum by warp shuffles
    and then the warps in order into partials[(b gy + by) gx + bx], and
    the second launch's SUM_THREADS strided sums and tree per member.
    partial_slot(b, by, bx, gy, gx) overrides the slot (a wrong kernel)."""
    batch, nr, nc = w.shape
    gg = 1.0 / (4.0 * dx * dy)
    gw, gs = torch.full_like(w, float("nan")), torch.full_like(w, float("nan"))
    gx = -(-nc // BLOCK_X)
    gy = -(-(-(-nr // BACK_ROWS)) // BLOCK_Y)
    partials = torch.zeros(batch * gy * gx, dtype=torch.float64)
    slot = partial_slot or (lambda b, by, bx, gy, gx: (b * gy + by) * gx + bx)
    for b in range(batch):
        f = (w[b], s[b], g[b])
        for bx in range(gx):
            jj = torch.arange(bx * BLOCK_X, (bx + 1) * BLOCK_X)
            lanes = jj < nc
            j = jj[lanes]
            cols = (torch.where(j == 0, nc - 1, j - 1), j,
                    torch.where(j + 1 == nc, 0, j + 1))
            for by in range(gy):
                acc = torch.zeros(BLOCK_Y, BLOCK_X, dtype=torch.float64)
                for ty in range(BLOCK_Y):
                    i0 = (by * BLOCK_Y + ty) * BACK_ROWS
                    if i0 >= nr:
                        continue
                    rows = []
                    for q in range(i0 - 1, i0 + BACK_ROWS + 1):
                        i = nr - 1 if q < 0 else (0 if q >= nr else q)
                        rows.append([[x[i, c] for c in cols] for x in f])
                    for r in range(BACK_ROWS):
                        W, C, E = rows[r], rows[r + 1], rows[r + 2]
                        # (c, E, W, N, S, NE, SW, NW, SE) of field k
                        n = [(C[k][1], E[k][1], W[k][1], C[k][2], C[k][0],
                              E[k][2], W[k][0], W[k][2], E[k][0])
                             for k in range(3)]
                        if i0 + r < nr:
                            gw[b, i0 + r, j] = -_jac(n[1], n[2], gg) + \
                                _lap(n[2], dx, dy) / re[b]
                            gs[b, i0 + r, j] = -_jac(n[2], n[0], gg)
                            acc[ty, lanes] += (n[2][0] * _lap(n[0], dx, dy)
                                               ).double()
                total = 0.0
                for ty in range(BLOCK_Y):
                    total = total + _warp_sum(acc[ty])
                partials[slot(b, by, bx, gy, gx)] = total
    gre = torch.empty(batch, dtype=w.dtype)
    n = gy * gx
    for b in range(batch):
        p = partials[b * n:(b + 1) * n]
        sums = torch.zeros(SUM_THREADS, dtype=torch.float64)
        for k in range(0, n, SUM_THREADS):
            part = p[k:k + SUM_THREADS]
            sums[:part.shape[0]] += part
        half = SUM_THREADS // 2
        while half:
            sums[:half] += sums[half:2 * half]
            half //= 2
        gre[b] = -sums[0] / (float(re[b]) * float(re[b]))
    return gw, gs, gre


# a batch of ragged members, and one member on several blocks both ways
BACKWARD_SHAPES = [(2, 3, 1), (3, 17, 33), (1, 37, 53),
                   (2, 2 * BLOCK_Y * BACK_ROWS + 7, 2 * BLOCK_X + 6)]


def _backward_fields(shape, seed):
    rng = np.random.default_rng(seed)
    w, s, g = (torch.as_tensor(rng.standard_normal(shape)) for _ in range(3))
    re = torch.as_tensor(rng.uniform(50.0, 5000.0, shape[0]))
    return w, s, g, 1.0 / (shape[1] - 1), 1.0 / max(shape[2] - 1, 1), re


@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_arakawa_backward_walk_matches_plain(shape):
    """The backward's walk against arakawa_rhs_backward_plain, fp64: the
    fields within 1e-12 of their scale (their largest value or their
    Jacobian term's size), each member's d/dre within 1e-12 relative."""
    w, s, g, dx, dy, re = _backward_fields(shape, seed=sum(shape))
    got = emulate_arakawa_backward(w, s, g, dx, dy, re)
    ref = cuda_kernels.arakawa_rhs_backward_plain(w, s, g, dx, dy, re)
    gg = 1.0 / (4.0 * dx * dy)
    jac = (gg * float(s.abs().max() * g.abs().max()),
           gg * float(g.abs().max() * w.abs().max()))
    for mine, want, term in zip(got[:2], ref[:2], jac):
        scale = max(float(want.abs().max()), term)
        assert float((mine - want).abs().max()) <= 1e-12 * scale
    assert torch.allclose(got[2], ref[2], rtol=1e-12, atol=0.0)


def test_arakawa_backward_wrong_slot_is_caught():
    """Partial sums written to another member's slots move the Re
    gradients off the plain version's, so the test above can see a wrong
    slot index."""
    w, s, g, dx, dy, re = _backward_fields((2, 17, 33), seed=7)
    got = emulate_arakawa_backward(
        w, s, g, dx, dy, re,
        partial_slot=lambda b, by, bx, gy, gx: ((1 - b) * gy + by) * gx + bx)
    ref = cuda_kernels.arakawa_rhs_backward_plain(w, s, g, dx, dy, re)
    assert not torch.allclose(got[2], ref[2], rtol=1e-6)


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
