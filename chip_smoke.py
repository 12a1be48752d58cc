#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cfd_julia_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

Phases, one line each:
  0. the card (nvidia-smi name and power limit) and the fp32 matmul mode;
  1. builds the CUDA kernels from cfd_julia_torch/csrc/ with nvcc (one
     process per source, all started together), with ptxas's counts;
  2. each kernel against its plain PyTorch twin on seeded inputs, and its
     time beside the twin's and its bound (bytes over HBM rate or flops
     over the fp32 peak) at its main path's shape: the Arakawa RHS in
     fp32 and fp64 at 1025^2 and at 2048^2 (the cavity's and the fdm
     vortex solver's shapes, each timed warm in L2 and with L2 flushed)
     and at small and ragged shapes down to 3x1, two calls bitwise equal;
     the four multigrid kernels at 4097^2 fp32 (the 4096^2
     solve's finest level, sweeps 2) and at 129x65, 33x65, 5x5 and the
     ragged 131x67 and 301x261 in fp32, fp64 and bf16, the two level-edge
     kernels and the smoother at sweeps 0, 1, 2, K+2 and 2K+1 (K sweeps a
     pass) with two calls bitwise equal; the smoother also at even-sided
     shapes and on both sides of its one-block limit, and timed at 129^2,
     65^2 and 3x3 beside an empty launch; the Euler RHS at (3, 8192),
     (3, 257), nx = 3,
     4, 5 and a block's cells - 1, + 0, + 1 in fp32 and fp64 for roe,
     hllc, rusanov/roe and rusanov/spectral, on random physical states and
     on the Sod state after 100 steps, two calls bitwise equal, timed
     beside an empty launch;
  3. the cavity path: the lid-driven cavity at 1024^2 (dt=2e-5, Re=100,
     Jensen wall BCs, fp32) from rest, 100 steps and then on to 2000,
     checked against the fp64 anchors of benchmarks/physics_anchors.json,
     with the kernels' launch counts over that run;
  4. the user entry point `python -m cfd_julia_torch run cavity` on the
     reference case (64^2, Re=100, t=10) against Ghia et al. (1982);
  5. the multigrid path: the 4096^2 `poly` Poisson solve (fp32, tol 1e-5,
     at most 20 V-cycles, 12 levels, fused edges) through
     poisson.multigrid.solve, with an independent fp64 residual recheck,
     the same solve on the plain twins as the reference, the kernels'
     launch counts against the pyramid's, and seconds per solve; then the
     fmg, cycle_dtype="mixed" and fused="off" variants, checked alike,
     with mixed's error over the fused fp32 solve's printed (--profile:
     device launches a solve, a level edge and a smoother call, for the
     fused solve and for the fused="off" one);
  6. the user entry point `python -m cfd_julia_torch run poisson_mgN`
     (512^2, 9 levels) against the exact solution;
  7. the Euler path: Sod, fp32, 2000 SSP-RK3 steps at dt = 1e-4*256/nx
     for hllc and rusanov at nx=8192 and roe at nx=256, through
     models.euler1d.make_rhs (rhs_impl="auto": the CUDA kernel), against
     the fp64 anchors, with the kernel's launch count, steps/s, and the
     same run on the plain twin as the reference;
  8. the user entry point `python -m cfd_julia_torch run euler_hllc`
     (8192 cells, dt=5e-5, t=0.2) against the exact Sod solution;
  9. the vortex path: the vortex merger at 2048^2 (dt=1e-3, Re=1000, fp32)
     from the two-Gaussian state, 100 steps and then on to 200, for ps23,
     ps32 and hybrid through models.vortex.make_spectral_step_half (cuFFT)
     and for fdm through SSP-RK3 over fdm_rhs (rhs_impl="auto": the
     Arakawa CUDA kernel on the periodic field), each against its fp64
     anchor, with steps/s; fdm with the kernel's launch count and the same
     run on the plain twin (--profile: the ps23 and fdm steps by kernel);
 10. the user entry points `run tgv` (64^2, Re=10, t=1) against the
     analytic decay, `run vortex_merger_ps23` (128^2, t=20) for its
     snapshots' mean and enstrophy, and `run poisson_fst` and
     `run poisson_fft_spectral` against their exact solutions;
 11. the cavity of phase 3 with the rfft DST-I Poisson solves (poisson=
     "fst" and "fst_half") in place of the sine matmuls, against the same
     anchors, with steps/s beside phase 3's (--profile: the fst step).
Then a JSON line with each kernel's record, and last
{"ok": true, "device": {...}}.  Any failure raises and the script exits
nonzero without that last line; without a GPU it fails at once.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
ANCHORS = REPO / "benchmarks" / "physics_anchors.json"

# Ghia, Ghia & Shin (1982), Re=100 centerline velocities
GHIA_Y = [0.0, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531, 0.5,
          0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766, 1.0]
GHIA_U = [0.0, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150, -0.15662,
          -0.21090, -0.20581, -0.13641, 0.00332, 0.23151, 0.68717, 0.73722,
          0.78871, 0.84123, 1.0]
GHIA_X = [0.0, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266, 0.2344, 0.5,
          0.8047, 0.8594, 0.9063, 0.9453, 0.9531, 0.9609, 0.9688, 1.0]
GHIA_V = [0.0, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077, 0.17507,
          0.17527, 0.05454, -0.24533, -0.22445, -0.16914, -0.10313,
          -0.08864, -0.07391, -0.05906, 0.0]

RE = 100.0
NX = 1024
STEPS_FIRST, STEPS_TOTAL = 100, 2000
MG_NX = 4096
MG_TOL = 1e-5
MG_SWEEPS = 2
# the Euler path: (solver, nx) of the anchored bench configs, at
# dt = 1e-4 * 256 / nx for EULER_STEPS steps
EULER_RUNS = [("hllc", 8192), ("rusanov", 8192), ("roe", 256)]
EULER_STEPS = 2000
EULER_VARIANTS = [("roe", "roe"), ("hllc", "roe"), ("rusanov", "roe"),
                  ("rusanov", "spectral")]
# the multigrid kernels: LAUNCHES key -> the TPU kernel it replaces
MG_KERNELS = {
    "prolong_correct_smooth": "cfd_julia_tpu/ops/pallas_kernels.py:547",
    "smooth_residual_restrict": "cfd_julia_tpu/ops/pallas_kernels.py:347",
    "residual_restrict": "cfd_julia_tpu/ops/pallas_kernels.py:417",
    "redblack_sweeps": "cfd_julia_tpu/ops/pallas_kernels.py:144",
}
MG_EDGES = ("prolong_correct_smooth", "smooth_residual_restrict")
# the kernels held at every sweep count of phase 2's list
MG_SWEPT = (*MG_EDGES, "redblack_sweeps")
# besides 4097^2: small shapes, and ragged ones that no tile size divides
MG_SHAPES = [(129, 65), (33, 65), (5, 5), (131, 67), (301, 261)]
# the smoother alone besides those: even sides, and both sides of its
# one-block limit of 65^2 nodes (65x65 and 33x128 on it, 65x66 and 33x129
# past it); 129^2, 65^2 and 3x3 are timed
RB_SHAPES = [(3, 3), (4, 6), (33, 64), (65, 65), (33, 128), (65, 66),
             (33, 129), (129, 129)]
RB_TIMED = [(129, 129), (65, 65), (3, 3)]

# the vortex path: nx, steps of the anchored bench windows, and the solvers
# in the order run (`<solver>:2048:200` in the anchors file)
VORTEX_NX = 2048
VORTEX_FIRST, VORTEX_TOTAL = 100, 200
VORTEX_SOLVERS = ("ps23", "ps32", "hybrid", "fdm")
# max|w_kernel - w_twin| after the 200 fp32 fdm steps, of max|w| ~ 1: two
# fp32 evaluations of one smooth flow, 600 RHS calls apart by roundoff
VORTEX_TWIN_TOL = 1e-4

# An H100 SXM's published peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s,
# fp32 outside the tensor cores at 67 TFLOP/s.  A card below 700 W runs
# slower than these.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# flops a kernel needs per node, counted from its source: the 5-point
# relaxation 12 (Laplacian 9, f - lap, / diag, +), the residual 10, the
# restriction 19 a coarse node, the bilinear correction 3 on average, a
# squared residual 12; the Arakawa RHS 45; the Euler RHS ~400 an
# interface (csrc/euler_rhs.cu's count)
FLOPS_RELAX, FLOPS_RESIDUAL, FLOPS_RESTRICT = 12, 10, 19
FLOPS_PROLONG, FLOPS_SQ_RESIDUAL = 3, 12
FLOPS_ARAKAWA, FLOPS_EULER_INTERFACE = 45, 400
# written before a cold-L2 timing: more than twice the 50 MB L2
FLUSH_BYTES = 128 * 2**20


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def exact_sod(x, t, gamma=1.4, rhoL=1.0, uL=0.0, pL=1.0,
              rhoR=0.125, uR=0.0, pR=0.1, x0=0.5):
    """Exact solution of the Riemann problem, sampled at (x - x0)/t (Toro
    ch. 4); a copy of tests/test_euler1d.exact_sod, which imports JAX
    (tests/test_torch_euler1d.py holds the two equal)."""
    aL = np.sqrt(gamma * pL / rhoL)
    aR = np.sqrt(gamma * pR / rhoR)
    g1 = (gamma - 1) / (2 * gamma)
    g2 = (gamma + 1) / (2 * gamma)

    def f_side(p, ps, rhos, as_):
        if p > ps:  # shock
            A = 2 / ((gamma + 1) * rhos)
            B = (gamma - 1) / (gamma + 1) * ps
            return (p - ps) * np.sqrt(A / (p + B))
        # rarefaction
        return 2 * as_ / (gamma - 1) * ((p / ps) ** g1 - 1)

    def fp_side(p, ps, rhos, as_):
        if p > ps:
            A = 2 / ((gamma + 1) * rhos)
            B = (gamma - 1) / (gamma + 1) * ps
            return np.sqrt(A / (p + B)) * (1 - (p - ps) / (2 * (p + B)))
        return (p / ps) ** (-g2) / (rhos * as_)

    du = uR - uL
    p = 0.5 * (pL + pR)
    for _ in range(60):  # Newton
        f = f_side(p, pL, rhoL, aL) + f_side(p, pR, rhoR, aR) + du
        df = fp_side(p, pL, rhoL, aL) + fp_side(p, pR, rhoR, aR)
        p = max(1e-8, p - f / df)
    us = 0.5 * (uL + uR) + 0.5 * (
        f_side(p, pR, rhoR, aR) - f_side(p, pL, rhoL, aL)
    )

    s = (np.asarray(x) - x0) / t
    rho = np.empty_like(s)
    u = np.empty_like(s)
    pp = np.empty_like(s)
    for i, si in enumerate(s):
        if si < us:  # left of contact
            if p > pL:  # left shock
                SL = uL - aL * np.sqrt(g2 * p / pL + g1)
                if si < SL:
                    rho[i], u[i], pp[i] = rhoL, uL, pL
                else:
                    rho[i] = rhoL * (p / pL + (gamma - 1) / (gamma + 1)) / (
                        (gamma - 1) / (gamma + 1) * p / pL + 1
                    )
                    u[i], pp[i] = us, p
            else:  # left rarefaction
                SHL = uL - aL
                aSL = aL * (p / pL) ** g1
                STL = us - aSL
                if si < SHL:
                    rho[i], u[i], pp[i] = rhoL, uL, pL
                elif si > STL:
                    rho[i] = rhoL * (p / pL) ** (1 / gamma)
                    u[i], pp[i] = us, p
                else:  # fan
                    u[i] = 2 / (gamma + 1) * (aL + (gamma - 1) / 2 * uL + si)
                    a = aL - (gamma - 1) / 2 * (u[i] - uL)
                    rho[i] = rhoL * (a / aL) ** (2 / (gamma - 1))
                    pp[i] = pL * (a / aL) ** (2 * gamma / (gamma - 1))
        else:  # right of contact
            if p > pR:  # right shock
                SR = uR + aR * np.sqrt(g2 * p / pR + g1)
                if si > SR:
                    rho[i], u[i], pp[i] = rhoR, uR, pR
                else:
                    rho[i] = rhoR * (p / pR + (gamma - 1) / (gamma + 1)) / (
                        (gamma - 1) / (gamma + 1) * p / pR + 1
                    )
                    u[i], pp[i] = us, p
            else:  # right rarefaction
                SHR = uR + aR
                aSR = aR * (p / pR) ** g1
                STR = us + aSR
                if si > SHR:
                    rho[i], u[i], pp[i] = rhoR, uR, pR
                elif si < STR:
                    rho[i] = rhoR * (p / pR) ** (1 / gamma)
                    u[i], pp[i] = us, p
                else:
                    u[i] = 2 / (gamma + 1) * (-aR + (gamma - 1) / 2 * uR + si)
                    a = aR + (gamma - 1) / 2 * (u[i] - uR)
                    rho[i] = rhoR * (a / aR) ** (2 / (gamma - 1))
                    pp[i] = pR * (a / aR) ** (2 * gamma / (gamma - 1))
    return rho, u, pp


def median_ms(fn, reps=30, warmup=5, before=None):
    """(device_ms, call_ms): medians of CUDA-event times of one call over
    `reps` calls after warm-up.  device_ms queues the call behind a
    busy-wait kernel, so its launches are all issued before the device
    reaches them and the events time the device alone (the wait, ~10 ms,
    outlasts the enqueue of every call timed here, the Euler twin's ~190
    launches included); call_ms issues it to an idle device, so the
    host's launch overhead shows as well.  before(), if given, is queued
    ahead of each timed call, outside the events (an L2 flush)."""
    for _ in range(warmup):
        fn()
    times = {}
    for mode in ("device", "call"):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in events:
            torch.cuda.synchronize()
            if mode == "device":
                torch.cuda._sleep(20_000_000)   # ~10 ms of clock cycles
            if before is not None:
                before()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times[mode] = float(np.median([s.elapsed_time(e) for s, e in events]))
    return times["device"], times["call"]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, ms):
    """The card's least time for a call (the larger of its bytes, each
    input read once and each output written once, over HBM's rate and its
    flops over the fp32 peak), what sets it, and the share of it that a
    call of `ms` reaches."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    bound_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    return {"bound_ms": bound_ms, "bound_by": by,
            "share_of_bound": bound_ms / ms}


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"phase 0 card: torch.cuda.get_device_name()="
          f"{torch.cuda.get_device_name()!r} device_count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()!r}")


def phase_build():
    from cfd_julia_torch.ops import _cuda_build

    cached = _cuda_build.library_path().exists()
    t0 = time.perf_counter()
    lib = _cuda_build.load_library()
    seconds = time.perf_counter() - t0
    print(f"phase 1 build: {'loaded cached' if cached else 'compiled'} "
          f"{Path(lib._name).relative_to(REPO)} in {seconds:.3f} s "
          f"(nvcc {' '.join(_cuda_build.COMPILE_FLAGS)} -c per source; "
          f"{' '.join(_cuda_build.LINK_FLAGS)} link)")
    log = Path(lib._name).with_name(_cuda_build.LOG_NAME)
    if log.is_file():
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        print(f"phase 1 ptxas: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
              f"{max(spills, default=0)} bytes at most")


# the Arakawa RHS besides its two paths' shapes: small shapes, and ragged
# ones that no block of the kernel divides (nc = 1, 2: the periodic
# neighbours alias)
ARAKAWA_SHAPES = [(37, 53), (8, 8), (3, 1), (3, 2), (65, 33), (1023, 31)]
# the shapes its paths give it, timed: the cavity's nodes and the periodic
# vortex field's unique nodes (16-byte-aligned rows, 3 fields the size of L2)
ARAKAWA_TIMED = [(NX + 1, NX + 1), (VORTEX_NX, VORTEX_NX)]


def phase_kernels():
    """Kernel vs plain twin, and two calls bitwise equal; returns the
    record of the cavity path's shape (1025^2 fp32), timed with the fields
    warm in L2 and with L2 flushed, with the vortex path's (2048^2) under
    its key "at_2048"."""
    from cfd_julia_torch.ops import cuda_kernels

    dev = torch.device("cuda")
    records = {}
    for shape in [*ARAKAWA_TIMED, *ARAKAWA_SHAPES]:
        rng = np.random.default_rng(shape[0] * 7919 + shape[1])
        w_np, s_np = rng.standard_normal(shape), rng.standard_normal(shape)
        dx, dy = 1.0 / (shape[0] - 1), 1.0 / max(shape[1] - 1, 1)
        # fp32 tolerance: FMA contraction and operation order
        for dtype, rel in [(torch.float32, 1e-5), (torch.float64, 1e-12)]:
            w = torch.as_tensor(w_np, dtype=dtype, device=dev)
            s = torch.as_tensor(s_np, dtype=dtype, device=dev)
            got = cuda_kernels.arakawa_rhs_fused(w, s, dx, dy, RE)
            again = cuda_kernels.arakawa_rhs_fused(w, s, dx, dy, RE)
            ref = cuda_kernels.arakawa_rhs_fused_plain(w, s, dx, dy, RE)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            same = torch.equal(got, again)
            ok = err <= rel * scale and same
            line = (f"phase 2 kernel arakawa_rhs {shape[0]}x{shape[1]} "
                    f"{str(dtype)[6:]}: max|k-p|={err:.3e} "
                    f"max|p|={scale:.3e} tol={rel:g}*max|p|; two calls "
                    f"bitwise equal: {same} {'ok' if ok else 'FAIL'}")
            if shape in ARAKAWA_TIMED and dtype == torch.float32:
                ms, call_ms = median_ms(lambda: cuda_kernels.arakawa_rhs_fused(
                    w, s, dx, dy, RE))
                flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                    device=dev)
                cold_ms, _ = median_ms(
                    lambda: cuda_kernels.arakawa_rhs_fused(w, s, dx, dy, RE),
                    before=flush.zero_)
                del flush
                plain_ms, plain_call_ms = median_ms(
                    lambda: cuda_kernels.arakawa_rhs_fused_plain(
                        w, s, dx, dy, RE))
                gbs = 3 * w.numel() * w.element_size() / (ms * 1e-3) / 1e9
                b = bound(nbytes(w, s, got), FLOPS_ARAKAWA * w.numel(), ms)
                line += (f"; device time: kernel {ms:.4f} ms warm in L2 "
                         f"({gbs:.0f} GB/s of 3 fields; bound "
                         f"{b['bound_ms']:.4f} ms by {b['bound_by']}, "
                         f"{100 * b['share_of_bound']:.1f}% of it), "
                         f"{cold_ms:.4f} ms with L2 flushed "
                         f"({100 * b['bound_ms'] / cold_ms:.1f}% of the "
                         f"bound) plain {plain_ms:.4f} ms; eager call: "
                         f"kernel {call_ms:.4f} ms plain {plain_call_ms:.4f} "
                         f"ms (medians of 30 calls, CUDA events)")
                records[shape] = {
                    "name": "arakawa_rhs", "route": "cuda",
                    "source": "cfd_julia_torch/csrc/arakawa_rhs.cu",
                    "replaces": "cfd_julia_tpu/ops/pallas_kernels.py:678",
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "cold_ms": cold_ms, "plain_ms": plain_ms, **b,
                    "library_ms": None}
            print(line)
            check(ok, line)
            del w, s, got, again, ref
    record = records[ARAKAWA_TIMED[0]]
    record["at_2048"] = {
        k: v for k, v in records[ARAKAWA_TIMED[1]].items()
        if k in ("launches", "max_abs_err", "ms", "cold_ms", "plain_ms",
                 "bound_ms", "bound_by", "share_of_bound")}
    return record


def bf16_ulp(x):
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def mg_calls(u, f, uc, dx, dy, sweeps=MG_SWEEPS):
    """name -> (kernel call, plain twin call) at `sweeps` sweeps; the
    ascend edge with the residual sum, as on the finest level."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    return {
        "prolong_correct_smooth": (
            lambda: ck.prolong_correct_smooth_fused(u, f, uc, dx, dy,
                                                    sweeps, want_rms=True),
            lambda: ck.prolong_correct_smooth_fused_plain(
                u, f, uc, dx, dy, sweeps, want_rms=True)),
        "smooth_residual_restrict": (
            lambda: ck.smooth_residual_restrict_fused(u, f, dx, dy, sweeps),
            lambda: ck.smooth_residual_restrict_fused_plain(u, f, dx, dy,
                                                            sweeps)),
        "residual_restrict": (
            lambda: ck.residual_restrict_fused(u, f, dx, dy),
            lambda: ck.residual_restrict_fused_plain(u, f, dx, dy)),
        "redblack_sweeps": (
            lambda: ck.redblack_sweeps_fused(u, f, dx, dy, sweeps),
            lambda: ck.redblack_sweeps_fused_plain(u, f, dx, dy, sweeps)),
    }


def mg_work(name, u, f, uc, outs, sweeps):
    """(bytes, flops) a multigrid kernel's call needs: its inputs read once
    and its outputs written once; FLOPS_* a node."""
    n, nc = u.numel(), uc.numel()
    ins = (u, f, uc) if name == "prolong_correct_smooth" else (u, f)
    flops = {
        "prolong_correct_smooth":
            n * (FLOPS_PROLONG + FLOPS_RELAX * sweeps + FLOPS_SQ_RESIDUAL),
        "smooth_residual_restrict":
            n * (FLOPS_RELAX * sweeps + FLOPS_RESIDUAL)
            + nc * FLOPS_RESTRICT,
        "residual_restrict": n * FLOPS_RESIDUAL + nc * FLOPS_RESTRICT,
        "redblack_sweeps": n * FLOPS_RELAX * sweeps,
    }[name]
    return nbytes(*ins, *outs), flops


def compare_outputs(got, ref, dtype):
    """(ok, text, max field error) for a kernel's outputs against its
    twin's.  Fields: 1e-5 of max|twin| in fp32 (FMA contraction and
    operation order), 1e-12 in fp64, one bf16 ulp of max|twin| in bf16
    (both round an fp32 result once).  A residual sum (0-d) is held to
    rel 1e-5 (fp32 sums, fp32 and bf16 fields) or 1e-12 (fp64)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    ok, parts, field_err = True, [], 0.0
    for g, r in zip(got, ref):
        if g.dtype != r.dtype or g.shape != r.shape:
            return False, f"dtype/shape {g.dtype}{tuple(g.shape)} vs " \
                          f"{r.dtype}{tuple(r.shape)}", float("inf")
        err = float((g.double() - r.double()).abs().max())
        scale = float(r.double().abs().max())
        if r.dim() == 0:
            rel = 1e-12 if dtype == torch.float64 else 1e-5
            tol, how = rel * scale, f"{rel:g}*|p|"
            parts.append(f"ssq |k-p|={err:.3e} |p|={scale:.6e} tol={how}")
        else:
            if dtype == torch.bfloat16:
                tol, how = bf16_ulp(scale), "1 bf16 ulp of max|p|"
            else:
                rel = 1e-12 if dtype == torch.float64 else 1e-5
                tol, how = rel * scale, f"{rel:g}*max|p|"
            field_err = max(field_err, err)
            parts.append(f"{tuple(r.shape)} max|k-p|={err:.3e} "
                         f"max|p|={scale:.3e} tol={how}")
        ok = ok and err <= tol
    return ok, "; ".join(parts), field_err


def phase_mg_kernels():
    """Each multigrid kernel vs its twin, and two of its calls against
    each other (bitwise); the level edges at every sweep count of
    edge_sweeps() (the smoother too, and at RB_SHAPES alone).  Returns the
    records at 4097^2 fp32, sweeps 2 (the 4096^2 solve's finest level);
    the smoother's also holds its times at RB_TIMED and an empty
    launch's."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    k = ck.edge_sweeps_per_pass()
    # K+2 runs two passes, 2K+1 three (the work buffer's ping-pong)
    edge_sweeps = [0, 1, MG_SWEEPS, k + 2, 2 * k + 1]
    print(f"phase 2 multigrid: level edges run K={k} sweeps a pass; they "
          f"and the smoother held at sweeps {edge_sweeps}, the other kernel "
          f"at {MG_SWEEPS}")
    records, small = {}, {}
    big = (MG_NX + 1, MG_NX + 1)
    for shape in [big, *MG_SHAPES, *RB_SHAPES]:
        rng = np.random.default_rng(shape[0] * 7919 + shape[1])
        coarse = ((shape[0] - 1) // 2 + 1, (shape[1] - 1) // 2 + 1)
        arrays = [rng.standard_normal(shape), rng.standard_normal(shape),
                  rng.standard_normal(coarse)]
        dx, dy = 1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1)
        dtypes = [torch.float32] if shape == big else \
            [torch.float32, torch.float64, torch.bfloat16]
        for dtype in dtypes:
            u, f, uc = (torch.as_tensor(a, device=dev).to(dtype)
                        for a in arrays)
            names = ["redblack_sweeps"] if shape in RB_SHAPES else MG_KERNELS
            for name in names:
                results = []
                for sweeps in edge_sweeps if name in MG_SWEPT \
                        else [MG_SWEEPS]:
                    kernel, plain = mg_calls(u, f, uc, dx, dy, sweeps)[name]
                    got, again, ref = kernel(), kernel(), plain()
                    torch.cuda.synchronize()
                    got = got if isinstance(got, tuple) else (got,)
                    again = again if isinstance(again, tuple) else (again,)
                    ok, text, err = compare_outputs(got, ref, dtype)
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    results.append((sweeps, ok and same, text, err, same))
                    if shape == big and sweeps == MG_SWEEPS:
                        records[name], timed = mg_record(
                            name, kernel, plain, got, u, f, uc, err)
                bad = [r for r in results if not r[1]]
                worst = bad[0] if bad else max(results, key=lambda r: r[3])
                line = (f"phase 2 kernel {name} {shape[0]}x{shape[1]} "
                        f"{str(dtype)[6:]} sweeps "
                        f"{[r[0] for r in results]}: "
                        f"{'FAIL at' if bad else 'worst'} sweeps {worst[0]}: "
                        f"{worst[2]}; two calls bitwise equal: "
                        f"{all(r[4] for r in results)} "
                        f"{'FAIL' if bad else 'ok'}")
                if shape == big:
                    line += "; " + timed
                print(line)
                check(not bad, line)
                if shape in RB_TIMED and dtype == torch.float32:
                    small[shape] = median_ms(
                        mg_calls(u, f, uc, dx, dy)["redblack_sweeps"][0])[0]
            del u, f, uc
    floor_ms, _ = median_ms(lambda: torch.cuda._sleep(0))
    rb = records["redblack_sweeps"]
    rb["small_ms"] = {f"{r}x{c}": t for (r, c), t in small.items()}
    rb["floor_ms"] = floor_ms
    print(f"phase 2 kernel redblack_sweeps fp32 sweeps {MG_SWEEPS}: device "
          f"time " + ", ".join(f"{key} {t:.4f} ms"
                               for key, t in rb["small_ms"].items())
          + f"; an empty launch {floor_ms:.4f} ms (medians of 30 calls, "
          f"CUDA events)")
    return records


def mg_record(name, kernel, plain, got, u, f, uc, err):
    """The timed record of a multigrid kernel at MG_SWEEPS, with its
    bound, and a line of its times."""
    ms, call_ms = median_ms(kernel)
    plain_ms, plain_call_ms = median_ms(plain)
    b = bound(*mg_work(name, u, f, uc, got, MG_SWEEPS), ms)
    text = (f"device time: kernel {ms:.4f} ms (bound {b['bound_ms']:.4f} ms "
            f"by {b['bound_by']}: {100 * b['share_of_bound']:.1f}% of it) "
            f"plain {plain_ms:.4f} ms; eager call: kernel {call_ms:.4f} ms "
            f"plain {plain_call_ms:.4f} ms (medians of 30 calls, CUDA "
            f"events)")
    return {"name": name, "route": "cuda",
            "source": "cfd_julia_torch/csrc/multigrid.cu",
            "replaces": MG_KERNELS[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}, text


def anchor_check(psi, total_steps, label="phase 3 cavity"):
    anchor = json.loads(ANCHORS.read_text())[f"cavity:{NX}:{total_steps}"]
    psi = psi.double()
    got = {"psi_min": float(psi.min()),
           "psi_l2": float(torch.sqrt(torch.mean(psi ** 2)))}
    tol = anchor["rel_tol"]
    rels = {k: abs(got[k] - anchor[k]) / abs(anchor[k]) for k in got}
    line = (f"{label} {NX}^2 @{total_steps} steps: " + " ".join(
        f"{k}={got[k]:.9g} (anchor {anchor[k]:.9g}, rel {rels[k]:.2e})"
        for k in got) + f" tol {tol:g}")
    print(line)
    check(all(r <= tol for r in rels.values()), line)


def phase_main_path(poisson="auto", label="phase 3 cavity"):
    """The headline cavity on the port's default path: rhs_impl="auto"
    resolves to the CUDA kernel on a GPU; `poisson` names the Poisson
    solve (auto: the sine matmuls).  Returns the launch counts, the step,
    the final state and the seconds a step."""
    from cfd_julia_torch.models import cavity
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import loop

    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                              poisson=poisson)
    step = cavity.make_step_fn(cfg, torch.float32, "cuda")
    state = cavity.initial_state(cfg, torch.float32, "cuda")

    cuda_kernels.reset_launch_counts()
    state, rms_a = loop.run_steps(step, state, STEPS_FIRST)
    torch.cuda.synchronize()
    anchor_check(state[1], STEPS_FIRST, label)
    n = STEPS_TOTAL - STEPS_FIRST
    t0 = time.perf_counter()
    state, rms_b = loop.run_steps(step, state, n)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)

    anchor_check(state[1], STEPS_TOTAL, label)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state[0], state[1], rms_a, rms_b))
    check(finite, "cavity fields or rms history not finite")
    print(f"{label} {NX}^2 fp32: {n} steps (from step {STEPS_FIRST}) "
          f"in {seconds:.4f} s = {n / seconds:.2f} steps/s; "
          f"launches {launches}; fields finite")
    check(launches["arakawa_rhs"] == 3 * STEPS_TOTAL,
          f"arakawa_rhs launched {launches['arakawa_rhs']} times, expected "
          f"3 x {STEPS_TOTAL} = {3 * STEPS_TOTAL}")
    return launches, step, state, seconds / n


def phase_profile(label, run, units, unit_s, unit="step"):
    """Device time by kernel over a short steady window (torch.profiler):
    run() does `units` units of work; the busy share is taken against the
    unprofiled time of one unit, unit_s.  A first run() under the profiler
    is its warm-up and is not recorded (without it the trace can miss the
    window's first kernels); the kernels' launch counts restart after it,
    so they count the recorded run alone."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from cfd_julia_torch.ops import cuda_kernels

    events = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    # device events, less the profiler's own step span
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    if not kernels:
        print("profile: no device events recorded (device time not measured)")
        return
    by_name, spans = {}, []
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    total = sum(v[0] for v in by_name.values())
    print(f"profile {label} {units} {unit}s: device busy {busy / units:.1f} "
          f"us/{unit} = {100 * busy / units / (unit_s * 1e6):.1f}% of the "
          f"unprofiled {unit_s * 1e6:.1f} us/{unit}; profiled host wall "
          f"{wall_us / units:.1f} us/{unit}, busy {100 * busy / span:.1f}% "
          f"of the kernels' span; {len(kernels) / units:.1f} kernels/{unit}")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"profile   {100 * us / total:5.1f}%  {us / units:8.2f} "
              f"us/{unit} {count / units:6.1f}/{unit}  {name[:110]}")
    return by_name


# the smoother's kernels
RB_KERNELS = ("rb_level_kernel", "rb_tile_kernel")


def kernel_sums(by_name, *names):
    """(device us, launches) of the profile's kernels named `names`."""
    hits = [v for name, v in by_name.items()
            if any(f"{n}<" in name for n in names)]
    return sum(us for us, _ in hits), sum(count for _, count in hits)


def profile_smoother(by_name, calls, solves, label):
    """The smoother's device launches against its wrapper calls (one each:
    every call of the solve has MG_SWEEPS <= K sweeps), and its share of
    the solve's device time; a line, and whether the counts hold."""
    us, n = kernel_sums(by_name, *RB_KERNELS)
    total = sum(v[0] for v in by_name.values())
    n_rb = calls["redblack_sweeps"]
    line = (f"smoother {us / solves:.2f} us/solve ({100 * us / total:.1f}% "
            f"of the {label} solve's {total / solves:.1f} us of device time) "
            f"in {n} launches / {n_rb} calls = {n / max(n_rb, 1):.3f} a "
            f"call")
    return line, n == n_rb and n_rb > 0


def profile_edges(by_name, calls, solves):
    """Device launches a solve, a level edge and a smoother call, from the
    profile's kernels and the wrappers' calls over the same solves; fails
    unless a descend edge is one launch, an ascend edge at most two, a
    smoother call one, and kernel 4's restrict_kernel stays out of the
    fused solve."""
    down = kernel_sums(by_name, "smooth_restrict_tile_kernel")[1]
    up = kernel_sums(by_name, "sweep_tile_kernel", "sum_kernel")[1]
    n_sum = kernel_sums(by_name, "sum_kernel")[1]
    n_restrict = kernel_sums(by_name, "restrict_kernel")[1]
    n_down = calls["smooth_residual_restrict"]
    n_up = calls["prolong_correct_smooth"]
    rb_line, rb_ok = profile_smoother(by_name, calls, solves, "fused")
    line = (f"profile multigrid {MG_NX}^2 edges: "
            f"{sum(c for _, c in by_name.values()) / solves:.1f} device "
            f"launches a solve; descend edge {down} launches / {n_down} "
            f"calls = {down / max(n_down, 1):.3f} a call; ascend edge {up} "
            f"launches (sum_kernel {n_sum}) / {n_up} calls"
            f" = {up / max(n_up, 1):.3f} a call; restrict_kernel "
            f"{n_restrict}; {rb_line} (kernel 5, coarsest level)")
    ok = (down == n_down and n_up <= up <= 2 * n_up and not n_restrict
          and rb_ok)
    print(line + (" ok" if ok else " FAIL"))
    check(ok, line)


def profile_off(by_name, calls, solves):
    """fused="off": every smoother call one device launch, and no level
    edge kernel in the solve."""
    rb_line, ok = profile_smoother(by_name, calls, solves, "off")
    edges = kernel_sums(by_name, "smooth_restrict_tile_kernel",
                        "sweep_tile_kernel", "restrict_kernel")[1]
    line = (f"profile multigrid {MG_NX}^2 off: {rb_line}; level-edge "
            f"launches {edges}")
    ok = ok and not edges
    print(line + (" ok" if ok else " FAIL"))
    check(ok, line)


def profile_rhs(by_name, kernel, steps):
    """Fails unless the profile shows the RHS kernel `kernel` launched
    three times a step: one __global__ launch a wrapper call, three calls a
    step."""
    n = sum(count for name, (_, count) in by_name.items()
            if f"{kernel}<" in name)
    line = (f"profile {kernel}: {n} device launches in {steps} steps = "
            f"{n / steps:.2f} a step (want 3)")
    print(line + (" ok" if n == 3 * steps else " FAIL"))
    check(n == 3 * steps, line)


def cli_run(preset, timeout=900):
    """`python -m cfd_julia_torch run <preset> --device cuda` into a
    temporary directory: its metrics, {file name: text} of what it wrote,
    and the process's seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "cfd_julia_torch", "run",
                        preset, "--device", "cuda", "--outdir", tmp],
                       cwd=REPO, check=True, capture_output=True, text=True,
                       timeout=timeout)
        seconds = time.perf_counter() - t0
        files = {p.name: p.read_text() for p in Path(tmp).iterdir()}
    check("metrics.json" in files, f"CLI run {preset} wrote no metrics.json")
    metrics = json.loads(files["metrics.json"])
    check(metrics["device"] == torch.cuda.get_device_name(),
          f"CLI run {preset} ran on {metrics['device']}")
    return metrics, files, seconds


def columns(files, name, skiprows=0):
    """The numeric columns of a text file a CLI run wrote."""
    check(name in files, f"CLI run wrote no {name}: {sorted(files)}")
    return np.loadtxt(files[name].splitlines(), skiprows=skiprows)


def phase_cli():
    metrics, files, seconds = cli_run("cavity")
    for name in ("res_plot.txt", "field_final.txt"):
        check(name in files, f"CLI run wrote no {name}")
    y, u, x, v = columns(files, "centerlines.txt", skiprows=1).T
    du = float(np.abs(np.interp(GHIA_Y, y, u) - GHIA_U).max())
    dv = float(np.abs(np.interp(GHIA_X, x, v) - GHIA_V).max())
    dpsi = abs(metrics["psi_min"] - (-0.103423))
    ok = (metrics["steady_rms"] < 1e-6 and du < 0.01 and dv < 0.01
          and dpsi < 2e-3)
    line = (f"phase 4 cli `python -m cfd_julia_torch run cavity --device cuda`"
            f" (64^2, Re=100, t=10) on {metrics['device']}: steady_rms="
            f"{metrics['steady_rms']:.3e} max|u-ghia|={du:.4f} "
            f"max|v-ghia|={dv:.4f} psi_min={metrics['psi_min']:.6f} "
            f"(ghia -0.103423); solve {metrics['wall_time_s']:.2f} s, "
            f"process {seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def expected_launches(n_levels, cycles, fused, fmg):
    """Wrapper calls the pyramid implies: a fused V-cycle over m levels
    calls each edge kernel m-1 times and the smoother once (coarsest); an
    unfused one calls the smoother 2(m-1)+1 times.  FMG restricts its
    right-hand side down n-1 edges (fused), smooths the coarsest level,
    and runs one V-cycle of each sub-pyramid on the way up."""
    e = dict.fromkeys(MG_KERNELS, 0)

    def v_cycle(m):
        if fused:
            e["smooth_residual_restrict"] += m - 1
            e["prolong_correct_smooth"] += m - 1
            e["redblack_sweeps"] += 1
        else:
            e["redblack_sweeps"] += 2 * (m - 1) + 1

    if fmg:
        e["residual_restrict"] += n_levels - 1 if fused else 0
        e["redblack_sweeps"] += 1
        for k in range(n_levels - 2, -1, -1):
            v_cycle(n_levels - k)
    for _ in range(cycles):
        v_cycle(n_levels)
    return e


def recheck_rel(u, f, u0, dx, dy):
    """Independent fp64 residual rms(u)/rms(u0) with plain slices, not
    the solver's own residual path, so a V-cycle that mis-tracks its rms
    cannot certify itself."""
    f64 = f.double()

    def rms(v):
        v = v.double()
        lap = ((v[2:, 1:-1] - 2 * v[1:-1, 1:-1] + v[:-2, 1:-1]) / dx**2
               + (v[1:-1, 2:] - 2 * v[1:-1, 1:-1] + v[1:-1, :-2]) / dy**2)
        return float(torch.sqrt(torch.mean((f64[1:-1, 1:-1] - lap) ** 2)))

    return rms(u) / max(rms(u0), 1e-30)


MG_VARIANTS = [("fused", {}), ("fmg", {"fmg": True}),
               ("mixed", {"cycle_dtype": "mixed"}), ("off", {"fused": "off"})]


def phase_multigrid():
    """The 4096^2 multigrid solve and its variants on the port's default
    path (impl="auto" resolves to the CUDA kernels).  Returns
    {variant: launch counts} and {variant: (a callable of one solve, its
    best time)}.  Prints mixed's max|u - ue| over the fused fp32 solve's
    as information: the JAX package breaks the 1.5x contract there too
    (at 1024^2 on the CPU), so it belongs to the bf16 pyramid, and the
    gate holds mixed to its own twin."""
    import dataclasses

    from cfd_julia_torch.models import poisson2d
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.poisson import multigrid

    cfg = poisson2d.PoissonConfig(nx=MG_NX, ny=MG_NX, solver="multigrid",
                                  problem="poly")
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, torch.float32, "cuda")
    u0 = poisson2d._dirichlet_init(ue)
    n_levels = len(multigrid._build_levels(MG_NX, MG_NX, cfg.dx, cfg.dy, 0))
    counts, solves, errs = {}, {}, {}
    for variant, opts in MG_VARIANTS:
        mgc = multigrid.MGConfig(tol=MG_TOL, max_cycles=20, **opts)

        def solve(mgc=mgc):
            return multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)

        cuda_kernels.reset_launch_counts()
        res = solve()
        torch.cuda.synchronize()
        launches = dict(cuda_kernels.LAUNCHES)
        twin = multigrid.solve(f, u0, cfg.dx, cfg.dy,
                               cfg=dataclasses.replace(mgc, impl="torch"))
        torch.cuda.synchronize()
        check(cuda_kernels.LAUNCHES == launches,
              f"the twin solve launched kernels: {cuda_kernels.LAUNCHES}")
        times = []
        solve()                                       # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)

        rel = float(res.rms / res.rms0)
        rel_ind = recheck_rel(res.u, f, u0, cfg.dx, cfg.dy)
        err = float((res.u - ue).abs().max())
        twin_err = float((twin.u - ue).abs().max())
        fused = variant != "off"
        want = expected_launches(n_levels, res.iterations, fused,
                                 variant == "fmg")
        for name in cuda_kernels.LAUNCHES:   # every non-multigrid kernel
            want.setdefault(name, 0)
        finite = bool(torch.isfinite(res.u).all())
        ok = (rel <= MG_TOL and rel_ind <= 4 * MG_TOL and finite
              and res.u.dtype == torch.float32
              and abs(res.iterations - twin.iterations) <= 1
              and err <= 1.5 * twin_err and launches == want)
        line = (f"phase 5 multigrid {MG_NX}^2 poly fp32 {variant}: "
                f"{res.iterations} cycles (twin {twin.iterations}, tol +-1) "
                f"rms/rms0={rel:.3e} (tol {MG_TOL:g}) fp64 recheck "
                f"{rel_ind:.3e} (tol {4 * MG_TOL:g}); max|u-ue|={err:.3e} "
                f"(twin {twin_err:.3e}, tol 1.5x); {best:.6f} s/solve best "
                f"of 3 [{', '.join(f'{t:.6f}' for t in times)}] = "
                f"{1e3 * best / max(res.iterations, 1):.4f} ms/cycle; "
                f"launches {launches} (pyramid of {n_levels} levels: "
                f"{want}) {'ok' if ok else 'FAIL'}")
        errs[variant] = err
        if variant == "mixed":
            line += (f"; mixed max|u-ue| over fused fp32's "
                     f"{err / errs['fused']:.3f}x (information, not a gate)")
        print(line)
        check(ok, line)
        counts[variant] = launches
        solves[variant] = (solve, best)
    return counts, solves


def phase_cli_poisson():
    metrics, files, seconds = cli_run("poisson_mgN")
    for name in ("output.txt", "multigrid_residual.txt"):
        check(name in files, f"CLI run wrote no {name}")
    cols = columns(files, "field_final.txt")
    # columns x y f u ue; 100 fp32 cycles reach the fp32 floor (~2e-7 on
    # the CPU); 1e-5 is the error a 1e-5-tolerance solve leaves
    err = float(np.abs(cols[:, 3] - cols[:, 4]).max())
    ok = (cols.shape == (513 * 513, 5) and err < 1e-5
          and abs(err - metrics["linf_error"]) <= 1e-7)
    line = (f"phase 6 cli `python -m cfd_julia_torch run poisson_mgN "
            f"--device cuda` (512^2, 9 levels, tol 1e-9, 100 cycles at "
            f"most) on {metrics['device']}: {metrics['iterations']} cycles, "
            f"rms {metrics['rms_final']:.3e}, max|u-ue|={err:.3e} (tol "
            f"1e-5); solve {metrics['wall_time_s']:.2f} s, process "
            f"{seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def euler_dt(nx):
    return 1e-4 * 256 / nx


def euler_steps(step, q, n):
    for _ in range(n):
        q = step(q)
    return q


def euler_sod_100(nx):
    """The Sod state after 100 fp64 hllc steps on the twin, (3, nx)."""
    from cfd_julia_torch.models import euler1d
    from cfd_julia_torch.stepping import ssprk3

    cfg = euler1d.EulerConfig(nx=nx, solver="hllc", dt=euler_dt(nx),
                              rhs_impl="torch")
    _, q = euler1d.sod_initial_state(cfg, torch.float64, "cuda")
    rhs = euler1d.make_rhs(cfg, "cuda")
    return euler_steps(lambda v: ssprk3.ssprk3_step(rhs, v, cfg.dt), q, 100)


def euler_random(nx, gamma=1.4):
    """Seeded physical cells: rho, p in [0.1, 2], u in [-1.5, 1.5]."""
    rng = np.random.default_rng(nx)
    rho = rng.uniform(0.1, 2.0, nx)
    u = rng.uniform(-1.5, 1.5, nx)
    p = rng.uniform(0.1, 2.0, nx)
    q = np.stack([rho, rho * u, p / (gamma - 1) + 0.5 * rho * u**2])
    return torch.as_tensor(q, dtype=torch.float64, device="cuda")


def euler_tile_cells():
    """Cells a block of the Euler kernel owns (kCells, csrc/euler_rhs.cu)."""
    src = (REPO / "cfd_julia_torch" / "csrc" / "euler_rhs.cu").read_text()
    return int(re.search(r"constexpr int kCells = (\d+);", src).group(1))


def phase_euler_kernels():
    """euler_rhs vs its twin, and two calls bitwise equal, at the main
    path's nx and at nx = 3, 4, 5 and a block's cells - 1, + 0, + 1 (the
    mirror ghosts and the interfaces on block edges); returns the record at
    (3, 8192) fp32 hllc, with the empty-launch floor beside it.

    Tolerance: 1e-12 of max|twin| in fp64.  In fp32, 1e-5 of max|twin|,
    or 4x the fp32 twin's own error against the fp64 twin where that is
    larger: WENO-5 of random cells reconstructs interface states with
    rho < 0 and p < 0, where the flux amplifies roundoff, so any two fp32
    evaluations differ by that much (the kernel, with FMA contraction,
    came to 2.6x of it at 3x257 roe on the H100)."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    gamma, record = 1.4, None
    tile = euler_tile_cells()
    for nx in dict.fromkeys((8192, 257, 5, 3, 4, tile - 1, tile, tile + 1)):
        dx = 1.0 / nx
        inputs = {"random": euler_random(nx), "sod100": euler_sod_100(nx)}
        if not bool(torch.isfinite(inputs["sod100"]).all()):
            # 100 steps of Sod on 3 cells do not stay finite (the twin
            # on the CPU alike): random cells only there
            print(f"phase 2 kernel euler_rhs 3x{nx}: the Sod state after "
                  f"100 steps is not finite; random cells only")
            del inputs["sod100"]
        for label, q64 in inputs.items():
            for solver, ws in EULER_VARIANTS:
                exact = ck.euler_rhs_fused_plain(q64, gamma, dx, solver, ws)
                for dtype in (torch.float32, torch.float64):
                    q = q64.to(dtype).contiguous()
                    before = ck.LAUNCHES["euler_rhs"]
                    got = ck.euler_rhs_fused(q, gamma, dx, solver, ws)
                    again = ck.euler_rhs_fused(q, gamma, dx, solver, ws)
                    ref = ck.euler_rhs_fused_plain(q, gamma, dx, solver, ws)
                    torch.cuda.synchronize()
                    same = torch.equal(got, again)
                    err = float((got.double() - ref.double()).abs().max())
                    scale = float(ref.double().abs().max())
                    if dtype == torch.float64:
                        tol, how = 1e-12 * scale, "1e-12*max|p|"
                    else:
                        e32 = float((ref.double() - exact).abs().max())
                        tol = max(1e-5 * scale, 4 * e32)
                        how = (f"max(1e-5*max|p|, 4*{e32:.3e} = fp32 twin's "
                               f"error vs fp64)")
                    ok = (err <= tol and got.dtype == dtype and same
                          and ck.LAUNCHES["euler_rhs"] == before + 2)
                    line = (f"phase 2 kernel euler_rhs 3x{nx} "
                            f"{str(dtype)[6:]} {solver}/{ws} {label}: "
                            f"max|k-p|={err:.3e} max|p|={scale:.3e} "
                            f"({err / scale:.2e} of it) tol={how}; two "
                            f"calls bitwise equal: {same} "
                            f"{'ok' if ok else 'FAIL'}")
                    timed = (nx == 8192 and dtype == torch.float32
                             and solver == "hllc" and label == "sod100")
                    if timed:
                        ms, call_ms = median_ms(
                            lambda: ck.euler_rhs_fused(q, gamma, dx, solver))
                        plain_ms, plain_call_ms = median_ms(
                            lambda: ck.euler_rhs_fused_plain(q, gamma, dx,
                                                             solver))
                        floor_ms, _ = median_ms(
                            lambda: torch.cuda._sleep(0))
                        b = bound(nbytes(q, got),
                                  FLOPS_EULER_INTERFACE * (nx + 1), ms)
                        line += (f"; device time: kernel {ms:.4f} ms (bound "
                                 f"{b['bound_ms']:.6f} ms by {b['bound_by']}"
                                 f"; an empty launch {floor_ms:.4f} ms) "
                                 f"plain {plain_ms:.4f} ms; eager call: "
                                 f"kernel {call_ms:.4f} ms plain "
                                 f"{plain_call_ms:.4f} ms (medians of 30 "
                                 f"calls, CUDA events)")
                        record = {
                            "name": "euler_rhs", "route": "cuda",
                            "source": "cfd_julia_torch/csrc/euler_rhs.cu",
                            "replaces":
                                "cfd_julia_tpu/ops/pallas_kernels.py:749",
                            "launches": None, "max_abs_err": err, "ms": ms,
                            "floor_ms": floor_ms, "plain_ms": plain_ms, **b,
                            "library_ms": None}
                    print(line)
                    check(ok, line)
    return record


def euler_anchor_check(q, solver, nx):
    anchor = json.loads(ANCHORS.read_text())[
        f"euler_{solver}:{nx}:{EULER_STEPS}"]
    rho = q[0].double()
    got = {"rho_min": float(rho.min()),
           "rho_l2": float(torch.sqrt(torch.mean(rho ** 2)))}
    tol = anchor["rel_tol"]
    rels = {k: abs(got[k] - anchor[k]) / abs(anchor[k]) for k in got}
    text = " ".join(f"{k}={got[k]:.9g} (anchor {anchor[k]:.9g}, rel "
                    f"{rels[k]:.2e})" for k in got) + f" tol {tol:g}"
    return all(r <= tol for r in rels.values()), text


# max|q_kernel - q_twin| after the 2000 fp32 steps: two fp32 evaluations
# of one scheme differ by roundoff that the shock-capturing amplifies
# near the discontinuities; the fp32 twin run stays within 3.3e-5 of the
# fp64 twin run on the CPU for all three configs, the bound leaves 6x
EULER_TWIN_TOL = 2e-4


def phase_euler():
    """The three anchored Euler runs on the port's default path
    (rhs_impl="auto": the CUDA kernel), each against the same run on the
    twin.  Returns {(solver, nx): launches}, the hllc 8192 step and state,
    and its seconds per step."""
    import dataclasses

    from cfd_julia_torch.models import euler1d
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import ssprk3

    counts, main = {}, None
    for solver, nx in EULER_RUNS:
        cfg = euler1d.EulerConfig(nx=nx, solver=solver, dt=euler_dt(nx))
        _, q0 = euler1d.sod_initial_state(cfg, torch.float32, "cuda")
        results = {}
        for impl in ("auto", "torch"):
            rhs = euler1d.make_rhs(dataclasses.replace(cfg, rhs_impl=impl),
                                   "cuda")

            def step(q, rhs=rhs):
                return ssprk3.ssprk3_step(rhs, q, cfg.dt)

            torch.cuda.synchronize()
            cuda_kernels.reset_launch_counts()
            t0 = time.perf_counter()
            q = euler_steps(step, q0, EULER_STEPS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            results[impl] = (q, seconds, dict(cuda_kernels.LAUNCHES), step)
        q, seconds, launches, step = results["auto"]
        q_twin, twin_s, twin_launches, _ = results["torch"]
        ok, text = euler_anchor_check(q, solver, nx)
        diff = float((q - q_twin).abs().max())
        finite = bool(torch.isfinite(q).all())
        want = dict.fromkeys(launches, 0)
        want["euler_rhs"] = 3 * EULER_STEPS
        ok = (ok and finite and q.dtype == torch.float32
              and launches == want and not any(twin_launches.values())
              and diff <= EULER_TWIN_TOL)
        line = (f"phase 7 euler {solver} {nx} fp32 @{EULER_STEPS} steps "
                f"(dt={cfg.dt:g}): {text}; max|q-q_twin|={diff:.3e} (tol "
                f"{EULER_TWIN_TOL:g}); {EULER_STEPS / seconds:.2f} steps/s "
                f"(twin {EULER_STEPS / twin_s:.2f}); launches "
                f"{launches['euler_rhs']} euler_rhs (want "
                f"{want['euler_rhs']}), all kernels "
                f"{sum(launches.values())}, twin run "
                f"{sum(twin_launches.values())}; fields "
                f"{'finite' if finite else 'NOT finite'} "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
        counts[(solver, nx)] = launches
        if (solver, nx) == EULER_RUNS[0]:
            main = (step, q, seconds / EULER_STEPS)
    return counts, main


def phase_cli_euler():
    metrics, files, seconds = cli_run("euler_hllc")
    for name in ("solution_v.txt", "solution_e.txt"):
        check(name in files, f"CLI run wrote no {name}")
    cols = columns(files, "solution_d.txt")
    # columns: x, then the density after 200, 400, ..., 4000 steps
    x, rho = cols[:, 0], cols[:, -1]
    rho_e, _, _ = exact_sod(x, 0.2)
    l1 = float(np.abs(rho - rho_e).mean())
    ok = (cols.shape == (8192, 21) and np.isfinite(cols).all() and l1 < 3e-4
          and metrics["p_min"] > 0)
    line = (f"phase 8 cli `python -m cfd_julia_torch run euler_hllc --device "
            f"cuda` (8192 cells, dt=5e-5, t=0.2, 4000 steps) on "
            f"{metrics['device']}: density L1 vs exact Sod {l1:.3e} (tol "
            f"3e-4), rho_min={metrics['rho_min']:.6f} "
            f"p_min={metrics['p_min']:.6f}; solve {metrics['wall_time_s']:.2f}"
            f" s, process {seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def vortex_anchor_check(w, solver):
    anchor = json.loads(ANCHORS.read_text())[
        f"{solver}:{VORTEX_NX}:{VORTEX_TOTAL}"]
    got = {"wmax": float(w.abs().max()), "enstrophy": float((w ** 2).sum())}
    tol = anchor["rel_tol"]
    rels = {k: abs(got[k] - anchor[k]) / abs(anchor[k]) for k in got}
    text = " ".join(f"{k}={got[k]:.9g} (anchor {anchor[k]:.9g}, rel "
                    f"{rels[k]:.2e})" for k in got) + f" tol {tol:g}"
    return all(r <= tol for r in rels.values()), text


def vortex_run(cfg, n_first, n_total):
    """n_first steps from the two-Gaussian state (the warm-up: cuFFT plans
    its transforms there), then on to n_total between synchronisations.
    Returns the final vorticity, the timed steps' seconds, the step and
    its state."""
    from cfd_julia_torch.models import vortex

    step = vortex.make_step(cfg, torch.float32, "cuda")
    w0 = vortex.initial_vorticity(cfg, torch.float32, "cuda")
    spectral = cfg.solver != "fdm"
    state = vortex.half_init(w0) if spectral else w0
    del w0
    for _ in range(n_first):
        state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_total - n_first):
        state = step(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    w = vortex.half_decode(state, cfg.nx, cfg.ny) if spectral else state
    return w, seconds, step, state


def phase_vortex():
    """The four anchored vortex-merger runs at 2048^2 on the port's default
    path.  Returns fdm's launch counts and {solver: (step, state, seconds a
    step)}."""
    import dataclasses

    from cfd_julia_torch.models import vortex
    from cfd_julia_torch.ops import cuda_kernels

    n = VORTEX_TOTAL - VORTEX_FIRST
    steps, fdm_launches = {}, None
    for solver in VORTEX_SOLVERS:
        cfg = vortex.VortexConfig(nx=VORTEX_NX, ny=VORTEX_NX, solver=solver,
                                  dt=1e-3, re=1000.0)
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        w, seconds, step, state = vortex_run(cfg, VORTEX_FIRST, VORTEX_TOTAL)
        launches = dict(cuda_kernels.LAUNCHES)
        ok, text = vortex_anchor_check(w, solver)
        finite = bool(torch.isfinite(w).all())
        want = dict.fromkeys(launches, 0)
        if solver == "fdm":
            want["arakawa_rhs"] = 3 * VORTEX_TOTAL
        ok = (ok and finite and w.dtype == torch.float32
              and w.shape == (VORTEX_NX, VORTEX_NX) and launches == want)
        line = (f"phase 9 vortex {solver} {VORTEX_NX}^2 fp32 @{VORTEX_TOTAL} "
                f"steps (dt=1e-3, Re=1000): {text}; {n} steps (from step "
                f"{VORTEX_FIRST}) in {seconds:.4f} s = {n / seconds:.2f} "
                f"steps/s; launches {launches['arakawa_rhs']} arakawa_rhs "
                f"(want {want['arakawa_rhs']}), all kernels "
                f"{sum(launches.values())}; fields "
                f"{'finite' if finite else 'NOT finite'}")
        if solver == "fdm":
            fdm_launches = launches
            w_twin, twin_s, _, _ = vortex_run(
                dataclasses.replace(cfg, rhs_impl="torch"), VORTEX_FIRST,
                VORTEX_TOTAL)
            diff = float((w - w_twin).abs().max())
            twin_quiet = cuda_kernels.LAUNCHES == launches
            ok = ok and diff <= VORTEX_TWIN_TOL and twin_quiet
            line += (f"; max|w-w_twin|={diff:.3e} (tol {VORTEX_TWIN_TOL:g}), "
                     f"twin {n / twin_s:.2f} steps/s and "
                     f"{'no' if twin_quiet else 'SOME'} kernel launches")
            del w_twin
        line += " ok" if ok else " FAIL"
        print(line)
        check(ok, line)
        steps[solver] = (step, state, seconds / n)
        del w
    return fdm_launches, steps


def phase_cli_spectral():
    """The spectral slice's presets through the CLI on the GPU."""
    # tgv: fdm at 64^2, Re=10, t=1; the bound of the JAX package's own
    # test of this run (second-order in space)
    m, files, seconds = cli_run("tgv")
    ok = (m["l2_error"] < 8e-3 and "output.txt" in files
          and "vm1.txt" in files)
    line = (f"phase 10 cli `run tgv --device cuda` (64^2, Re=10, t=1, fdm): "
            f"L2 error vs the analytic decay {m['l2_error']:.4e} (tol 8e-3), "
            f"max {m['linf_error']:.4e}; solve {m['wall_time_s']:.2f} s, "
            f"process {seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # vortex_merger_ps23: 128^2, dt=0.01, t=20: 10 snapshot files after the
    # initial state; the half spectrum's mean mode is projected out, and
    # viscosity can only lower the enstrophy
    m, files, seconds = cli_run("vortex_merger_ps23")
    names = [f"vm{k}.txt" for k in range(1, 11)]
    check("vm11.txt" not in files,
          f"CLI run vortex_merger_ps23 wrote {sorted(files)}")
    means, enstrophies = [], []
    for n in names:
        cols = columns(files, n)
        check(cols.shape == (129 * 129, 3), f"{n} has shape {cols.shape}")
        w = cols[:, 2].reshape(129, 129)[:-1, :-1]      # unique nodes
        means.append(abs(float(w.mean())))
        enstrophies.append(float((w ** 2).sum()))
    falling = all(b < a for a, b in zip(enstrophies, enstrophies[1:]))
    ok = (max(means) < 1e-5 and falling and np.isfinite(enstrophies).all()
          and 0.5 < m["wmax_final"] < 1.0)
    line = (f"phase 10 cli `run vortex_merger_ps23 --device cuda` (128^2, "
            f"Re=1000, t=20, 2000 steps): 10 snapshots + the initial state, "
            f"max |mean w| {max(means):.3e} (tol 1e-5), enstrophy "
            f"{enstrophies[0]:.4f} -> {enstrophies[-1]:.4f} "
            f"{'falling at every snapshot' if falling else 'NOT falling'}, "
            f"wmax_final {m['wmax_final']:.6f}; solve "
            f"{m['wall_time_s']:.2f} s, process {seconds:.2f} s "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # the direct Poisson solves on sine32: fst is second order (max error
    # 4.06e-4 at 128^2 in fp64), fft_spectral exact up to fp32 roundoff
    for preset, n, tol in (("poisson_fst", 128, 5e-4),
                           ("poisson_fft_spectral", 512, 5e-6)):
        m, files, seconds = cli_run(preset)
        check(f"output_{n}.txt" in files,
              f"CLI run {preset} wrote {sorted(files)}")
        cols = columns(files, "field_final.txt")
        # columns x y f u ue
        err = float(np.abs(cols[:, 3] - cols[:, 4]).max())
        ok = (cols.shape == ((n + 1) ** 2, 5) and err < tol
              and abs(err - m["linf_error"]) <= 1e-7 and "iterations" not in m)
        line = (f"phase 10 cli `run {preset} --device cuda` ({n}^2, sine32): "
                f"max|u-ue|={err:.3e} (tol {tol:g}), L2 {m['l2_error']:.3e}; "
                f"solve {m['wall_time_s']:.2f} s, process {seconds:.2f} s "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)


def profile_transforms(by_name, label, steps):
    """The profile's device time in cuFFT's kernels, in kernel 1 and in
    everything else (PyTorch's elementwise and copy kernels)."""
    total = sum(us for us, _ in by_name.values())
    fft = [v for name, v in by_name.items()
           if "fft" in name.lower() or "dpRadix" in name]
    fft_us, fft_n = sum(us for us, _ in fft), sum(c for _, c in fft)
    k1_us, k1_n = kernel_sums(by_name, "arakawa_rhs_kernel")
    rest_n = sum(c for _, c in by_name.values()) - fft_n - k1_n
    print(f"profile {label}: cuFFT {fft_us / steps:.1f} us/step "
          f"({100 * fft_us / total:.1f}%) in {fft_n / steps:.1f} launches, "
          f"arakawa_rhs_kernel {k1_us / steps:.1f} us/step "
          f"({100 * k1_us / total:.1f}%) in {k1_n / steps:.1f}, other "
          f"kernels {(total - fft_us - k1_us) / steps:.1f} us/step "
          f"({100 * (total - fft_us - k1_us) / total:.1f}%) in "
          f"{rest_n / steps:.1f}")


def phase_cavity_fst(matmul_step_s, profile):
    """The cavity with the rfft DST-I Poisson solves, beside the sine
    matmuls' steps/s of phase 3 in this run."""
    from cfd_julia_torch.stepping import loop

    rates = {"matmul": 1.0 / matmul_step_s}
    for poisson in ("fst", "fst_half"):
        launches, step, state, step_s = phase_main_path(
            poisson, f"phase 11 cavity poisson={poisson}")
        rates[poisson] = 1.0 / step_s
        if profile and poisson == "fst":
            by_name = phase_profile(
                f"cavity {NX}^2 poisson=fst",
                lambda: loop.run_steps(step, state, 20), 20, step_s)
            if by_name:
                profile_rhs(by_name, "arakawa_rhs_kernel", 20)
                profile_transforms(by_name, f"cavity {NX}^2 poisson=fst", 20)
        del step, state
    print(f"phase 11 cavity {NX}^2 fp32 steps/s by Poisson solve, one run "
          f"of this script: " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in rates.items()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler breakdowns of the "
                             "1024^2 cavity step, the 4096^2 multigrid "
                             "solve (fused and fused=\"off\"), the hllc "
                             "8192 Euler step, the ps23 and fdm 2048^2 "
                             "vortex steps and the fst cavity step")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not ANCHORS.is_file():
        print(f"chip_smoke: {ANCHORS} is missing; run from a checkout of "
              "the repository", file=sys.stderr)
        return 1

    from cfd_julia_torch.stepping import loop

    phase_card()
    phase_build()
    record = phase_kernels()
    mg_records = phase_mg_kernels()
    euler_record = phase_euler_kernels()
    launches, step, state, step_s = phase_main_path()
    if args.profile:
        by_name = phase_profile(f"cavity {NX}^2",
                                lambda: loop.run_steps(step, state, 20), 20,
                                step_s)
        if by_name:
            profile_rhs(by_name, "arakawa_rhs_kernel", 20)
    phase_cli()
    mg_counts, mg_solves = phase_multigrid()
    if args.profile:
        from cfd_julia_torch.ops import cuda_kernels

        for variant, check_profile in [("fused", profile_edges),
                                       ("off", profile_off)]:
            solve, best = mg_solves[variant]
            by_name = phase_profile(f"multigrid {MG_NX}^2 {variant}",
                                    lambda solve=solve: [solve()
                                                         for _ in range(3)],
                                    3, best, unit="solve")
            if by_name:
                check_profile(by_name, dict(cuda_kernels.LAUNCHES), 3)
    phase_cli_poisson()
    euler_counts, (e_step, e_state, e_step_s) = phase_euler()
    if args.profile:
        by_name = phase_profile(f"euler hllc {EULER_RUNS[0][1]}",
                                lambda: euler_steps(e_step, e_state, 20), 20,
                                e_step_s)
        if by_name:
            profile_rhs(by_name, "euler_rhs_kernel", 20)
    phase_cli_euler()
    del e_step, e_state
    fdm_launches, v_steps = phase_vortex()
    if args.profile:
        for solver in ("ps23", "fdm"):
            v_step, v_state, v_step_s = v_steps[solver]
            label = f"vortex {solver} {VORTEX_NX}^2"
            by_name = phase_profile(
                label, lambda: euler_steps(v_step, v_state, 10), 10, v_step_s)
            if by_name:
                profile_transforms(by_name, label, 10)
                if solver == "fdm":
                    profile_rhs(by_name, "arakawa_rhs_kernel", 10)
    del v_steps
    phase_cli_spectral()
    phase_cavity_fst(step_s, args.profile)

    record["launches"] = launches[record["name"]]
    record["path"] = f"cavity {NX}^2, {STEPS_TOTAL} steps"
    record["at_2048"]["launches"] = fdm_launches["arakawa_rhs"]
    record["at_2048"]["path"] = (f"vortex fdm {VORTEX_NX}^2, {VORTEX_TOTAL} "
                                 f"steps")
    for name, rec in mg_records.items():
        variant = "fmg" if name == "residual_restrict" else "fused"
        rec["launches"] = mg_counts[variant][name]
        rec["path"] = f"multigrid {MG_NX}^2 {variant} solve"
    euler_record["launches"] = euler_counts[EULER_RUNS[0]]["euler_rhs"]
    euler_record["path"] = (f"euler {EULER_RUNS[0][0]} {EULER_RUNS[0][1]} "
                            f"fp32, {EULER_STEPS} steps")
    print(json.dumps({"kernels": [record, *mg_records.values(),
                                  euler_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
