#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cfd_julia_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

Phases, one line each:
  0. the card (nvidia-smi name and power limit) and the fp32 matmul mode;
  1. builds the CUDA kernels from cfd_julia_torch/csrc/ with nvcc (one
     process per source, all started together), with ptxas's counts, and
     the cuFFT version the library links with the one libcufft file the
     process maps;
  2. each kernel against its plain PyTorch twin on seeded inputs, and its
     time beside the twin's and its bound (bytes over HBM rate or flops
     over the fp32 peak) at its main path's shape: the Arakawa RHS in
     fp32 and fp64 at 1025^2 and at 2048^2 (the cavity's and the fdm
     vortex solver's shapes) and at 517^2 and 1029^2 (phase 19's framed
     cavity blocks: a 2x2 rank's and one rank's) and 1026^2 and 2050^2
     (its framed fdm vortex blocks), each timed warm in L2 and with L2
     flushed, and at small and ragged shapes down to 3x1, two calls
     bitwise equal;
     batched with one device Re a member at (8, 2048, 2048) (the
     ensemble's, eight distinct Re), (2, 3, 1) and (3, 17, 33) in fp32 and
     fp64, two calls bitwise equal, a batch of one with a 0-d Re tensor
     bitwise the float Re call; its backward kernel (the adjoint: the
     field gradients and each member's d/d re) at 1025^2, 2048^2, the
     batched shapes and phase 19 (i)'s framed blocks (517^2 and 1029^2 of
     the sharded cavity, 1026^2 and 2050^2 of the sharded fdm step)
     against its plain version, two calls bitwise equal; the batched
     forward and the backward timed beside their bounds, the backward in
     fp32 and fp64 at 1025^2, 2048^2 and the framed blocks, each also as
     the kernel alone under torch.profiler (one device kernel a call with
     d/d re: the Re sum is folded into its last block), beside its ptxas
     registers and spills and an empty launch;
     the five multigrid kernels at 4097^2 fp32 (the 4096^2
     solve's finest level, sweeps 2) and at 129x65, 33x65, 5x5 and the
     ragged 131x67 and 301x261 in fp32, fp64 and bf16, the two level-edge
     kernels and the smoother at sweeps 0, 1, 2, K+2 and 2K+1 (K sweeps a
     pass) with two calls bitwise equal; the residual sum alone (a
     solve's rms0) and with r written (fmg's g), timed at 4097^2 beside
     its bound; the smoother and the residual sum also at even-sided
     shapes and 3x3 and on both sides of the smoother's one-block limit,
     the smoother timed at 129^2, 65^2 and 3x3 beside an empty launch; the packed cavity's stage kernel
     at (nx, ny) = 1024^2, 16^2, 24x16, 33x47, 34x130, 9x129, 1025^2 and
     3x3 in fp32 and fp64, every stage and both wall-BC orders, two calls
     bitwise equal, timed at 1024^2 warm and with L2 flushed; its
     backward kernel (the adjoint of a stage: the field and wall-vector
     gradients and d/d re) at the same shapes, fp32 and fp64, every stage
     and order, with and without d/d re, against its plain version, two
     calls bitwise equal, timed at 1024^2 fp32 beside its bound and as the
     kernel alone (one device kernel a call with d/d re); the tier
     GEMM (csrc/tier_gemm.cu, the bf16 precision tiers' split-bf16
     product: the split pass
     tier_split and the wgmma GEMM) at 1024^3, 1023^3, 1x1x1, 15x17x13,
     33x47x129 and 130x131x129 with 1 and 3 passes, on random operands and
     the cavity's sine matrices, as tier_matmul and through TierPlans (the
     constant on either side split once, a strided field), within 1e-5 of
     max|C| of its twin, two calls bitwise equal; the split pass bitwise
     _bf16_split in both roles; timed at 1024^3: the split pass, the GEMM
     on split planes, a plan's product and tier_matmul, each beside its
     bound (tensor-core flops over 989 TFLOP/s, or bytes), the twins, the
     fp32 torch.matmul it stands in for and torch.mm on bf16 operands
     split beforehand (the library yardstick); the GEMM's planes epilogue
     (tier_gemm_tn_planes: op(C), C / table or C * scale, stored as the
     next product's A or transposed B planes, or as fp32 C) bitwise
     tier_split(op(its fp32 C)) at every shape above, 1 and 3 passes, each
     epilogue of a solve's chain at the 1024^2 packed cavity within 1e-5
     of its plain version (beyond the planes' own rounding) and timed
     beside it, its bound, today's GEMM + op + split and the library
     yardstick, and the chained solve (1 split + 4 GEMMs)
     bitwise and timed beside the per-product one; the Euler RHS at (3,
     8192),
     (3, 257), nx = 3,
     4, 5 and a block's cells - 1, + 0, + 1 in fp32 and fp64 for roe,
     hllc, rusanov/roe and rusanov/spectral, on random physical states and
     on the Sod state after 100 steps, two calls bitwise equal, timed
     beside an empty launch; the half-spectrum vortex step's three stage
     passes (csrc/vortex_stage.cu): the derivative spectra on ps23's
     2048^2 band, ps32's full width with its scale, a mesh rank's row
     slab, 48x40 both ways and an odd 3x4 plane, the physical product at
     2048^2, 3072^2 (ps32's grid), 48x40 and 3x5, the CN combine at
     stages 1 and 2 on 2048x1025, 48x21, 3x5 and a row slab off a 16-byte
     boundary, in fp32 and fp64, bitwise their twins (or within 1e-6 /
     1e-14 of the scale), two calls bitwise equal, a non-contiguous table
     refused; each timed at 2048^2 fp32 (the product also at 3072^2)
     beside its twin, its bound and, for the derivative pass, one
     torch.mul by a precomputed complex table; the derivative pass's
     buffer mode (the ps23 and ps32 steps' cuFFT layout, the 3/2 pad
     included) at 2048^2, 33x48 row by row and 48x40, and ps32's
     truncation pass at 2048^2 (jf and the table both ways) and 48x40,
     bitwise their twins in fp32 and fp64, each timed at 2048^2 fp32
     beside its twin and its bound; ps23's band-limited inverse beside
     irfft2 of the padded spectra, and the planned inverses of the ps23
     and ps32 steps (ops/fft_plans.HalfInverse): each plan against its
     plain version (1e-5 of max in fp32, 1e-13 in fp64), two executions
     bitwise equal, against the twin route's transform, timed beside it
     (--profile: each by kernel); and an empty kernel beside a CUDA graph
     of 100 of them;
  3. the cavity path: the lid-driven cavity at 1024^2 (dt=2e-5, Re=100,
     Jensen wall BCs, fp32) from rest, 100 steps and then on to 2000,
     checked against the fp64 anchors of benchmarks/physics_anchors.json,
     with the kernels' launch counts over that run; through the graphed
     loop (stepping/loop.py: 50-step chunks, each a CUDA graph replay),
     and again with graph=False: steps/s of both, max|graph - eager|
     (bitwise equal, or within the path's twin tolerance with the eager
     run held to the anchors) and equal launch counts.  Phases 5, 7, 9
     and 11 run their paths the same two ways;
  4. the user entry point `python -m cfd_julia_torch run cavity` on the
     reference case (64^2, Re=100, t=10) against Ghia et al. (1982);
  5. the multigrid path: the 4096^2 `poly` Poisson solve (fp32, tol 1e-5,
     at most 20 V-cycles, 12 levels, fused edges) through
     poisson.multigrid.solve (each cycle a replay of the captured
     V-cycle), with an independent fp64 residual recheck,
     the same solve on the plain twins as the reference, the kernels'
     launch counts against the pyramid's, and seconds per solve; then the
     fmg, cycle_dtype="mixed" and fused="off" variants, checked alike,
     with mixed's error over the fused fp32 solve's printed (--profile:
     device launches a solve, a level edge and a smoother call, for the
     fused solve and for the fused="off" one; in the fused solve the
     residual sum's us a solve beside its bound and the copies a solve,
     failing on a torch residual chain's roll kernel);
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
     ps32 and hybrid through models.vortex.make_spectral_step_half (cuFFT
     and the stage kernels: 3 launches a step of each pass and of each of
     the ps23 / ps32 inverse's two cuFFT plans, ps32 also the truncation,
     hybrid the combine alone) and for fdm through SSP-RK3 over fdm_rhs
     (rhs_impl="auto": the Arakawa CUDA kernel on the periodic field),
     each against its fp64 anchor, with steps/s and the kernels' launch
     counts; fdm's whole run and the spectral solvers' first 20 steps also
     on the plain twins (rhs_impl="torch"), within 1e-4 and launching no
     kernel (--profile: each of the four steps by kernel, the stage
     passes' us a step beside their bounds, and ps23's and ps32's copies
     and fills, which must be none);
 10. the user entry points `run tgv` (64^2, Re=10, t=1) against the
     analytic decay, `run vortex_merger_ps23` (128^2, t=20) for its
     snapshots' mean and enstrophy, and `run poisson_fst` and
     `run poisson_fft_spectral` against their exact solutions;
 11. the cavity of phase 3 with the rfft DST-I Poisson solves (poisson=
     "fst" and "fst_half") in place of the sine matmuls, against the same
     anchors, with steps/s beside phase 3's (--profile: the fst step);
 12. checkpoint and resume: the 1024^2 cavity stopped at 100 and 1000
     steps (checkpoints every 500) and resumed to 2000, and ps23 at 2048^2
     stopped at 100 and resumed to 200, each bitwise the uninterrupted
     graphed run of phase 3 or 9 and inside its anchors; the packed cavity
     of phase 13 likewise, against its uninterrupted cavity.solve run; then
     `run cavity --checkpoint-every 200` and the same with `--resume`,
     equal psi_min;
 13. the packed cavity (poisson="fused", models/cavity_fused.py) of phase
     3's configuration: 3 launches a step of the stage kernel
     csrc/cavity_stage.cu, 12 fp32 GEMMs; graphed and eager, each 100
     steps and on to 2000, against both cavity anchors, bitwise equal with
     equal launch counts (6000 stage launches, no Arakawa launch); the same
     2000 steps through cavity.solve (bitwise the step-level run) and on
     the stage's plain twin; max|psi_fused - psi_matmul|; steps/s beside
     phases 3 and 11 (--profile: the fused step by kernel, and each
     stage's device us inside it beside its bound);
 14. the 1D family: CRWENO-5 periodic Burgers at nx=1600 (fp32, dt =
     1e-4*200/1600, 2000 steps, PCR cyclic solves) against the
     crweno:1600:2000 anchor, steps/s graphed and eager, device launches a
     step; the 11 heat and Burgers presets through run.run_preset (heat
     L2 under tests/test_heat1d.py's bounds, icp in fp64; Burgers in fp64,
     finite, max|u| <= 1 + 1e-6, total variation printed; the central
     baseline to t = 0.15, before the shock it does not survive); the
     CLI's `run heat_cn` and `run burgers_crweno_periodic` (fp32);
 15. the bf16 precision tiers (the JAX package's TPU configurations):
     matmul_bf16x3, matmul_bf16x1, fused_bf16x3 and fused_bf16x1 in phase
     3's configuration, 12 launches a step of the tier GEMM and 3 of the
     split pass (a solve splits its input; each GEMM writes the next
     product's planes): graphed and eager, each 100 steps and on to 2000,
     against both cavity anchors, bitwise equal with equal launch counts
     (24000 tier_gemm, 6000 tier_split, and 6000 Arakawa or stage
     launches);
     max|psi_tier - psi_fp32| of the same
     formulation after 2000 steps (bf16x3 within 1e-4 of max|psi|, bf16x1
     printed); steps/s beside phases 3, 11 and 13 (--profile: the
     fused_bf16x3 step by kernel, each stage's us beside its bound);
     fused_bf16x3 through cavity.solve,
     stopped at 100 steps and resumed bitwise; then `run cavity --poisson
     <tier>` (the four at once) on phase 4's Ghia case beside phase 4's
     fp32 deviations, bf16x3 within 1.1x fp32's + 1e-3, bf16x1 printed;
 16. the Reynolds ensemble (models/ensemble.py): the fdm vortex merger at
     2048^2 (fp32, dt=1e-3) for 8 members, Re 600 to 10000, 100 steps and
     on to 200, graphed and eager (bitwise equal, 600 batched Arakawa
     launches: 3 a step for the whole batch), vortex_fdm_re_sweep bitwise
     the step-level run, the Re=1000 member against fdm:2048:200, every
     member against its own single run through phase 9's path, member-steps/s
     beside phase 9's fdm steps/s, peak memory; then gradients in fp64
     through torch.autograd: (a) d(1e6 mean psi^2)/dRe of the 1024^2
     cavity (dt=2e-5, 50 steps from rest, matmul, the kernel RHS and its
     backward kernel) against the plain RHS's autograd (rel 1e-9) and
     central FD (h=0.5, rtol 1e-4), with as many backward launches as
     forward ones; (b) each member's d mean(w_b^2)/d re_b of the 2048^2 fdm
     ensemble (4 members, 10 steps) in one backward pass against the plain
     RHS's autograd (rel 1e-9) and FD for Re=1000 (h=1, rtol 1e-4);
     (c) ps23 at 2048^2, 10 steps: the directional derivative of sum(w^2)
     w.r.t. the initial field against FD (rtol 1e-6), the gradient through
     the stage kernels' autograd Functions against the twins' (rel
     1e-12); peak memory of each;
 18. (run after phase 16, before 17) gradients through the packed cavity
     and the bf16 tiers at phase 16 (a)'s configuration: fp64 `fused`
     (the stage kernel and its backward kernel) d/dRe against phase 16's
     full-grid gradient (rel 1e-9) and central FD (h=0.5, rtol 1e-4), and
     d/d(initial w) against the full-grid one mapped by pack_state (1e-9
     of its scale, 0 in the padding), 150 backward stage launches as the
     forward's; the fp32 `fused`, `fused_bf16x3`, `fused_bf16x1`,
     `matmul_bf16x3` and `matmul_bf16x1` d/dRe against the fp64 one (fp32
     and bf16x3 rel 1e-3 and 2e-3, bf16x1 finite, the same sign, within
     0.5) beside the loss's own difference, the tier solves' backward
     the chained tier GEMMs on the cotangent (as many tier_split and
     tier_gemm launches backward as forward: 3 and 12 a step); seconds and
     peak memory of each;
 17. the user surface (cfd_julia_torch/cli.py, examples/, utils/debug.py):
     `list` (29 presets) and `validate` (7 checks, all PASS) as processes
     on the card; `run-all` in this process through cli.main (the quick
     table, the point-Jacobi and red-black presets cut to 20000 sweeps),
     with the counts set to 0 just before it: 29/29
     presets OK, each metrics.json's device the card, seconds and kernel
     launches a preset, kernel 1 launched by cavity / vortex_merger_fdm /
     tgv, the vortex stage passes and the inverse's plans by
     vortex_merger_ps23 / _ps32 (ps32 also the truncation) and _hybrid
     (the combine), kernels 2, 3 and 5 by the
     multigrid presets, kernel 6 by the Euler presets, burgers_central's
     non-finite field reported and not gated; the three order studies of
     tests/test_cli_tools.py in fp64 on the card at that file's bounds,
     each against the same study with --device cpu in this process
     (errors within 1e-9 relative or 1e-12 absolute); `run
     burgers_weno_dirichlet --sweep nx=100,200,400` (three points, the
     solution_d_<nx>.txt aliases); examples.adjoint_cavity
     (fp64 d loss/dRe through kernel 1 and its backward kernel against its
     central difference, rel 1e-4) and examples.vortex_diagnostics (128^2,
     the enstrophy budget within 1e-2); and utils.debug.nan_guard naming
     kernel 6 and kernel 1 at a NaN fed to each, the same calls returning
     outside the guard;
 19. (last) the multi-device path (cfd_julia_torch/parallel/), its ranks
     started by parallel/launch.py: (a) the 1024^2 sharded cavity of phase
     3's configuration on one rank over NCCL, 2000 steps, against both
     cavity anchors and the single-device padded step at step 100 (1e-5
     of max|psi|), 6000 kernel-1 launches; (b) the same on 2x2 ranks on
     the one card over gloo (halos and gathers staged through host memory,
     printed as such), 100 steps, against (a) (1e-5 of max|psi|) and the
     anchor, 300 kernel-1 launches on every rank; (c) the 4096^2 mesh
     multigrid solve (poly, cheb smoother, matmul transfers, fp32, tol
     1e-5) on one rank and on 2x2 against the single-device solve of the
     same MGConfig: at most one more cycle, u within 1e-5 of max|u|, an
     fp64 recheck of the residual on the gathered u; (d) save_sharded of
     (b)'s state, restored bitwise on 2x2 and on one rank; (e) `python -m
     cfd_julia_torch.examples.multichip_cavity --ranks 4 --device cuda`;
     (f) on the one NCCL rank, the 2048^2 vortex merger (dt=1e-3,
     Re=1000, fp32) for ps23, ps32 and hybrid through
     make_sharded_vortex_step_half (row slabs of the half spectrum, the
     pencil transposes of parallel/transpose.py) and fdm through
     make_sharded_vortex_step (blocks, kernel 1 on the framed block), 200
     steps each, against the <solver>:2048:200 anchors and at step 10 the
     single-device step (1e-5 of max|w|), 600 kernel-1 launches for fdm;
     ps23's full spectrum in blocks for 20 steps against the half form;
     (g) the four on 2x2 ranks over gloo (transposes and halos staged
     through host memory, printed as such), 10 steps, against (f) (1e-5
     of max|w|), 30 kernel-1 launches a rank for fdm; (h) phase 3's
     cavity with poisson="fst" and "fst_half" through
     cavity.make_step_fn(mesh=): one rank 100 steps against cavity:1024:100
     and the single-device step (1e-5 of max|psi|), 2x2 20 steps against
     the one-rank run; (i) gradients through the mesh steps in fp64, each
     rank's loss halo.all_reduce_sum(local) and its .backward() on every
     rank, with these groups: (i-1) on the one NCCL rank phase 16 (a)'s
     cavity (1024^2, dt=2e-5, 50 steps from rest, d(1e6 mean psi^2)/dRe)
     with poisson="fst" through make_step_fn(cfg, mesh=, re=<0-d tensor>)
     against the single-device make_step_fn(cfg, re=) gradient (rel 1e-9)
     and central FD (h=0.5, rtol 1e-4), d/d(initial w) within 1e-9 of
     max|single-device|, 0 in the padding; fst_half the same over 10
     steps; (i-2) both over 10 steps on 2x2 gloo ranks against the one
     rank's 10-step gradients (rel 1e-9); (i-3) the fdm vortex at 2048^2,
     d mean(w^2)/dRe over 10 SSP-RK3 steps through make_fdm_rhs(mesh=,
     re=), on one rank and on 2x2, against the single-device gradient
     (rel 1e-9); (i-4) ps23's half step at 2048^2 on one rank, 10 steps,
     the directional derivative of sum(w^2) in the initial field against
     the single-device one (rel 1e-9), and the gradient through the stage
     kernels against the twins' on the same rank (rel 1e-12); on every
     rank as many kernel-1 backward (and Re-sum) launches as forward ones;
     seconds, peak memory a rank and the share of the backward its
     collectives take replayed alone; the whole of (i) within 90 s.
     Seconds, peak memory a rank and the share of a step its collectives
     (a-e) or its transposes (f-h) take when replayed alone, beside the
     card's name and power limit; the 2x2 runs share one card and are no
     scaling numbers.
Then a JSON line with each kernel's record, and last
{"ok": true, "device": {...}}.  Any failure raises and the script exits
nonzero without that last line; without a GPU it fails at once.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

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
# the multigrid kernels: LAUNCHES key -> the TPU kernel it replaces (the
# residual sum: the XLA-fused rms0 residual of the JAX solve)
MG_KERNELS = {
    "prolong_correct_smooth": "cfd_julia_tpu/ops/pallas_kernels.py:547",
    "smooth_residual_restrict": "cfd_julia_tpu/ops/pallas_kernels.py:347",
    "residual_restrict": "cfd_julia_tpu/ops/pallas_kernels.py:417",
    "redblack_sweeps": "cfd_julia_tpu/ops/pallas_kernels.py:144",
    "residual_ssq": "cfd_julia_tpu/poisson/multigrid.py:465",
}
# checked with the kernels above: the residual sum with r written (fmg's g)
MG_CHECKED = (*MG_KERNELS, "residual_ssq_r")
# the kernels that take any extent, held at RB_SHAPES too
MG_ANY_EXTENT = ("redblack_sweeps", "residual_ssq", "residual_ssq_r")
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
# dense bf16 on the tensor cores, and fp64 outside them (the same data
# sheet)
BF16_FLOP_PER_S = 989e12
FP64_FLOP_PER_S = 34e12
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


def bound(n_bytes, flops, ms, flop_per_s=FP32_FLOP_PER_S):
    """The card's least time for a call (the larger of its bytes, each
    input read once and each output written once, over HBM's rate and its
    flops over the peak `flop_per_s`, fp32's by default), what sets it, and
    the share of it that a call of `ms` reaches."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    bound_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    return {"bound_ms": bound_ms, "bound_by": by,
            "share_of_bound": bound_ms / ms}


def ptxas_lines(log, pattern=None):
    """[(kernel, registers, spill store bytes)] of the kernels in an
    nvcc.log whose mangled names match `pattern` (every kernel if None),
    in the log's order."""
    out, name, spill = [], None, None
    for line in Path(log).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if pattern is None or re.search(
                pattern, m.group(1)) else None
            spill = None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, spill))
            name = None
    return out


def kernel_alone(call, kernel, calls=20, windows=3):
    """(device us a launch of the kernels whose names hold `kernel`, the
    device kernels recorded a call, the other kernels' names) over `calls`
    calls of call() under torch.profiler; (None, 0.0, names) if it records
    none of them.  The profiler can drop a few events of a window, so the
    count a call may read below 1, and now and then a whole window: a
    window with no device event at all is profiled again, up to `windows`
    in all (one that records any kernel is the one read)."""
    for _ in range(windows):
        events, _ = profiled_kernels(lambda: [call() for _ in range(calls)])
        if events:
            break
    mine = [e for e in events if kernel in e.name]
    if not mine:
        return None, 0.0, sorted({e.name for e in events})
    us = sum(e.time_range.end - e.time_range.start for e in mine) / len(mine)
    return us, len(events) / calls, sorted({e.name[:80] for e in events
                                            if kernel not in e.name})


def alone_text(us, per_call, others, bound_ms):
    """The kernel-alone part of a backward line, and whether the profile
    shows at most one device kernel a call, the backward, and no other."""
    if us is None:
        return ("the kernel alone: no device events recorded (not "
                f"measured; other kernels {others})"), False
    ok = not others and per_call <= 1.0
    return (f"the kernel alone {us:.2f} us a launch under torch.profiler "
            f"({100 * bound_ms * 1e3 / us:.1f}% of the bound), "
            f"{per_call:g} device kernels recorded a call, other kernels: "
            f"{', '.join(others) if others else 'none'}"), ok


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
    # the library links cuFFT by soname: it must run the copy PyTorch
    # loaded, so the process maps one libcufft file
    from cfd_julia_torch.ops import fft_plans

    with open("/proc/self/maps") as f:
        mapped = sorted({ln.split()[-1] for ln in f
                         if re.search(r"/libcufft\.so", ln)})
    ok = len(mapped) == 1
    line = (f"phase 1 cufft: cufftGetVersion()={fft_plans.version()}, "
            f"libcufft mapped from {mapped} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


# the Arakawa RHS besides its two paths' shapes: small shapes, and ragged
# ones that no block of the kernel divides (nc = 1, 2: the periodic
# neighbours alias)
ARAKAWA_SHAPES = [(37, 53), (8, 8), (3, 1), (3, 2), (65, 33), (1023, 31)]
# the shapes its paths give it, timed: the cavity's nodes and the periodic
# vortex field's unique nodes (16-byte-aligned rows, 3 fields the size of L2),
# then phase 19's framed blocks: a 2x2 rank's 513^2 block and one rank's
# 1025^2 field, each with its 2-node frame; and the sharded fdm vortex's: a
# 2x2 rank's 1024^2 block and one rank's 2048^2 field, each with its 1-node
# frame
ARAKAWA_MESH = [((NX + 2) // 2 + 4,) * 2, (NX + 5,) * 2]
ARAKAWA_VORTEX_MESH = [(VORTEX_NX // 2 + 2,) * 2, (VORTEX_NX + 2,) * 2]
ARAKAWA_TIMED = [(NX + 1, NX + 1), (VORTEX_NX, VORTEX_NX), *ARAKAWA_MESH,
                 *ARAKAWA_VORTEX_MESH]


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
    keys = ("launches", "max_abs_err", "ms", "cold_ms", "plain_ms",
            "bound_ms", "bound_by", "share_of_bound", "library_ms")

    def sub(shape):
        return {"shape": list(shape),
                **{k: v for k, v in records[shape].items() if k in keys}}

    record = records[ARAKAWA_TIMED[0]]
    record["at_2048"] = {k: v for k, v in sub(ARAKAWA_TIMED[1]).items()
                         if k != "shape"}
    record["sharded"] = {**sub(ARAKAWA_MESH[0]),
                         "world_1": sub(ARAKAWA_MESH[1])}
    record["sharded_vortex"] = {**sub(ARAKAWA_VORTEX_MESH[0]),
                                "world_1": sub(ARAKAWA_VORTEX_MESH[1])}
    return record


# the ensemble's Reynolds numbers (phase 16): SSP-RK3's viscous limit at
# dx = 2 pi/2048 and dt = 1e-3 is Re ~ 340, so the floor is 600
ENSEMBLE_RE = (600.0, 800.0, 1000.0, 1500.0, 2000.0, 3000.0, 5000.0,
               10000.0)
# the batched Arakawa RHS (one device Re a member, the first B of
# ENSEMBLE_RE): the ensemble's batch, then ragged batches (one column; a
# part-filled last block on both axes)
ARAKAWA_BATCHED = [(len(ENSEMBLE_RE), VORTEX_NX, VORTEX_NX), (2, 3, 1),
                   (3, 17, 33)]
# its backward kernel: the cavity's and the vortex field's shapes, the
# batches, and phase 19 (i)'s framed blocks (ARAKAWA_MESH: the sharded
# cavity's on a 2x2 rank and on one rank; ARAKAWA_VORTEX_MESH: the sharded
# fdm step's); timed at all but the ragged batches, at the single shapes
# and the framed blocks in fp32 and fp64
ARAKAWA_BACKWARD = [(NX + 1, NX + 1), (VORTEX_NX, VORTEX_NX),
                    *ARAKAWA_BATCHED, *ARAKAWA_MESH, *ARAKAWA_VORTEX_MESH]
ARAKAWA_BACKWARD_TIMED = {
    (NX + 1, NX + 1): "backward", (VORTEX_NX, VORTEX_NX): "at_2048",
    ARAKAWA_BATCHED[0]: "at_batch", ARAKAWA_MESH[0]: "sharded",
    ARAKAWA_MESH[1]: "sharded_world_1", ARAKAWA_VORTEX_MESH[0]:
    "sharded_vortex", ARAKAWA_VORTEX_MESH[1]: "sharded_vortex_world_1"}
# flops the backward needs a point, counted from its source: two
# Jacobians (37 each), two Laplacians and their scalings (~22), the Re
# gradient's product and sum
FLOPS_ARAKAWA_BACKWARD = 100


def arakawa_inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    dx, dy = 1.0 / (shape[-2] - 1), 1.0 / max(shape[-1] - 1, 1)
    return [rng.standard_normal(shape) for _ in range(n)], dx, dy


def arakawa_re(shape, dtype, dev):
    """One Re a member of a batch, RE for a 2-D field (a 0-d tensor)."""
    if len(shape) == 2:
        return torch.tensor(RE, dtype=dtype, device=dev)
    return torch.tensor(ENSEMBLE_RE[:shape[0]], dtype=dtype, device=dev)


def phase_arakawa_batched():
    """The batched kernel 1 (one device Re a member) and its backward
    kernel against their plain versions, two calls bitwise equal; timed at
    the ensemble's batch (forward, backward) and at 1025^2 and 2048^2
    (backward).  Returns {"batched": the forward's record at the batch,
    "backward": the backward's at 1025^2 with the others under "at_2048"
    and "at_batch"}."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    timed = {}
    for shape in ARAKAWA_BATCHED:
        (w_np, s_np), dx, dy = arakawa_inputs(shape, 2, sum(shape))
        for dtype, rel in [(torch.float32, 1e-5), (torch.float64, 1e-12)]:
            w = torch.as_tensor(w_np, dtype=dtype, device=dev)
            s = torch.as_tensor(s_np, dtype=dtype, device=dev)
            re = arakawa_re(shape, dtype, dev)
            got = ck.arakawa_rhs_fused(w, s, dx, dy, re)
            again = ck.arakawa_rhs_fused(w, s, dx, dy, re)
            ref = ck.arakawa_rhs_fused_plain(w, s, dx, dy, re)
            one_t = ck.arakawa_rhs_fused(w[0], s[0], dx, dy, re[0])
            one_f = ck.arakawa_rhs_fused(w[0], s[0], dx, dy, float(re[0]))
            # the batch with a float re (re[0]) for every member, which
            # the wrapper fills into a device tensor
            host = ck.arakawa_rhs_fused(w, s, dx, dy, float(re[0]))
            host_ref = ck.arakawa_rhs_fused_plain(w, s, dx, dy, float(re[0]))
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            same = torch.equal(got, again)
            one_same = torch.equal(one_t, one_f) and torch.equal(got[0],
                                                                 one_f)
            host_err = float((host - host_ref).abs().max())
            host_same = torch.equal(host[0], one_f)
            ok = (err <= rel * scale and same and one_same and host_same
                  and host_err <= rel * float(host_ref.abs().max()))
            line = (f"phase 2 kernel arakawa_rhs batched {shape} "
                    f"{str(dtype)[6:]} re={[float(r) for r in re]}: "
                    f"max|k-p|={err:.3e} max|p|={scale:.3e} "
                    f"tol={rel:g}*max|p|; two calls bitwise equal: {same}; "
                    f"member 0 with a 0-d re tensor, and in the batch, "
                    f"bitwise the float-re 2-D call: {one_same}; the batch "
                    f"with a float re: max|k-p|={host_err:.3e}, member 0 "
                    f"bitwise the 2-D call: {host_same}")
            if shape == ARAKAWA_BATCHED[0] and dtype == torch.float32:
                ms, call_ms = median_ms(
                    lambda: ck.arakawa_rhs_fused(w, s, dx, dy, re))
                plain_ms, _ = median_ms(
                    lambda: ck.arakawa_rhs_fused_plain(w, s, dx, dy, re),
                    reps=10)
                b = bound(nbytes(w, s, got), FLOPS_ARAKAWA * w.numel(), ms)
                line += (f"; device time: kernel {ms:.4f} ms (bound "
                         f"{b['bound_ms']:.4f} ms by {b['bound_by']}: 3 "
                         f"fields of {shape}, {100 * b['share_of_bound']:.1f}"
                         f"% of it; {ms / shape[0]:.4f} ms a member), plain "
                         f"{plain_ms:.4f} ms; eager call {call_ms:.4f} ms")
                timed["batched"] = {
                    "name": "arakawa_rhs", "shape": list(shape),
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, **b, "library_ms": None}
            line += " ok" if ok else " FAIL"
            print(line)
            check(ok, line)
            del w, s, got, again, ref, host, host_ref
    # the backward's lanes, strips and ring, its ptxas counts, and an
    # empty launch, for the timed lines
    from cfd_julia_torch.ops import _cuda_build

    lib = _cuda_build.load_library()
    ahead = lib.arakawa_rhs_backward_constant(5)
    back_ptxas = ptxas_lines(Path(lib._name).with_name(_cuda_build.LOG_NAME),
                             "arakawa_rhs_backward_kernel")
    floor_ms, _ = median_ms(lambda: torch.cuda._sleep(0))
    for shape in ARAKAWA_BACKWARD:
        (w_np, s_np, g_np), dx, dy = arakawa_inputs(shape, 3, sum(shape) + 1)
        for dtype, rel in [(torch.float32, 1e-5), (torch.float64, 1e-12)]:
            w, s, g = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in (w_np, s_np, g_np))
            re = arakawa_re(shape, dtype, dev)
            got = ck.arakawa_rhs_backward(w, s, g, dx, dy, re)
            again = ck.arakawa_rhs_backward(w, s, g, dx, dy, re)
            ref = ck.arakawa_rhs_backward_plain(w, s, g, dx, dy, re)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            gg = 1.0 / (4 * dx * dy)
            amax = [float(x.abs().max()) for x in (w, s, g)]
            # each field's scale: its largest value or its Jacobian term's
            # size, gg max|a| max|b| (with one column the Jacobian is 0)
            errs, oks = [], []
            for mine, want, jac in ((got[0], ref[0], gg * amax[1] * amax[2]),
                                    (got[1], ref[1], gg * amax[2] * amax[0])):
                e = float((mine - want).abs().max())
                sc = max(float(want.abs().max()), jac)
                errs.append(e / sc)
                oks.append(e <= rel * sc)
            dre = (got[2].double() - ref[2].double()).abs()
            if dtype == torch.float64:
                re_scale = ref[2].abs()
                re_tol = "rel 1e-10"
                re_err = float((dre / re_scale).max())
                re_ok = bool((dre <= 1e-10 * re_scale).all())
            else:
                lap = ck.arakawa.laplacian(w.double(), dx, dy)
                re_scale = (g.double() * lap).abs().sum((-2, -1)) / \
                    re.double() ** 2
                re_tol = "1e-5 of sum|g lap w|/re^2"
                re_err = float((dre / re_scale).max())
                re_ok = bool((dre <= 1e-5 * re_scale).all())
            ok = all(oks) and re_ok and same
            line = (f"phase 2 kernel arakawa_rhs_backward {shape} "
                    f"{str(dtype)[6:]}: max|k-p| of gw {errs[0]:.3e}, gs "
                    f"{errs[1]:.3e} of their scales (tol {rel:g}); d/dre "
                    f"{[float(x) for x in got[2].reshape(-1)]} vs the plain "
                    f"version's, err {re_err:.3e} ({re_tol}); two calls "
                    f"bitwise equal: {same}")
            key = ARAKAWA_BACKWARD_TIMED.get(shape)
            if key is not None and (dtype == torch.float32
                                    or len(shape) == 2):
                if dtype == torch.float64:
                    key += "_fp64"
                ms, call_ms = median_ms(
                    lambda: ck.arakawa_rhs_backward(w, s, g, dx, dy, re))
                plain_ms, _ = median_ms(
                    lambda: ck.arakawa_rhs_backward_plain(w, s, g, dx, dy,
                                                          re), reps=10)
                b = bound(nbytes(w, s, g, got[0], got[1]),
                          FLOPS_ARAKAWA_BACKWARD * w.numel(), ms,
                          FP64_FLOP_PER_S if dtype == torch.float64
                          else FP32_FLOP_PER_S)
                us, per_call, others = kernel_alone(
                    lambda: ck.arakawa_rhs_backward(w, s, g, dx, dy, re),
                    "arakawa_rhs_backward_kernel")
                alone, alone_ok = alone_text(us, per_call, others,
                                             b["bound_ms"])
                ok = ok and alone_ok
                # the launcher's lanes: 16 bytes where a row is a multiple
                # of 16 bytes (every tensor here starts 16-byte aligned)
                f64 = int(dtype == torch.float64)
                vec = 16 // w.element_size()
                cols = vec if shape[-1] % vec == 0 else 1
                strip = lib.arakawa_rhs_backward_rows(
                    shape[0] if len(shape) == 3 else 1, *shape[-2:], f64,
                    int(cols > 1))
                tag = (f"arakawa_rhs_backward_kernelI{'d' if f64 else 'f'}"
                       f"Li{cols}ELi{ahead}EE")
                regs, spill = next(((r, sp) for name, r, sp in back_ptxas
                                    if tag in name), (None, None))
                line += (f"; device time: kernel {ms:.4f} ms (bound "
                         f"{b['bound_ms']:.4f} ms by {b['bound_by']}: 5 "
                         f"fields, {100 * b['share_of_bound']:.1f}% of it), "
                         f"plain {plain_ms:.4f} ms; eager call "
                         f"{call_ms:.4f} ms; {alone}; an empty launch "
                         f"{floor_ms:.4f} ms; {cols}-column lanes, strips "
                         f"of {strip} rows: ptxas {regs} registers, {spill} "
                         f"bytes spill stores")
                timed[key] = {"shape": list(shape), "launches": None,
                              "max_abs_err": max(
                                  float((a - b).abs().max())
                                  for a, b in zip(got, ref)),
                              "ms": ms, "plain_ms": plain_ms, **b,
                              "library_ms": None,
                              "kernel_ms": None if us is None else us * 1e-3,
                              "kernel_share_of_bound": None if us is None
                              else b["bound_ms"] * 1e3 / us,
                              "floor_ms": floor_ms, "lane_columns": cols,
                              "strip_rows": strip, "registers": regs,
                              "spill_bytes": spill}
            line += " ok" if ok else " FAIL"
            print(line)
            check(ok, line)
            del w, s, g, got, again, ref
    backward = {"name": "arakawa_rhs_backward", "route": "cuda",
                "source": "cfd_julia_torch/csrc/arakawa_rhs.cu",
                "replaces": ("cfd_julia_tpu/ops/arakawa.py:57 (jax.grad of "
                             "the XLA RHS; the TPU kernel has no backward)"),
                **timed["backward"], "fp64": timed["backward_fp64"],
                "at_2048": timed["at_2048"], "at_batch": timed["at_batch"]}
    # phase 19 (i)'s framed blocks, each with its fp64 timing and its
    # one-rank shape under "world_1"
    for key in ("sharded", "sharded_vortex"):
        backward[key] = {**timed[key], "fp64": timed[f"{key}_fp64"],
                         "world_1": {**timed[f"{key}_world_1"],
                                     "fp64": timed[f"{key}_world_1_fp64"]}}
    return {"batched": timed["batched"], "backward": backward}


# the packed cavity's stage kernel: (nx, ny) of its phase 2 shapes, the
# first its main path's (a 1024^2 buffer), then 16 x 128, 24 x 128, 33x47
# (P = m = 32: no padded row), 34x130 (40 x 256), 9x129 (P = m = 8, n = Q =
# 128: the walls past the buffer on both axes), 1025^2 (m = n = P = Q =
# 1024) and 3x3 (m = n = 2)
STAGE_SHAPES = [(NX, NX), (16, 16), (24, 16), (33, 47), (34, 130), (9, 129),
                (NX + 1, NX + 1), (3, 3)]
# flops a stage needs per point: the Arakawa RHS and the combine
FLOPS_STAGE = FLOPS_ARAKAWA + 5


def stage_inputs(nx, ny, dtype, seed):
    """Random interior fields of scale 1 with zero padding, and random wall
    vectors that are zero past the logical interior, on the card."""
    from cfd_julia_torch.models import cavity_fused

    rng = np.random.default_rng(seed)
    m, n = nx - 1, ny - 1
    P, Q = cavity_fused.padded_extents(nx, ny)
    fields = []
    for _ in range(3):
        a = np.zeros((P, Q))
        a[:m, :n] = rng.standard_normal((m, n))
        fields.append(torch.as_tensor(a, dtype=dtype, device="cuda"))
    walls = []
    for size, L in ((Q, n), (Q, n), (P, m), (P, m)):
        v = np.zeros(size)
        v[:L] = rng.standard_normal(L)
        walls.append(torch.as_tensor(v, dtype=dtype, device="cuda"))
    return (*fields, tuple(walls))


def phase_stage_kernel():
    """The stage kernel against its twin at every shape, dtype, stage and
    wall-BC order, two calls bitwise equal, padding 0; each stage timed at
    1024^2 fp32 (Jensen walls) warm and with L2 flushed beside its bound.
    Returns the kernel's record (stage 2's time, and each stage's)."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    record, stages = None, {}
    for nx, ny in STAGE_SHAPES:
        m, n = nx - 1, ny - 1
        for dtype, rel in [(torch.float32, 1e-5), (torch.float64, 1e-12)]:
            worst, all_same, all_zero = 0.0, True, True
            for bc_order in (1, 2):
                for stage in (1, 2, 3):
                    w, wt, s, walls = stage_inputs(nx, ny, dtype,
                                                   nx + 7 * stage + bc_order)
                    wt = w if stage == 1 else wt
                    args = (w, wt, s, walls, stage, 2e-5, 1.0 / nx, 1.0 / ny,
                            RE, m, n, bc_order)
                    got = ck.cavity_fused_stage(*args)
                    again = ck.cavity_fused_stage(*args)
                    ref = ck.cavity_fused_stage_plain(*args)
                    torch.cuda.synchronize()
                    outs = (got[0], *got[1])
                    errs = [float((g - r).abs().max()) / float(r.abs().max())
                            for g, r in zip(outs, (ref[0], *ref[1]))]
                    worst = max(worst, *errs)
                    all_same &= all(torch.equal(g, a) for g, a in
                                    zip(outs, (again[0], *again[1])))
                    all_zero &= not (got[0][m:].any() or got[0][:, n:].any())
                    if (nx, ny) == STAGE_SHAPES[0] and bc_order == 2 and \
                            dtype == torch.float32:
                        stages[stage] = stage_timing(
                            ck, args, float((got[0] - ref[0]).abs().max()))
                    del w, wt, s, walls, got, again, ref
            ok = worst <= rel and all_same and all_zero
            P, Q = -(-m // 8) * 8, -(-n // 128) * 128
            line = (f"phase 2 kernel cavity_fused_stage {nx}x{ny} (buffer "
                    f"{P}x{Q}) {str(dtype)[6:]} stages 1-3, bc_order 1-2: "
                    f"max|k-p|/max|p| over the interior and the wall "
                    f"vectors {worst:.3e} (tol {rel:g}); two calls bitwise "
                    f"equal: {all_same}; padding 0: {all_zero}"
                    f" {'ok' if ok else 'FAIL'}")
            if (nx, ny) == STAGE_SHAPES[0] and dtype == torch.float32:
                line += "; 1024^2 fp32 device time a stage: " + ", ".join(
                    f"stage {k} kernel {v['ms']:.4f} ms warm in L2 "
                    f"({100 * v['share_of_bound']:.1f}% of its bound "
                    f"{v['bound_ms']:.4f} ms by {v['bound_by']}), "
                    f"{v['cold_ms']:.4f} ms with L2 flushed "
                    f"({100 * v['bound_ms'] / v['cold_ms']:.1f}%), plain "
                    f"{v['plain_ms']:.4f} ms" for k, v in stages.items()) + \
                    " (medians of 30 calls, CUDA events)"
            print(line)
            check(ok, line)
    record = {"name": "cavity_fused_stage", "route": "cuda",
              "source": "cfd_julia_torch/csrc/cavity_stage.cu",
              "replaces": "cfd_julia_tpu/models/cavity_fused.py:153 (the "
                          "XLA-fused stage, not a Pallas kernel)",
              "launches": None, **{k: v for k, v in stages[2].items()},
              "library_ms": None,
              "stages": {k: {kk: v[kk] for kk in ("ms", "cold_ms",
                                                  "plain_ms", "bound_ms")}
                         for k, v in stages.items()}}
    return record


def stage_bound(stage, P, Q, itemsize, ms):
    """The stage kernel's bound on a (P, Q) buffer: w and s (and wt from
    stage 2) read once, the stage written once, the four wall vectors read
    and written; and the share of it a call of `ms` reaches."""
    fields = (3 if stage == 1 else 4) * P * Q
    return bound((fields + 4 * (P + Q)) * itemsize, FLOPS_STAGE * P * Q, ms)


def stage_timing(ck, args, err):
    """Warm, L2-flushed and plain device times of one stage call and its
    bound (stage_bound)."""
    w, stage = args[0], args[4]
    ms, _ = median_ms(lambda: ck.cavity_fused_stage(*args))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    cold_ms, _ = median_ms(lambda: ck.cavity_fused_stage(*args),
                           before=flush.zero_)
    del flush
    plain_ms, _ = median_ms(lambda: ck.cavity_fused_stage_plain(*args))
    b = stage_bound(stage, *w.shape, w.element_size(), ms)
    return {"max_abs_err": err, "ms": ms, "cold_ms": cold_ms,
            "plain_ms": plain_ms, **b}


def stage_backward_inputs(nx, ny, dtype, seed):
    """Random fields and wall vectors on the whole buffer (the padding
    too: the adjoint must not lean on its zeros) and the cotangents g, h
    of the stage's outputs, on the card."""
    from cfd_julia_torch.models import cavity_fused

    rng = np.random.default_rng(seed)
    P, Q = cavity_fused.padded_extents(nx, ny)
    dev = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    wt, s, g = (dev(rng.standard_normal((P, Q))) for _ in range(3))
    walls, h = (tuple(dev(rng.standard_normal(k)) for k in (Q, Q, P, P))
                for _ in range(2))
    return wt, s, walls, g, h


def stage_re_scale(ck, wt, walls, g, stage, dt, dx, dy, m, n, bc_order):
    """c sum|q lap W| / re^2 in fp64: the size of the terms of the
    stage's Re gradient (its fp32 tolerance is a share of it)."""
    import torch.nn.functional as F

    wz = F.pad(ck._extended_w(wt.double(), tuple(v.double() for v in walls),
                              m, n, ck._lid(dy, bc_order)), (1, 1, 1, 1))
    lap = ck.arakawa.laplacian(wz, dx, dy)[2:m + 2, 2:n + 2]
    c = ck._STAGE_COEFFS[stage][2] * dt
    return c * float((g.double()[:m, :n] * lap).abs().sum()) / RE**2


def phase_stage_backward_kernel():
    """The stage kernel's backward (its adjoint) against its plain version
    at every shape of STAGE_SHAPES in fp32 and fp64, every stage, both
    wall-BC orders, with and without the Re gradient, two calls bitwise
    equal; timed at the 1024^2 buffer in fp32 and fp64 (stage 2, Jensen
    walls, with the Re gradient: the call a packed gradient makes) warm
    and with L2 flushed, beside its bound.  Returns the kernel's fp32
    record, the fp64 times under "fp64"."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    timed = {}    # dtype -> the 1024^2 stage 2 timing
    for nx, ny in STAGE_SHAPES:
        m, n = nx - 1, ny - 1
        for dtype, rel in [(torch.float32, 1e-5), (torch.float64, 1e-12)]:
            worst = re_worst = 0.0
            all_same = True
            for bc_order in (1, 2):
                for stage in (1, 2, 3):
                    wt, s, walls, g, h = stage_backward_inputs(
                        nx, ny, dtype, nx + 7 * stage + bc_order)
                    args = (wt, s, walls, g, h, stage, 2e-5, 1.0 / nx,
                            1.0 / ny, RE, m, n, bc_order)
                    ref = ck.cavity_fused_stage_backward_plain(*args)
                    for re_grad in (True, False):
                        got = ck.cavity_fused_stage_backward(
                            *args, re_grad=re_grad)
                        again = ck.cavity_fused_stage_backward(
                            *args, re_grad=re_grad)
                        torch.cuda.synchronize()
                        flat = [x for x in (got[0], got[1], got[2], *got[3])
                                if x is not None]
                        flat_ref = [x for x in (ref[0], ref[1], ref[2],
                                                *ref[3]) if x is not None]
                        flat_again = [x for x in (again[0], again[1],
                                                  again[2], *again[3])
                                      if x is not None]
                        worst = max(worst, *(
                            float((a - b).abs().max()) / float(b.abs().max())
                            for a, b in zip(flat, flat_ref)))
                        all_same &= all(torch.equal(a, b)
                                        for a, b in zip(flat, flat_again))
                        all_same &= (got[4] is None) != re_grad
                        if re_grad:
                            all_same &= torch.equal(got[4], again[4])
                            err = abs(float(got[4]) - float(ref[4]))
                            scale = (abs(float(ref[4]))
                                     if dtype == torch.float64 else
                                     stage_re_scale(ck, wt, walls, g,
                                                    *args[5:9], m, n,
                                                    bc_order))
                            re_worst = max(re_worst, err / scale)
                    if (nx, ny) == STAGE_SHAPES[0] and stage == 2 and \
                            bc_order == 2:
                        timed[dtype] = stage_backward_timing(
                            ck, args, float(max(
                                (a - b).abs().max()
                                for a, b in zip(flat, flat_ref))))
                    del wt, s, walls, g, h, got, again, ref
            re_tol = 1e-10 if dtype == torch.float64 else 1e-5
            ok = worst <= rel and re_worst <= re_tol and all_same
            P, Q = -(-m // 8) * 8, -(-n // 128) * 128
            line = (f"phase 2 kernel cavity_stage_backward {nx}x{ny} (buffer "
                    f"{P}x{Q}) {str(dtype)[6:]} stages 1-3, bc_order 1-2, "
                    f"with and without d/dre: max|k-p|/max|p| over gw, gwt, "
                    f"gs and the wall vectors' gradients {worst:.3e} (tol "
                    f"{rel:g}); d/dre err {re_worst:.3e} of "
                    f"{'|p|' if dtype == torch.float64 else 'c sum|q lap W|/re^2'}"
                    f" (tol {re_tol:g}); two calls bitwise equal: "
                    f"{all_same}")
            if (nx, ny) == STAGE_SHAPES[0]:
                rec = timed[dtype]
                line += (f"; 1024^2 {str(dtype)[6:]} stage 2 with d/dre: "
                         f"device time {rec['ms']:.4f} ms warm in L2 "
                         f"({100 * rec['share_of_bound']:.1f}% of its "
                         f"bound {rec['bound_ms']:.4f} ms by "
                         f"{rec['bound_by']}: 3 fields read, 3 written), "
                         f"{rec['cold_ms']:.4f} ms with L2 flushed "
                         f"({100 * rec['bound_ms'] / rec['cold_ms']:.1f}"
                         f"%), without d/dre {rec['no_re_ms']:.4f} ms, "
                         f"plain {rec['plain_ms']:.4f} ms; eager call "
                         f"{rec['call_ms']:.4f} ms (medians of 30 calls, "
                         f"CUDA events); with d/dre {rec['alone'][0]}")
                ok = ok and rec["alone"][1]
                if dtype == torch.float32:
                    line += (f"; the thread-a-point gather it replaced: "
                             f"{STAGE_BACKWARD_GATHER_MS} ms (PERF.md row "
                             f"7, its chip_smoke.py phase 2)")
            line += " ok" if ok else " FAIL"
            print(line)
            check(ok, line)
    for rec in timed.values():
        del rec["alone"]
    record = timed[torch.float32]
    record["fp64"] = {k: timed[torch.float64][k] for k in
                      ("ms", "cold_ms", "no_re_ms", "plain_ms", "bound_ms",
                       "bound_by", "max_abs_err", "kernel_ms",
                       "kernel_share_of_bound")}
    return record


# the stage backward's device ms at the 1024^2 buffer, fp32, stage 2 with
# d/dre, as the gather of one thread an output point took it (this script's
# phase 2 on "NVIDIA H100 80GB HBM3, 700.00 W"): beside the new kernel's
STAGE_BACKWARD_GATHER_MS = 0.0288


def stage_backward_timing(ck, args, err):
    """The stage backward's warm, L2-flushed, no-Re and plain device times
    and its bound: g, wt and s read once, gw, gwt and gs written once, the
    wall vectors, their cotangents and gradients once each."""
    wt, s, walls, g, h, stage = args[:6]
    call = lambda: ck.cavity_fused_stage_backward(*args)
    ms, call_ms = median_ms(call)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    cold_ms, _ = median_ms(call, before=flush.zero_)
    del flush
    no_re_ms, _ = median_ms(
        lambda: ck.cavity_fused_stage_backward(*args, re_grad=False))
    plain_ms, _ = median_ms(lambda: ck.cavity_fused_stage_backward_plain(
        *args), reps=10)
    fields = (6 if stage != 1 else 5) * wt.numel() * wt.element_size()
    vectors = 3 * nbytes(*walls)
    b = bound(fields + vectors, FLOPS_ARAKAWA_BACKWARD * wt.numel(), ms)
    us, per_call, others = kernel_alone(call, "cavity_stage_backward_kernel")
    return {"name": "cavity_stage_backward", "route": "cuda",
            "source": "cfd_julia_torch/csrc/cavity_stage.cu",
            "replaces": ("cfd_julia_tpu/models/cavity_fused.py:153 (jax.grad "
                         "of the XLA-fused stage; no TPU kernel)"),
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": None,
            "cold_ms": cold_ms, "no_re_ms": no_re_ms, "call_ms": call_ms,
            "kernel_ms": None if us is None else us * 1e-3,
            "kernel_share_of_bound": None if us is None
            else b["bound_ms"] * 1e3 / us,
            "alone": alone_text(us, per_call, others, b["bound_ms"])}


# the half-spectrum vortex step's stage passes (csrc/vortex_stage.cu):
# their LAUNCHES keys, and the launches a step of each spectral solver
# (ps23 and ps32 each pass once a stage, hybrid the combine alone; fdm
# kernel 1 three times)
VORTEX_PASSES = ("vortex_derivs_half", "vortex_product", "vortex_cn_combine")
# ps23 and ps32 on one device also execute the inverse's cuFFT plans
# (ops/fft_plans.HalfInverse) a Jacobian: the kx transform (ps23's one a
# field, its buffer being ky fastest) and the c2r; ps32 also its
# truncation pass
VORTEX_PLANNED = (*VORTEX_PASSES, "fft_c2c", "fft_c2r")
VORTEX_STEP_LAUNCHES = {"ps23": {**dict.fromkeys(VORTEX_PLANNED, 3),
                                 "fft_c2c": 12},
                        "ps32": dict.fromkeys((*VORTEX_PLANNED,
                                               "vortex_truncate_32"), 3),
                        "hybrid": {"vortex_cn_combine": 3},
                        "fdm": {"arakawa_rhs": 3}}
# steps of phase 9's kernel-against-twin run of each spectral solver
VORTEX_TWIN_STEPS = 20
# flops an output element of a pass needs, counted from
# csrc/vortex_stage.cu: (a) k2, m and the four g (two divisions) shared by
# four complex outputs, 8 products; (b) 3; (c) per complex value 3 (stage
# 1) or 5 (stages 2, 3) a component
FLOPS_DERIVS, FLOPS_PRODUCT = 22, 3
# a pass that is not bitwise its twin: max|k-p| allowed, of max|p|
VORTEX_PASS_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
VORTEX_REPLACES = ("cfd_julia_tpu/models/vortex.py:392 (make_spectral_step_"
                   "half's stage math, XLA-fused; not a Pallas kernel)")


def derivs_bound(rows, nb, itemsize, ms):
    """(a)'s bound: H's nb columns read once, the four spectra written
    once, the row and column tables read once."""
    n_bytes = (5 * 2 * rows * nb + 3 * (rows + nb)) * itemsize
    return bound(n_bytes, FLOPS_DERIVS * rows * nb, ms)


def derivs_buffer_bound(rows, nb, cols, r_out, itemsize, ms):
    """(a)'s buffer mode: H's nb columns and the tables read once, the
    (cols, 4, r_out) values the plans read written once, zeros included
    (not a pitched row's tail, which the pass writes too)."""
    n_bytes = (2 * rows * nb + 8 * cols * r_out + 3 * (rows + nb)) * itemsize
    return bound(n_bytes, FLOPS_DERIVS * rows * nb, ms)


def truncate_bound(nx, hy, itemsize, ms):
    """(d)'s bound: the (nx, hy) values it keeps of jf and the table read
    once, the Jacobian written once; 6 flops a complex value."""
    return bound(5 * nx * hy * itemsize, 6 * nx * hy, ms)


def product_bound(n, itemsize, ms):
    """(b)'s bound: four fields read once, the product written once."""
    return bound(5 * n * itemsize, FLOPS_PRODUCT * n, ms)


def combine_bound(n, stage, itemsize, ms):
    """(c)'s bound on n complex values: H, j1 (and j0 from stage 2) and
    the real tables a, b (and r) read once, the state written once."""
    terms = 2 if stage == 1 else 3
    n_bytes = ((terms + 1) * 2 + terms) * n * itemsize
    return bound(n_bytes, (2 * terms - 1) * 2 * n, ms)


def vortex_stage_cases(dev):
    """(label, cfg, band, rows, nb, scale, kx_major) of the derivative
    pass's checks: ps23's 2048^2 band as its step runs it (H stored column
    by column, as torch.fft.rfft2 returns it, and the inverse's 1/(nx ny)
    in the scale) and the same row by row, ps32's full width (its scale
    over the 3072^2 inverse's size), a 2x2 mesh rank's row slab (the band
    in the masks, all columns), a non-square grid both ways (an inexact
    scale), and a 3x4 grid whose output plane is odd (the one-value-a-
    thread path)."""
    from cfd_julia_torch.models import vortex

    def cfg(nx, ny):
        return vortex.VortexConfig(nx=nx, ny=ny, solver="ps23", dt=1e-3,
                                   re=1000.0)

    big = cfg(VORTEX_NX, VORTEX_NX)
    band = ((2 * VORTEX_NX) // 3) // 2
    hy = VORTEX_NX // 2 + 1
    quarter = VORTEX_NX // 4
    every = slice(None)
    return [("ps23 band", big, True, every, band, 1.0 / VORTEX_NX ** 2, True),
            ("ps23 band row by row", big, True, every, band,
             1.0 / VORTEX_NX ** 2, False),
            ("ps32 full width", big, False, every, hy,
             2.25 / (3 * VORTEX_NX // 2) ** 2, True),
            ("mesh row slab", big, True, slice(quarter, 2 * quarter), hy,
             1.0, False),
            ("48x40 band", cfg(48, 40), True, every, 13, 1.0 / 1920, True),
            ("48x40 full width", cfg(48, 40), False, every, 21, 2.25, False),
            ("3x4 odd plane", cfg(3, 4), False, every, 3, 1.0, True)]


# (label, nx, ny, solver, H column by column) of the buffer mode's checks:
# the ps23 and ps32 steps' 2048^2 layouts, a ps23 buffer of odd row count
# (one value a thread) from H row by row, and ps32 at 48x40
VORTEX_BUFFER_CASES = [("ps23", VORTEX_NX, VORTEX_NX, "ps23", True),
                       ("ps32", VORTEX_NX, VORTEX_NX, "ps32", True),
                       ("ps23 33x48 row by row", 33, 48, "ps23", False),
                       ("ps32 48x40", 48, 40, "ps32", True)]


def planned_layout(nx, ny, solver, dtype, ky_fastest=None, dev="cuda"):
    """(the buffer mode's keywords, the inverse) of the single-device
    ps23 / ps32 step in its layout (models/vortex.py make_spectral_step_
    half: ps23 ky fastest with pitched rows, ps32 kx fastest) or, with
    ky_fastest, in the one named."""
    from cfd_julia_torch.ops import fft_plans

    if ky_fastest is None:
        ky_fastest = solver == "ps23"
    if solver == "ps23":
        nb = ((2 * ny) // 3) // 2
        kw = dict(nb=nb, scale=1.0 / (nx * ny), cols=ny // 2 + 1, pad_rows=0)
        inv = fft_plans.HalfInverse(4, nx, ny, nb, dtype, dev, ky_fastest)
    else:
        nxe, nye = 3 * nx // 2, 3 * ny // 2
        kw = dict(nb=ny // 2, scale=2.25 / (nxe * nye), cols=nye // 2 + 1,
                  pad_rows=nxe - nx)
        inv = fft_plans.HalfInverse(4, nxe, nye, ny // 2, dtype, dev,
                                    ky_fastest)
    if ky_fastest:
        # the rows' pitch, which the pass writes whole
        kw.update(ky_fastest=True, cols=inv.buffer.shape[-1])
    return kw, inv


def planned_inputs(nx, ny, solver, kx, dtype, seed=0, dev="cuda"):
    """(H, rowk, colk, the buffer mode's keywords, the inverse) as the
    single-device ps23 / ps32 step makes them (planned_layout); H the half
    spectrum of a seeded real field, as the step's (the c2r reads a
    Hermitian ky = 0 column)."""
    from cfd_julia_torch.models import vortex

    cfg = vortex.VortexConfig(nx=nx, ny=ny, solver=solver, dt=1e-3,
                              re=1000.0)
    H = torch.fft.rfft2(torch.as_tensor(
        np.random.default_rng(nx + ny + seed).standard_normal((nx, ny)),
        dtype=dtype, device=dev)).contiguous()
    rowk, colk = vortex._deriv_tables(cfg, dtype, dev, band=solver == "ps23")
    kw, inv = planned_layout(nx, ny, solver, dtype, dev=dev)
    return kx_major(H) if kx else H, rowk, colk, kw, inv


def kx_major(t):
    """t stored column by column (each (rows, cols) plane's rows
    together), as torch.fft.rfft2 returns a half spectrum on the GPU."""
    return t.mT.contiguous().mT


def complex_field(shape, dtype, seed, dev="cuda"):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(z, device=dev).to(
        torch.complex128 if dtype == torch.float64 else torch.complex64)


def pass_check(ck, name, call, plain, dtype, exact=False):
    """A pass against its twin: (ok, text, max|k-p|, the kernel's output);
    two calls bitwise equal, two launches counted, bitwise the twin or
    (unless exact) within VORTEX_PASS_TOL of max|twin|."""
    before = ck.LAUNCHES[name]
    got, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    same, bitwise = torch.equal(got, again), torch.equal(got, ref)
    ok = (same and ck.LAUNCHES[name] == before + 2 and got.dtype == ref.dtype
          and got.shape == ref.shape
          and (bitwise or (not exact
                           and err <= VORTEX_PASS_TOL[dtype] * scale)))
    text = (f"max|k-p|={err:.3e} of max|p|={scale:.3e} ("
            f"{'bitwise the twin' if bitwise else 'NOT bitwise'}, tol "
            f"{VORTEX_PASS_TOL[dtype]:g}); two calls bitwise equal: {same}")
    return ok, text, err, got


def phase_vortex_stage_kernels():
    """The three stage passes of the half-spectrum vortex step against their
    twins in fp32 and fp64 (vortex_stage_cases for the derivative pass; the
    product at 2048^2, 3072^2 (ps32's grid), 48x40 and 3x5; the combine at
    stages 1 and 2 on 2048x1025, 48x21, 3x5 and a row slab whose tables
    start off a 16-byte boundary), two calls bitwise equal; the
    derivative pass's buffer mode (VORTEX_BUFFER_CASES) and ps32's
    truncation, bitwise; a non-contiguous constant refused; each timed at
    its main path's shape in fp32 beside its twin, its bound and, for the
    derivative pass, one torch.mul of a precomputed complex table.
    Returns the four records (derivs, product, combine, truncation)."""
    from cfd_julia_torch.models import vortex
    from cfd_julia_torch.ops import cuda_kernels as ck

    dev = "cuda"
    timed = {}
    for dtype in (torch.float32, torch.float64):
        for k, (label, cfg, band, rows, nb, scale, kx) in enumerate(
                vortex_stage_cases(dev)):
            rowk, colk = vortex._deriv_tables(cfg, dtype, dev, band=band)
            rowk = rowk[rows]
            H = complex_field((cfg.nx, cfg.ny // 2 + 1), dtype, 40 + k)[rows]
            H = kx_major(H) if kx else H
            args = (H, rowk, colk, nb, scale)
            ok, text, err, got = pass_check(
                ck, "vortex_derivs_half",
                lambda: ck.vortex_derivs_half(*args),
                lambda: ck.vortex_derivs_half_plain(*args), dtype)
            ok = ok and got.mT.is_contiguous() == kx
            line = (f"phase 2 kernel vortex_derivs_half {label} H "
                    f"{tuple(H.shape)} strides {H.stride()} nb={nb} "
                    f"scale={scale:g} {str(dtype)[6:]}: {text}; spectra "
                    f"strides {got.stride()}")
            if dtype == torch.float32 and label in ("ps23 band",
                                                    "ps32 full width"):
                g = ck._deriv_g(rowk, colk, nb, scale)
                ig = kx_major(torch.complex(torch.zeros_like(g), g))
                hb = H[:, :nb]
                ms, _ = median_ms(lambda: ck.vortex_derivs_half(*args))
                plain_ms, _ = median_ms(
                    lambda: ck.vortex_derivs_half_plain(*args))
                lib_ms, _ = median_ms(lambda: torch.mul(ig, hb))
                b = derivs_bound(H.shape[0], nb, 4, ms)
                timed[label] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, **b,
                                "library_ms": lib_ms}
                line += vortex_timing_text(timed[label],
                                           "torch.mul(i g, H[:, :nb])")
                del g, ig, hb
            print(line + (" ok" if ok else " FAIL"))
            check(ok, line)
            del rowk, colk, H, got
        for shape in [(VORTEX_NX, VORTEX_NX), (3 * VORTEX_NX // 2,) * 2,
                      (48, 40), (3, 5)]:
            phys = torch.as_tensor(np.random.default_rng(sum(shape))
                                   .standard_normal((4, *shape)),
                                   dtype=dtype, device=dev)
            ok, text, err, got = pass_check(
                ck, "vortex_product", lambda: ck.vortex_product(phys),
                lambda: ck.vortex_product_plain(phys), dtype)
            line = (f"phase 2 kernel vortex_product {shape[0]}x{shape[1]} "
                    f"{str(dtype)[6:]}: {text}")
            if dtype == torch.float32 and shape[0] >= VORTEX_NX:
                ms, _ = median_ms(lambda: ck.vortex_product(phys))
                plain_ms, _ = median_ms(lambda: ck.vortex_product_plain(phys))
                b = product_bound(got.numel(), 4, ms)
                timed[shape] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, **b,
                                "library_ms": None}
                line += vortex_timing_text(timed[shape], None)
            print(line + (" ok" if ok else " FAIL"))
            check(ok, line)
            del phys, got
        hy = VORTEX_NX // 2 + 1
        for shape, rows, kx in [((VORTEX_NX, hy), slice(None), True),
                                ((VORTEX_NX, hy), slice(None), False),
                                ((48, 21), slice(None), True),
                                ((3, 5), slice(None), False),
                                ((VORTEX_NX, hy), slice(1, VORTEX_NX // 4),
                                 False)]:
            rng = np.random.default_rng(shape[0] + rows.start
                                        if rows.start else shape[0])
            order = kx_major if kx else (lambda t: t)
            tables = [order(torch.as_tensor(rng.uniform(0.5, 1.0, shape),
                                            dtype=dtype, device=dev)[rows])
                      for _ in range(3)]
            a, r, b = tables
            h, j0, j1 = (order(complex_field(shape, dtype, 60 + i)[rows])
                         for i in range(3))
            for stage in (1, 2):
                args = (a, h, r, j0, b, j1) if stage == 2 else \
                    (a, h, None, None, b, j1)
                ok, text, err, got = pass_check(
                    ck, "vortex_cn_combine",
                    lambda: ck.vortex_cn_combine(*args),
                    lambda: ck.vortex_cn_combine_plain(*args), dtype)
                where = " (rows 1.. of a table)" if rows.start else ""
                line = (f"phase 2 kernel vortex_cn_combine stage {stage} "
                        f"{tuple(h.shape)}{where} strides {h.stride()} "
                        f"{str(dtype)[6:]}: {text}")
                if dtype == torch.float32 and shape[0] == VORTEX_NX and \
                        rows.start is None and kx:
                    ms, _ = median_ms(lambda: ck.vortex_cn_combine(*args))
                    plain_ms, _ = median_ms(
                        lambda: ck.vortex_cn_combine_plain(*args))
                    bd = combine_bound(h.numel(), stage, 4, ms)
                    timed[stage] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms, **bd,
                                    "library_ms": None}
                    line += vortex_timing_text(timed[stage], None)
                print(line + (" ok" if ok else " FAIL"))
                check(ok, line)
            del tables, a, r, b, h, j0, j1, got
        # the derivative pass's buffer mode, bitwise; into a caller's
        # buffer of NaN at 2048^2 (every element written)
        for label, nx, ny, solver, kx in VORTEX_BUFFER_CASES:
            H, rowk, colk, kw, inv = planned_inputs(nx, ny, solver, kx,
                                                    dtype)
            ky = kw.get("ky_fastest", False)
            ok, text, err, got = pass_check(
                ck, "vortex_derivs_half",
                lambda: ck.vortex_derivs_half(H, rowk, colk, **kw),
                lambda: ck.vortex_derivs_half_plain(H, rowk, colk, **kw),
                dtype, True)
            if nx == VORTEX_NX:
                # every element written
                inv.buffer.fill_(float("nan"))
                into = ck.vortex_derivs_half(H, rowk, colk, **kw,
                                             out=inv.buffer)
                ok = ok and into is inv.buffer and torch.equal(into, got)
            line = (f"phase 2 kernel vortex_derivs_half buffer mode {label} "
                    f"{tuple(got.shape)} ({'ky' if ky else 'kx'} fastest, "
                    f"the c2r reads {inv.n // 2 + 1} columns), nb={kw['nb']},"
                    f" pad rows {kw['pad_rows']}, {str(dtype)[6:]}: {text}")
            if dtype == torch.float32 and nx == VORTEX_NX:
                ms, _ = median_ms(lambda: ck.vortex_derivs_half(
                    H, rowk, colk, **kw, out=inv.buffer))
                plain_ms, _ = median_ms(
                    lambda: ck.vortex_derivs_half_plain(H, rowk, colk, **kw))
                b = derivs_buffer_bound(nx, kw["nb"], inv.n // 2 + 1,
                                        nx + kw["pad_rows"], 4, ms)
                timed[f"buffer {label}"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                    "library_ms": None,
                    "shape": f"{solver} {nx}^2: buffer {tuple(got.shape)}"}
                line += vortex_timing_text(timed[f"buffer {label}"], None)
            print(line + (" ok" if ok else " FAIL"))
            check(ok, line)
            del H, rowk, colk, inv, got
        # ps32's truncation pass on rfft2's 3/2-grid output, jf and the
        # table (so the result) in either memory order, bitwise
        for nx, ny in [(VORTEX_NX, VORTEX_NX), (48, 40)]:
            nxe, nye = 3 * nx // 2, 3 * ny // 2
            jf = torch.fft.rfft2(torch.as_tensor(
                np.random.default_rng(nx).standard_normal((nxe, nye)),
                dtype=dtype, device=dev))
            cfg = vortex.VortexConfig(nx=nx, ny=ny, solver="ps32", dt=1e-3,
                                      re=1000.0)
            table = vortex._half_consts(cfg, dtype, dev)[3] / 2.25
            for j, t in [(jf, kx_major(table)), (jf.contiguous(), table),
                         (jf.contiguous(), kx_major(table))]:
                ok, text, err, got = pass_check(
                    ck, "vortex_truncate_32",
                    lambda: ck.vortex_truncate_32(j, t),
                    lambda: ck.vortex_truncate_32_plain(j, t), dtype, True)
                ok = ok and got.stride() == t.stride()
                line = (f"phase 2 kernel vortex_truncate_32 {nx}x{ny} from "
                        f"jf {tuple(j.shape)} strides {j.stride()}, table "
                        f"strides {t.stride()} {str(dtype)[6:]}: {text}")
                if dtype == torch.float32 and nx == VORTEX_NX and \
                        j is jf:
                    ms, _ = median_ms(lambda: ck.vortex_truncate_32(j, t))
                    plain_ms, _ = median_ms(
                        lambda: ck.vortex_truncate_32_plain(j, t))
                    b = truncate_bound(nx, ny // 2 + 1, 4, ms)
                    timed["truncate"] = {"max_abs_err": err, "ms": ms,
                                         "plain_ms": plain_ms, **b,
                                         "library_ms": None}
                    line += vortex_timing_text(timed["truncate"], None)
                print(line + (" ok" if ok else " FAIL"))
                check(ok, line)
                del got
            del jf, table
    # a constant that is not contiguous, and operands of mixed memory
    # orders, are refused, nothing launched
    cfg = vortex_stage_cases(dev)[4][1]
    rowk, colk = vortex._deriv_tables(cfg, torch.float32, dev)
    H = complex_field((cfg.nx, cfg.ny // 2 + 1), torch.float32, 7)
    a = torch.ones(H.shape, device=dev)
    before = dict(ck.LAUNCHES)
    refused = []
    for call in [lambda: ck.vortex_derivs_half(H, rowk.mT.contiguous().mT,
                                               colk, 21),
                 lambda: ck.vortex_derivs_half(H, rowk, colk[::2], 10),
                 lambda: ck.vortex_cn_combine(a, kx_major(H), None, None, a,
                                              H)]:
        try:
            call()
        except ValueError as e:
            refused.append("contiguous" in str(e) or "order" in str(e))
    ok = refused == [True, True, True] and ck.LAUNCHES == before
    line = (f"phase 2 kernel vortex stage passes: non-contiguous row and "
            f"column tables, spectra of mixed memory orders refused "
            f"{refused}, launches unchanged: {ck.LAUNCHES == before} "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    src = "cfd_julia_torch/csrc/vortex_stage.cu"
    derivs = {"name": "vortex_derivs_half", "route": "cuda", "source": src,
              "replaces": VORTEX_REPLACES, "launches": None,
              **timed["ps23 band"], "shape": "ps23 2048^2: H (2048, 1025), "
              "682 band columns, fp32",
              "full_width": {**timed["ps32 full width"],
                             "shape": "ps32 2048^2: all 1025 columns"},
              "buffer_ps23": timed["buffer ps23"],
              "buffer_ps32": timed["buffer ps32"]}
    product = {"name": "vortex_product", "route": "cuda", "source": src,
               "replaces": VORTEX_REPLACES, "launches": None,
               **timed[(VORTEX_NX, VORTEX_NX)], "shape": "(4, 2048, 2048) "
               "fp32", "at_3072": timed[(3 * VORTEX_NX // 2,) * 2]}
    combine = {"name": "vortex_cn_combine", "route": "cuda", "source": src,
               "replaces": VORTEX_REPLACES, "launches": None, **timed[2],
               "shape": "stage 2 (2048, 1025) complex64", "stage_1": timed[1]}
    truncate = {"name": "vortex_truncate_32", "route": "cuda", "source": src,
                "replaces": VORTEX_REPLACES, "launches": None,
                **timed["truncate"], "shape": "ps32 2048^2: jf (3072, 1537) "
                "column by column -> (2048, 1025) complex64"}
    return derivs, product, combine, truncate


# the planned inverse against its plain version, of max|plain|
PLAN_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def phase_vortex_inverse():
    """The inverses of the half-spectrum step at 2048^2 (ps32's on its
    3072^2 grid), four fields: the twin route's (torch.fft: ps23's
    irfft2_band of 682 columns stored column by column, beside irfft2 of
    the same spectra padded to all 1025 columns row by row; ps32's irfft2
    of pad_32_half) and the planned route's (ops/fft_plans.HalfInverse on
    the derivative pass's buffer).  For each planned inverse, fp32 and
    fp64: each plan against its plain version (PLAN_TOL of max), two
    executions bitwise equal, the inverse against the twin route's
    transform of the same spectra; in fp32 device ms of the inverse alone,
    of the derivative pass and the inverse together, and of the twin
    route's transform.  Returns ({name: (call, ms)} for a profile by
    kernel, the planned inverses' record)."""
    from cfd_julia_torch.ops import cuda_kernels as ck
    from cfd_julia_torch.ops import fft_plans, spectral

    n, hy = VORTEX_NX, VORTEX_NX // 2 + 1
    nb = ((2 * n) // 3) // 2
    full = complex_field((4, n, hy), torch.float32, 70)
    full[..., nb:] = 0
    band = kx_major(full[..., :nb])
    calls = {"irfft2_band": lambda: spectral.irfft2_band(band, n, n,
                                                         norm="forward"),
             "irfft2": lambda: spectral.irfft2(full, n, n, norm="forward")}
    diff = float((calls["irfft2_band"]() - calls["irfft2"]()).abs().max())
    ms = {name: median_ms(call)[0] for name, call in calls.items()}
    print(f"phase 2 vortex inverse {n}^2 fp32, 4 fields: irfft2_band of "
          f"{nb} columns stored column by column {ms['irfft2_band']:.4f} "
          f"ms, irfft2 of all {hy} columns row by row {ms['irfft2']:.4f} ms "
          f"(norm=\"forward\"; medians of 30 calls, CUDA events); max "
          f"difference {diff:.3e}")
    record = {}
    for solver in ("ps23", "ps32"):
        for dtype in (torch.float32, torch.float64):
            tol = PLAN_TOL[dtype]
            H, rowk, colk, kw, inv = planned_inputs(n, n, solver, True, dtype)
            spec = ck.vortex_derivs_half(H, rowk, colk, **kw)
            x, want = spec.clone(), spec.clone()
            for k in range(4) if inv.ky_fastest else [slice(None)]:
                fft_plans.execute(inv.c2c, x[k], x[k])
                fft_plans.execute_plain(inv.c2c, want[k], want[k])
            e_c2c = float((x - want).abs().max() / want.abs().max())
            out = fft_plans.execute(inv.c2r, x.clone(),
                                    torch.empty_like(inv.out))
            want = fft_plans.execute_plain(inv.c2r, x,
                                           torch.empty_like(inv.out))
            e_c2r = float((out - want).abs().max() / want.abs().max())
            del x, want, out
            first = inv(spec.clone()).clone()
            same = torch.equal(inv(spec.clone()), first)
            planes = ck._from_buffer(spec, n, kw["nb"], kw["pad_rows"],
                                     inv.ky_fastest)
            if solver == "ps23":
                # stored column by column, as the twin route's step has them
                planes = kx_major(planes)

                def twin(planes=planes):
                    return spectral.irfft2_band(planes, n, n, norm="forward")
            else:
                ne = 3 * n // 2
                planes = torch.cat([planes, planes.new_zeros((4, n, 1))], -1)

                def twin(planes=planes, ne=ne):
                    return spectral.irfft2(spectral.pad_32_half(
                        planes, n, ne, ne), ne, ne, norm="forward")
            ref = twin()
            e_twin = float((first - ref).abs().max() / ref.abs().max())
            del ref
            ok = (e_c2c <= tol and e_c2r <= tol and e_twin <= tol and same
                  and bool(torch.isfinite(first).all()))
            line = (f"phase 2 vortex planned inverse {solver} {n}^2 "
                    f"{str(dtype)[6:]}: buffer {tuple(spec.shape)} ("
                    f"{'ky' if inv.ky_fastest else 'kx'} fastest) -> fields "
                    f"{tuple(first.shape)}; the in-place c2c of "
                    f"{inv.c2c.batch} columns (stride {inv.c2c.istride}"
                    f"{', a field' if inv.ky_fastest else ''}) against its "
                    f"plain version {e_c2c:.3e} of max, "
                    f"the c2r (stride {inv.c2r.istride}) {e_c2r:.3e}, the "
                    f"inverse against the twin route's transform {e_twin:.3e}"
                    f" (tol {tol:g}); two executions bitwise equal: {same}")
            if dtype == torch.float32:
                inv_ms, _ = median_ms(lambda: inv(inv.buffer))
                both_ms, _ = median_ms(lambda: inv(ck.vortex_derivs_half(
                    H, rowk, colk, **kw, out=inv.buffer)))
                twin_ms, _ = median_ms(twin)
                # the layout the step does not take, for its choice
                okw, other = planned_layout(n, n, solver, dtype,
                                            not inv.ky_fastest)
                ck.vortex_derivs_half(H, rowk, colk, **okw, out=other.buffer)
                other_ms, _ = median_ms(lambda: other(other.buffer))
                del other
                record[solver] = {
                    "ms": inv_ms, "with_derivs_ms": both_ms,
                    "twin_route_ms": twin_ms, "other_layout_ms": other_ms,
                    "c2c_rel_err": e_c2c, "c2r_rel_err": e_c2r,
                    "twin_rel_err": e_twin,
                    "shape": f"buffer {tuple(spec.shape)} complex64"}
                calls[f"planned {solver}"] = (lambda inv=inv: inv(inv.buffer))
                ms[f"planned {solver}"] = inv_ms
                if solver == "ps32":
                    calls["twin ps32"], ms["twin ps32"] = twin, twin_ms
                line += (f"; device time: the planned inverse {inv_ms:.4f} "
                         f"ms (in the {'kx' if inv.ky_fastest else 'ky'} "
                         f"fastest layout {other_ms:.4f} ms), with the "
                         f"derivative pass into its buffer {both_ms:.4f} ms,"
                         f" the twin route's transform {twin_ms:.4f} ms "
                         f"(medians of 30 calls, CUDA events, warm L2)")
            print(line + (" ok" if ok else " FAIL"))
            check(ok, line)
            del H, rowk, colk, spec, first, planes
    return {name: (call, ms[name]) for name, call in calls.items()}, record


def vortex_timing_text(t, library):
    text = (f"; device time: kernel {t['ms']:.4f} ms ("
            f"{100 * t['share_of_bound']:.1f}% of its bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms")
    if library:
        text += f", {library} {t['library_ms']:.4f} ms"
    return text + " (medians of 30 calls, CUDA events, warm L2)"


# the tier GEMM (kernel 8): (M, N, K) of its paths (the fused tiers'
# 1024^3, the matmul tiers' 1023^3, on the scalar-load path) and tiny and
# ragged ones
TIER_SHAPES = [(NX, NX, NX), (NX - 1, NX - 1, NX - 1), (1, 1, 1),
               (15, 17, 13), (33, 47, 129), (130, 131, 129)]
# kernel vs twin, of max|C|: the same split, the kernel accumulating every
# pass in fp32 over K, the twin taking each pass in fp64
TIER_TOL = 1e-5


def tier_sines(n):
    """The sine matrices the tiers multiply at the 1024^2 cavity: the
    packed step's zero-extended one (n = 1024) or the interior one (n =
    1023), on the card."""
    from cfd_julia_torch.poisson import direct

    k = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")
    return torch.where((k[:, None] < NX) & (k[None, :] < NX),
                       direct._sine_entries(k[:, None], k[None, :], NX,
                                            torch.float32), 0.0)


def tier_library(a, b, passes):
    """The yardstick: the same passes as torch.mm on operands split
    beforehand, bf16 in and fp32 out (aten::mm.dtype, CUDA only), and the
    adds."""
    from cfd_julia_torch.ops import cuda_kernels

    ah, al = (t.bfloat16() for t in cuda_kernels._bf16_split(a))
    bh, bl = (t.bfloat16() for t in cuda_kernels._bf16_split(b))

    def mm(x, y):
        return torch.mm(x, y, out_dtype=torch.float32)

    if passes == 1:
        return lambda: mm(ah, bh)
    return lambda: mm(ah, bh) + mm(ah, bl) + mm(al, bh)


def tier_split_check(ck, x, transpose, passes):
    """tier_split of x (an operand read in place through its row stride)
    against _bf16_split, bitwise on the operand and 0 in the pad; the
    largest |kernel - reference| (0 when equal)."""
    rows, cols = (x.shape[1], x.shape[0]) if transpose else x.shape
    out_rows = -(-rows // (ck.TIER_BN if transpose else ck.TIER_BM)) * (
        ck.TIER_BN if transpose else ck.TIER_BM)
    kp = -(-cols // ck.TIER_BK) * ck.TIER_BK
    got = ck.tier_split(x, transpose, out_rows, kp, passes).float()
    ref = torch.zeros_like(got)
    for p, part in zip(range(got.shape[0]),
                       ck._bf16_split(x.t() if transpose else x)):
        ref[p, :rows, :cols] = part
    return float((got - ref).abs().max()), torch.equal(got, ref)


def tier_record_of(name, source, times, bd, err, plain_ms, lib_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": "cfd_julia_tpu/models/cavity_fused.py:120 and "
                        "cfd_julia_tpu/poisson/direct.py:133 (XLA's bf16_3x "
                        "/ default dot, not a Pallas kernel)",
            "launches": None, "max_abs_err": err, "ms": times,
            "plain_ms": plain_ms, **bd, "library_ms": lib_ms}


def phase_tier_kernel():
    """Kernel 8 against its twin at every shape, 1 and 3 passes, on seeded
    random operands and on the cavity's sine matrices, two calls bitwise
    equal, both as tier_matmul (both operands split a call) and through a
    TierPlan (the constant split once, the field read in place through its
    row stride); the split pass bitwise against _bf16_split in both roles.
    Timed at 1024^3 warm in L2: the split pass (the field of sx @ g, B
    role), the GEMM on split planes, a plan's product (split + GEMM: a
    Poisson solve's product), tier_matmul on raw operands, each beside its
    bound (bytes over HBM's rate, or tensor-core flops), the twins, the
    fp32 torch.matmul the tiers stand in for and the library yardstick.
    Returns the GEMM's and the split pass's records (3 passes)."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    timed = {}
    worst_split = 0.0
    for m, n, k in TIER_SHAPES:
        rng = np.random.default_rng(m * 31 + n * 7 + k)
        a = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                            device=dev)
        b = torch.as_tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                            device=dev)
        # the field read in place: the interior of a larger array
        wide = torch.as_tensor(rng.standard_normal((k + 2, n + 2)),
                               dtype=torch.float32, device=dev)
        g = wide[1:-1, 1:-1]
        cases = [("random", a, b)]
        if m == n == k and m >= NX - 1:
            sine = tier_sines(m)
            cases += [("S@g", sine, b), ("g@S", a, sine), ("S@S", sine, sine)]
        for passes in (1, 3):
            worst, same = 0.0, True
            for case, x, y in cases:
                got = ck.tier_matmul(x, y, passes)
                again = ck.tier_matmul(x, y, passes)
                ref = ck.tier_matmul_plain(x, y, passes)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                worst = max(worst, err / float(ref.abs().max()))
                same &= torch.equal(got, again)
                if (m, n, k) == TIER_SHAPES[0] and case == "S@g":
                    timed[passes] = (x, y, err)
            # plans: the constant on either side, the field strided
            plans = [("left", a, g, (k, n)), ("right", b, a, (m, k))]
            for side, const, field, shape in plans:
                plan = ck.TierPlan(const, passes, side, shape)
                got, again = plan(field), plan(field)
                ref = (ck.tier_matmul_plain(const, field, passes)
                       if side == "left" else
                       ck.tier_matmul_plain(field, const, passes))
                torch.cuda.synchronize()
                worst = max(worst, float((got - ref).abs().max())
                            / float(ref.abs().max()))
                same &= torch.equal(got, again)
            ok = worst <= TIER_TOL and same
            line = (f"phase 2 kernel tier_gemm {m}x{n}x{k} passes {passes} "
                    f"(tier_matmul: {', '.join(c[0] for c in cases)}; "
                    f"TierPlan left and right, strided field): "
                    f"max|k-p|/max|p| {worst:.3e} (tol {TIER_TOL:g}); two "
                    f"calls bitwise equal: {same} {'ok' if ok else 'FAIL'}")
            print(line)
            check(ok, line)
            for x, role in ((a, "A"), (b, "B"), (g, "B"), (g, "A")):
                err, equal = tier_split_check(ck, x, role == "B", passes)
                worst_split = max(worst_split, err)
                line = (f"phase 2 kernel tier_split {tuple(x.shape)} "
                        f"stride {x.stride(0)} role {role} passes {passes}: "
                        f"bitwise _bf16_split, 0 in the pad: {equal} "
                        f"{'ok' if equal else 'FAIL'}")
                if not equal:
                    print(line)
                check(equal, line)
    print(f"phase 2 kernel tier_split: bitwise _bf16_split at every shape, "
          f"role, stride and pass count ok")
    records = {}
    for passes, (sine, g, err) in timed.items():
        m, k = sine.shape
        n = g.shape[1]
        plan = ck.TierPlan(sine, passes, "left", (k, n))
        plan.split(g)
        planes = plan.a_planes.shape[0]
        gemm_ms, _ = median_ms(plan.gemm)
        product_ms, _ = median_ms(lambda: plan(g))
        raw_ms, _ = median_ms(lambda: ck.tier_matmul(sine, g, passes))
        split_ms, _ = median_ms(lambda: plan.split(g))
        kp = plan.b_planes.shape[2]
        split_plain_ms, _ = median_ms(lambda: ck.tier_split_plain(
            g, True, plan.b_planes.shape[1], kp, passes))
        plain_ms, _ = median_ms(lambda: ck.tier_matmul_plain(sine, g, passes))
        fp32_ms, _ = median_ms(lambda: torch.matmul(sine, g))
        lib_ms, _ = median_ms(tier_library(sine, g, passes))
        flops = passes * 2 * m * n * k
        out = plan.gemm()
        # the GEMM: the bf16 planes in once, C out once; the product and
        # tier_matmul: the fp32 operands in, C out
        gemm_bd = bound(nbytes(plan.a_planes, plan.b_planes, out), flops,
                        gemm_ms, BF16_FLOP_PER_S)
        product_bd = bound(nbytes(g, out), flops, product_ms, BF16_FLOP_PER_S)
        raw_bd = bound(nbytes(sine, g, out), flops, raw_ms, BF16_FLOP_PER_S)
        # a subtraction an element for the lo plane
        split_bd = bound(nbytes(g, plan.b_planes),
                         g.numel() * (planes - 1), split_ms)
        records[passes] = {
            "gemm": tier_record_of(
                "tier_gemm", "cfd_julia_torch/csrc/tier_gemm.cu", gemm_ms,
                gemm_bd, err, plain_ms, lib_ms)
            | {"passes": passes, "product_ms": product_ms,
               "product_bound_ms": product_bd["bound_ms"],
               "raw_ms": raw_ms, "raw_bound_ms": raw_bd["bound_ms"],
               "fp32_matmul_ms": fp32_ms},
            "split": tier_record_of(
                "tier_split", "cfd_julia_torch/csrc/tier_gemm.cu", split_ms,
                split_bd, 0.0, split_plain_ms, None) | {"passes": passes}}
        l2_mb = (m // ck.TIER_BM) * (n // ck.TIER_BN) * planes * (
            ck.TIER_BM + ck.TIER_BN) * kp * 2 / 1e6
        print(f"phase 2 kernel tier_gemm {NX}^3 passes {passes} device time "
              f"(S@g, the packed step's product): GEMM on split planes "
              f"{gemm_ms:.4f} ms warm in L2 ({flops / gemm_ms / 1e9:.1f} "
              f"TFLOP/s; bound {gemm_bd['bound_ms']:.4f} ms by "
              f"{gemm_bd['bound_by']}, {100 * gemm_bd['share_of_bound']:.1f}"
              f"% of it; {l2_mb:.1f} MB of panels from L2 a call); "
              f"TierPlan product (split + GEMM) {product_ms:.4f} ms (bound "
              f"{product_bd['bound_ms']:.4f}); tier_matmul on raw operands "
              f"(2 splits + GEMM) {raw_ms:.4f} ms (bound "
              f"{raw_bd['bound_ms']:.4f}); plain {plain_ms:.4f} ms, fp32 "
              f"torch.matmul {fp32_ms:.4f} ms, library (torch.mm bf16 -> "
              f"fp32 on pre-split operands + adds) {lib_ms:.4f} ms (medians "
              f"of 30 calls, CUDA events)")
        print(f"phase 2 kernel tier_split {n}^2 role B passes {passes} "
              f"device time: {split_ms:.4f} ms (bound "
              f"{split_bd['bound_ms']:.4f} ms by {split_bd['bound_by']}, "
              f"{100 * split_bd['share_of_bound']:.1f}% of it), plain "
              f"{split_plain_ms:.4f} ms")
    planes = tier_planes_kernel()
    for passes in (1, 3):
        # the main path's GEMM launches are the planes entry's: the record
        # times its most frequent epilogue (the next product's A planes,
        # twice a solve) and keeps fp32 C's beside it
        rec, ep = records[passes]["gemm"], planes[passes]
        a = ep["by_role"]["A"]
        rec |= {"fp32_c_ms": rec["ms"], "fp32_c_bound_ms": rec["bound_ms"],
                "ms": a["ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"],
                "share_of_bound": a["share_of_bound"],
                "plain_ms": ep["plain_ms"], "epilogues": ep}
    gemm, split = records[3]["gemm"], records[3]["split"]
    gemm["passes_1"] = records[1]["gemm"]
    split["passes_1"] = records[1]["split"]
    return gemm, split


# the GEMM's epilogues as a solve's chain uses them: the next product's A
# operand (G1, G3), its B operand transposed with / den (G2), fp32 u with
# * scale (G4)
TIER_EPILOGUES = (("A", "none"), ("B", "divide"), ("C", "scale"))


# the planes' representation error of op(C), relative to |op(C)|: bf16's
# unit roundoff for 1 pass (hi alone); 3 passes, lo = bf16(x - hi) with
# |x - hi| <= 2^-8 |x|, so hi + lo is within 2^-16 |x|; fp32 C (role
# "C") none
TIER_PLANES_U = {"C": 0.0, 1: 2.0**-8, 3: 2.0**-16}


def tier_planes_err(out, c, role, passes, table=None, scale=None):
    """An epilogue's output against the plain version: c the plain fp32 C
    before op, op / table or * scale (cuda_kernels._tier_op).  The kernel's
    C is within TIER_TOL max|C| of c, which op scales by w = 1/|table| or
    |scale| an element; fp32 C then differs from op(c) by that and the
    op's own rounding (2^-24 each side), bf16 planes (hi + lo in fp32; A,
    or B transposed) by u |op(C)| more.  Returns
    max((|out - op(c)| - (u + 2^-23) |op(c)|) / ((1 + u) max|C| w)), which
    holds at TIER_TOL."""
    from cfd_julia_torch.ops import cuda_kernels as ck

    want = ck._tier_op(c, table, scale)
    m, n = c.shape
    if role == "C":
        got, u = out, TIER_PLANES_U["C"]
    else:
        got = out.float().sum(0)
        got = got[:m, :n] if role == "A" else got[:n, :m].t()
        u = TIER_PLANES_U[passes]
    w = 1.0 / table.abs() if table is not None else \
        abs(scale) if scale is not None else 1.0
    excess = (got - want).abs() - (u + 2.0**-23) * want.abs()
    unit = (1.0 + u) * float(c.abs().max()) * w
    return max(float((excess / unit).max()), 0.0)


def tier_bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def tier_planes_kernel():
    """The GEMM's planes epilogue (TierPlan.gemm_into, csrc/tier_gemm.cu
    tier_gemm_tn_planes) bitwise tier_split(op(its fp32 C)) at every
    TIER_SHAPES shape, 1 and 3 passes, through plans on either side, in
    each epilogue (A and B planes, fp32 C) with each op (none, / table,
    * scale), one launch a call, two calls bitwise; then, at the 1024^2
    packed cavity's solve (its plans, its -den, its scale; a random
    field), each epilogue of the chain held against its plain version
    (tier_planes_err within TIER_TOL) and timed beside it, beside its
    bound (tensor flops, or the bytes: the planes in once, the
    table once, the planes or C out once), beside today's GEMM + torch op
    + split pass for the same product, and beside bf16 torch.mm on
    pre-split operands (1 pass: row 8's library yardstick); and the
    solve chained (1 split + 4 GEMMs) against the per-product one (4
    splits, 4 GEMMs, / and *), bitwise, both timed.  Returns {passes:
    record}."""
    import dataclasses

    from cfd_julia_torch.models import cavity, cavity_fused
    from cfd_julia_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    for m, n, k in TIER_SHAPES:
        rng = np.random.default_rng(m * 13 + n * 5 + k)

        def rand(shape):
            return torch.as_tensor(rng.standard_normal(shape),
                                   dtype=torch.float32, device=dev)

        table = (rand((m, n)).abs() + 0.5) * torch.where(
            rand((m, n)) > 0, 1.0, -1.0)
        scale = 4.0 / (m * n + 17)
        for passes in (1, 3):
            ok, n_calls = True, 0
            for side, const, field in (("left", rand((m, k)), rand((k, n))),
                                       ("right", rand((k, n)),
                                        rand((m, k)))):
                plan = ck.TierPlan(const, passes, side, tuple(field.shape))
                plan.split(field)
                c = plan.gemm()
                for role in ("A", "B", "C"):
                    for kw in ({}, {"table": table}, {"scale": scale}):
                        want = ck._tier_op(c, **kw)
                        if role != "C":
                            want = ck.tier_split(
                                want, role == "B",
                                *ck.tier_plane_extents(role, m, n), passes)
                        before = ck.LAUNCHES["tier_gemm"]
                        got = plan.gemm_into(role, **kw)
                        again = plan.gemm_into(role, **kw)
                        torch.cuda.synchronize()
                        n_calls += 1
                        ok &= (ck.LAUNCHES["tier_gemm"] == before + 2
                               and torch.equal(tier_bits(got),
                                               tier_bits(want))
                               and torch.equal(tier_bits(got),
                                               tier_bits(again)))
            line = (f"phase 2 kernel tier_gemm_tn_planes {m}x{n}x{k} passes "
                    f"{passes}: {n_calls} epilogue x op cases (A and B "
                    f"planes, fp32 C; none, / table, * scale; plans on "
                    f"both sides) bitwise tier_split(op(fp32 C)), one "
                    f"launch a call, two calls bitwise: "
                    f"{ok} {'ok' if ok else 'FAIL'}")
            print(line)
            check(ok, line)

    records = {}
    cfg = cavity.CavityConfig(nx=NX, ny=NX)
    for passes in (1, 3):
        tier = "bf16x3" if passes == 3 else "bf16x1"
        solve = cavity_fused.make_solve_neg(
            dataclasses.replace(cfg, poisson=f"fused_{tier}"), torch.float32,
            dev)
        left, right, den = solve.left, solve.right, solve.den
        m, n, k = left.mnk
        rng = np.random.default_rng(passes)
        f = torch.as_tensor(rng.standard_normal(solve.shape),
                            dtype=torch.float32, device=dev)
        left.split(f)
        c_left = left.gemm()
        right.split(c_left)
        c_right = right.gemm()
        flops = passes * 2 * m * n * k
        a_ext = ck.tier_plane_extents("A", m, n)
        b_ext = ck.tier_plane_extents("B", m, n)
        cases = {
            # (the epilogue's call, today's GEMM + op + split, bytes, the
            # product's plain operands and op)
            "A": (lambda: left.gemm_into("A", right._field),
                  lambda: ck.tier_split(left.gemm(), False, *a_ext, passes,
                                        out=right._field),
                  nbytes(left.a_planes, left.b_planes, right._field),
                  (left.const, f), {}),
            "B": (lambda: right.gemm_into("B", left._field, table=den),
                  lambda: ck.tier_split(right.gemm() / den, True, *b_ext,
                                        passes, out=left._field),
                  nbytes(right.a_planes, right.b_planes, den, left._field),
                  (c_left, right.const), {"table": den}),
            "C": (lambda: right.gemm_into("C", scale=solve.scale),
                  lambda: right.gemm() * solve.scale,
                  nbytes(right.a_planes, right.b_planes, c_right),
                  (c_left, right.const), {"scale": solve.scale}),
        }
        # restore the planes each case reads before it is timed
        left.split(f)
        right.split(c_left)
        rec, plain_ok = {}, True
        for (role, _), (call, today, n_bytes, (a, b), kw) in zip(
                TIER_EPILOGUES, cases.values()):
            ms, _ = median_ms(call)
            got = call().clone()
            today_ms, _ = median_ms(today)
            plain_ms, _ = median_ms(lambda: ck.tier_gemm_planes_plain(
                a, b, passes, role, **kw))
            err = tier_planes_err(got, ck.tier_matmul_plain(a, b, passes),
                                  role, passes, **kw)
            plain_ok &= err <= TIER_TOL
            bd = bound(n_bytes, flops, ms, BF16_FLOP_PER_S)
            rec[role] = {"ms": ms, "gemm_op_split_ms": today_ms,
                         "plain_ms": plain_ms, "plain_err": err, **bd}
            left.split(f)
            right.split(c_left)
        gemm_ms, _ = median_ms(right.gemm)
        sine, field = tier_sines(NX), torch.as_tensor(
            rng.standard_normal((NX, NX)), dtype=torch.float32, device=dev)
        lib_ms, _ = median_ms(tier_library(sine, field, passes))
        got, want = solve(f), solve.products(f)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ck.reset_launch_counts()
        solve(f)
        counts = (ck.LAUNCHES["tier_split"], ck.LAUNCHES["tier_gemm"])
        solve_ms, _ = median_ms(lambda: solve(f))
        products_ms, _ = median_ms(lambda: solve.products(f))
        ok = same and counts == (1, 4) and plain_ok
        errs = ", ".join(f"{role} {rec[role]['plain_err']:.3e}"
                         for role, _ in TIER_EPILOGUES)
        line = (f"phase 2 tier solve {NX}^2 fused_{tier}: each epilogue "
                f"against its plain version (tier_gemm_planes_plain; "
                f"excess over the twin tolerance's unit, tier_planes_err) "
                f"{errs} (tol {TIER_TOL:g}); chained (1 split + "
                f"4 GEMMs, / den and * scale in the epilogues) bitwise the "
                f"per-product solve (4 splits, 4 GEMMs, / and *): {same}; "
                f"launches split {counts[0]}, GEMM {counts[1]} (want 1, 4); "
                f"device time chained {solve_ms:.4f} ms, per-product "
                f"{products_ms:.4f} ms (medians of 30 calls, CUDA events) "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
        for role, op in TIER_EPILOGUES:
            r = rec[role]
            print(f"phase 2 kernel tier_gemm_tn_planes {m}^3 passes {passes} "
                  f"epilogue {role} (op {op}): device time {r['ms']:.4f} ms ("
                  f"{100 * r['share_of_bound']:.1f}% of its bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']}); today's GEMM "
                  f"+ op + split {r['gemm_op_split_ms']:.4f} ms; plain "
                  f"{r['plain_ms']:.4f} ms; the GEMM "
                  f"alone (fp32 C) {gemm_ms:.4f} ms; library (bf16 torch.mm "
                  f"on pre-split operands + adds) {lib_ms:.4f} ms (medians of "
                  f"30 calls, CUDA events, warm L2)")
        records[passes] = {"passes": passes, "by_role": rec,
                           "gemm_ms": gemm_ms,
                           "plain_ms": rec["A"]["plain_ms"],
                           "library_ms": lib_ms, "solve_chained_ms": solve_ms,
                           "solve_per_product_ms": products_ms}
        del solve, left, right, den
    return records


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
        # the sum alone, as a solve's rms0 and unfused checks take it
        "residual_ssq": (
            lambda: ck.residual_ssq(u, f, dx, dy)[0],
            lambda: ck.residual_ssq_plain(u, f, dx, dy)[0]),
        "residual_ssq_r": (
            lambda: ck.residual_ssq(u, f, dx, dy, want_r=True),
            lambda: ck.residual_ssq_plain(u, f, dx, dy, want_r=True)),
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
        "residual_ssq": n * FLOPS_SQ_RESIDUAL,
        "residual_ssq_r": n * FLOPS_SQ_RESIDUAL,
    }[name]
    return nbytes(*ins, *outs), flops


def compare_outputs(got, ref, dtype):
    """(ok, text, max field error, or the sum's error where no field is
    compared) for a kernel's outputs against its twin's.  Fields: 1e-5 of max|twin| in fp32 (FMA contraction and
    operation order), 1e-12 in fp64, one bf16 ulp of max|twin| in bf16
    (both round an fp32 result once).  A residual sum (0-d) is held to
    rel 1e-5 (fp32 sums, fp32 and bf16 fields) or 1e-12 (fp64)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    ok, parts, field_err, sum_err = True, [], None, 0.0
    for g, r in zip(got, ref):
        if g.dtype != r.dtype or g.shape != r.shape:
            return False, f"dtype/shape {g.dtype}{tuple(g.shape)} vs " \
                          f"{r.dtype}{tuple(r.shape)}", float("inf")
        err = float((g.double() - r.double()).abs().max())
        scale = float(r.double().abs().max())
        if r.dim() == 0:
            rel = 1e-12 if dtype == torch.float64 else 1e-5
            tol, how = rel * scale, f"{rel:g}*|p|"
            sum_err = max(sum_err, err)
            parts.append(f"ssq |k-p|={err:.3e} |p|={scale:.6e} tol={how}")
        else:
            if dtype == torch.bfloat16:
                tol, how = bf16_ulp(scale), "1 bf16 ulp of max|p|"
            else:
                rel = 1e-12 if dtype == torch.float64 else 1e-5
                tol, how = rel * scale, f"{rel:g}*max|p|"
            field_err = max(field_err or 0.0, err)
            parts.append(f"{tuple(r.shape)} max|k-p|={err:.3e} "
                         f"max|p|={scale:.3e} tol={how}")
        ok = ok and err <= tol
    return ok, "; ".join(parts), sum_err if field_err is None else field_err


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
            names = MG_ANY_EXTENT if shape in RB_SHAPES else MG_CHECKED
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
                        rec, timed = mg_record(name, kernel, plain, got, u,
                                               f, uc, err)
                        if name == "residual_ssq_r":   # fmg's call
                            records["residual_ssq"]["with_r"] = {
                                k: rec[k] for k in ("ms", "plain_ms",
                                                    "bound_ms",
                                                    "max_abs_err")}
                        else:
                            records[name] = rec
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
                if shape in RB_TIMED and dtype == torch.float32 and \
                        name == "redblack_sweeps":
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
            "replaces": MG_KERNELS.get(name), "launches": None,
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


def max_diff(a, b):
    """max|a - b| over matching tensors (or tuples of tensors); inf on a
    shape or dtype mismatch."""
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    worst = 0.0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        worst = max(worst, float((x.double() - y.double()).abs().max())
                    if x.numel() else 0.0)
    return worst


def graph_text(diff, tol):
    """The graph-vs-eager verdict: bitwise equal, or a difference within
    the path's twin tolerance (the operation that differs is then named in
    PERF.md), or FAIL."""
    if diff == 0.0:
        return True, "max|graph-eager|=0 (bitwise equal)"
    ok = diff <= tol
    return ok, (f"max|graph-eager|={diff:.3e} NOT bitwise (tol {tol:g}) "
                f"{'within tolerance' if ok else 'FAIL'}")


# max|graph - eager| allowed where a path's two runs are not bitwise equal,
# of the field's scale: fp32 roundoff of 2000 steps, well inside the 1%
# anchors
CAVITY_GRAPH_TOL = 1e-4


def cavity_runs(step, state0):
    """A 1024^2 cavity path through the loop layer graphed (the main run)
    and with graph=False: 100 steps, then on to 2000 timed, the launch
    counts set to 0 before each run and read after it.  Returns (first,
    state, rms history, seconds of the timed steps, launches) of each."""
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import loop

    runs = {}
    for graph in (True, False):
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        first, rms_a = loop.run_steps(step, state0, STEPS_FIRST, graph=graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rms_b = loop.run_steps(step, first, STEPS_TOTAL - STEPS_FIRST,
                                      graph=graph)
        torch.cuda.synchronize()
        runs[graph] = (first, state, torch.cat([rms_a, rms_b]),
                       time.perf_counter() - t0, dict(cuda_kernels.LAUNCHES))
    return runs[True], runs[False]


def phase_main_path(poisson="auto", label="phase 3 cavity"):
    """The headline cavity on the port's default path: rhs_impl="auto"
    resolves to the CUDA kernel on a GPU; `poisson` names the Poisson
    solve (auto: the sine matmuls).  The graphed loop is the main run
    (100 steps, in which the 50-step chunk is captured, then 1900 timed
    replays), then the same with graph=False, each with its launch counts.
    Returns the main run's launch counts, the step, the final state, its
    seconds a step and its rms history."""
    from cfd_julia_torch.models import cavity

    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                              poisson=poisson)
    step = cavity.make_step_fn(cfg, torch.float32, "cuda")
    state0 = cavity.initial_state(cfg, torch.float32, "cuda")
    n = STEPS_TOTAL - STEPS_FIRST
    (first, state, rms, seconds, launches), \
        (e_first, e_state, e_rms, e_seconds, e_launches) = cavity_runs(
            step, state0)

    anchor_check(first[1], STEPS_FIRST, label)
    anchor_check(state[1], STEPS_TOTAL, label)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state[0], state[1], rms))
    check(finite, "cavity fields or rms history not finite")
    diff = max_diff((*first[:2], *state[:2], rms),
                    (*e_first[:2], *e_state[:2], e_rms))
    same, text = graph_text(diff, CAVITY_GRAPH_TOL * float(
        state[1].abs().max()))
    if diff:   # the eager run is then held to the anchors as well
        anchor_check(e_first[1], STEPS_FIRST, label + " eager")
        anchor_check(e_state[1], STEPS_TOTAL, label + " eager")
    line = (f"{label} {NX}^2 fp32: {n} steps (from step {STEPS_FIRST}) "
            f"graphed {n / seconds:.2f} steps/s ({seconds:.4f} s), eager "
            f"(graph=False) {n / e_seconds:.2f} steps/s ({e_seconds:.4f} s); "
            f"{text}; launches {launches}, eager run "
            f"{'the same' if e_launches == launches else e_launches}; "
            f"fields finite")
    print(line)
    check(same and e_launches == launches, line)
    check(launches["arakawa_rhs"] == 3 * STEPS_TOTAL,
          f"arakawa_rhs launched {launches['arakawa_rhs']} times, expected "
          f"3 x {STEPS_TOTAL} = {3 * STEPS_TOTAL}")
    return launches, step, state, seconds / n, rms, e_seconds / n


def profiled_kernels(run):
    """(device kernel events, host wall us) of run() under torch.profiler.
    A first run() under the profiler is its warm-up and is not recorded
    (without it the trace can miss the window's first kernels); the
    kernels' launch counts restart after it, so they count the recorded
    run alone."""
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
    return kernels, wall_us


def busy_us(kernels):
    """(us the device was running at least one of `kernels`, us from the
    first one's start to the last one's end)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def phase_profile(label, run, units, unit_s, unit="step"):
    """Device time by kernel over a short steady window (profiled_kernels):
    run() does `units` units of work; the busy share is taken against the
    unprofiled time of one unit, unit_s."""
    kernels, wall_us = profiled_kernels(run)
    if not kernels:
        print("profile: no device events recorded (device time not measured)")
        return
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    busy, span = busy_us(kernels)
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
    # sum_kernel also ends each residual_ssq call
    n_sum = kernel_sums(by_name, "sum_kernel")[1] - calls["residual_ssq"]
    up = kernel_sums(by_name, "sweep_tile_kernel")[1] + n_sum
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
    line, ok = profile_residual(by_name, calls, solves)
    print(line + (" ok" if ok else " FAIL"))
    check(ok, line)


def profile_residual(by_name, calls, solves):
    """The residual sum's device us a solve (its pass and its share of
    sum_kernel's launches) beside its bound at 4097^2 fp32 and twice it;
    the copies a solve; and whether the fused solve is free of a torch
    residual chain (no roll kernel) with one residual_ssq pass a call."""
    us, n = kernel_sums(by_name, "residual_ssq_kernel")
    sum_us, n_sum = kernel_sums(by_name, "sum_kernel")
    n_calls = calls["residual_ssq"]
    sums_us = sum_us / max(n_sum, 1) * n_calls
    # u and f read once, fp32
    bound_us = 2 * (MG_NX + 1) ** 2 * 4 / HBM_BYTES_PER_S * 1e6
    # device-to-device copies: cudaMemcpy's and torch's copy kernels
    copies = [v for name, v in by_name.items()
              if re.search(r"Memcpy DtoD|direct_copy", name)]
    rolls = [v for name, v in by_name.items() if "roll" in name]
    line = (f"profile multigrid {MG_NX}^2 rms0: residual_ssq_kernel "
            f"{us / solves:.2f} us/solve in {n} launches / {n_calls} calls, "
            f"its sums ~{sums_us / solves:.2f} us/solve (sum_kernel's mean "
            f"launch); {(us + sums_us) / solves:.2f} us/solve against a "
            f"bound of {bound_us:.2f} us a call (2x {2 * bound_us:.2f}); "
            f"copies {sum(u for u, _ in copies) / solves:.2f} us/solve in "
            f"{sum(c for _, c in copies) / solves:.1f} launches; roll "
            f"kernels {sum(c for _, c in rolls)}")
    return line, n == n_calls and n_calls > 0 and not rolls


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


def profile_stages(by_name, steps):
    """The stage kernel's device us a step by stage inside the profiled
    1024^2 step, with its launches and each stage's share of its bound
    (stage_bound) on the step's own clock."""
    parts = []
    for stage in (1, 2, 3):
        hits = [v for name, v in by_name.items()
                if re.search(rf"cavity_stage_kernel<float, {stage}>", name)]
        us = sum(u for u, _ in hits) / steps
        n = sum(c for _, c in hits)
        b = stage_bound(stage, NX, NX, 4, max(us, 1e-9) * 1e-3)
        parts.append(f"stage {stage} {us:.2f} us in {n} launches "
                     f"({100 * b['share_of_bound']:.1f}% of its bound "
                     f"{1e3 * b['bound_ms']:.2f} us)")
    print("profile cavity_stage_kernel by stage, a step: " + "; ".join(parts))


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


def cli_run(preset, timeout=900, outdir=None, extra=()):
    """`python -m cfd_julia_torch run <preset> --device cuda [extra]` into
    `outdir` (a temporary directory by default): its metrics, {file name:
    text} of what it wrote, and the process's seconds."""
    (result,), seconds = cli_runs(preset, [list(extra)], timeout,
                                  outdir and [outdir])
    return (*result, seconds)


def columns(files, name, skiprows=0):
    """The numeric columns of a text file a CLI run wrote."""
    check(name in files, f"CLI run wrote no {name}: {sorted(files)}")
    return np.loadtxt(files[name].splitlines(), skiprows=skiprows)


def ghia_deviations(files):
    """max|u - Ghia| and max|v - Ghia| on the centerlines a CLI cavity run
    wrote."""
    for name in ("res_plot.txt", "field_final.txt"):
        check(name in files, f"CLI run wrote no {name}")
    y, u, x, v = columns(files, "centerlines.txt", skiprows=1).T
    return (float(np.abs(np.interp(GHIA_Y, y, u) - GHIA_U).max()),
            float(np.abs(np.interp(GHIA_X, x, v) - GHIA_V).max()))


def phase_cli():
    """The reference case through the CLI against Ghia; returns (max|u -
    Ghia|, max|v - Ghia|) for phase 15's tiers."""
    metrics, files, seconds = cli_run("cavity")
    du, dv = ghia_deviations(files)
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
    return du, dv


def cli_runs(preset, extras, timeout=900, outdirs=None):
    """One `python -m cfd_julia_torch run <preset> --device cuda [extra]`
    process for each list in `extras`, all started together on the card,
    each into its directory of `outdirs` (temporary ones by default);
    [(metrics, {file name: text})] in that order, and the seconds until
    the last ended.  A failure stops the others."""
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(d) for d in outdirs] if outdirs else [
            Path(tmp) / str(i) for i in range(len(extras))]
        t0 = time.perf_counter()
        procs = [(out, subprocess.Popen(
            [sys.executable, "-m", "cfd_julia_torch", "run", preset,
             "--device", "cuda", "--outdir", str(out), *extra], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for out, extra in zip(outs, extras)]
        try:
            results = []
            for (out, proc), extra in zip(procs, extras):
                _, err = proc.communicate(timeout=timeout)
                check(proc.returncode == 0, f"CLI run {preset} {extra} "
                      f"exited {proc.returncode}: {err[-2000:]}")
                files = {p.name: p.read_bytes().decode(errors="replace")
                         for p in out.iterdir()}
                check("metrics.json" in files,
                      f"CLI run {preset} {extra} wrote no metrics.json")
                metrics = json.loads(files["metrics.json"])
                check(metrics["device"] == torch.cuda.get_device_name(),
                      f"CLI run {preset} ran on {metrics['device']}")
                results.append((metrics, files))
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return results, time.perf_counter() - t0


def expected_launches(n_levels, cycles, fused, fmg):
    """Wrapper calls the pyramid implies: a fused V-cycle over m levels
    calls each edge kernel m-1 times and the smoother once (coarsest); an
    unfused one calls the smoother 2(m-1)+1 times and the residual sum
    once (its check).  A solve's rms0 is one residual-sum call (with fmg
    the same call gives its right-hand side).  FMG restricts its
    right-hand side down n-1 edges (fused), smooths the coarsest level,
    and runs one V-cycle of each sub-pyramid on the way up."""
    e = dict.fromkeys(MG_KERNELS, 0)
    e["residual_ssq"] = 1 + (0 if fused else cycles)

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


def best_solve_time(solve, repeats=3):
    """(best, all) seconds of `repeats` synchronised solves after one
    untimed solve."""
    solve()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), times


def phase_multigrid():
    """The 4096^2 multigrid solve and its variants on the port's default
    path (impl="auto" resolves to the CUDA kernels; each cycle a replay of
    the captured V-cycle), each beside the same solve with graph=False.
    Returns {variant: launch counts} and {variant: (a callable of one
    solve, its best time)}.  Prints mixed's max|u - ue| over the fused
    fp32 solve's as information: the JAX package breaks the 1.5x contract
    there too (at 1024^2 on the CPU), so it belongs to the bf16 pyramid,
    and the gate holds mixed to its own twin."""
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

        def solve(mgc=mgc, graph=True):
            return multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc,
                                   graph=graph)

        runs = {}
        for graph in (True, False):
            cuda_kernels.reset_launch_counts()
            res = solve(graph=graph)
            torch.cuda.synchronize()
            runs[graph] = (res, dict(cuda_kernels.LAUNCHES))
        res, launches = runs[True]
        eager, e_launches = runs[False]
        twin = multigrid.solve(f, u0, cfg.dx, cfg.dy,
                               cfg=dataclasses.replace(mgc, impl="torch"))
        torch.cuda.synchronize()
        check(cuda_kernels.LAUNCHES == e_launches,
              f"the twin solve launched kernels: {cuda_kernels.LAUNCHES}")
        best, times = best_solve_time(solve)
        e_best, _ = best_solve_time(lambda mgc=mgc: solve(mgc, False))

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
        # graph vs eager: the same cycles, u and history; if not bitwise,
        # the eager solve is held to the same gates
        diff = max_diff((res.u, res.rms, res.history.nan_to_num(0.0)),
                        (eager.u, eager.rms, eager.history.nan_to_num(0.0)))
        same, gtext = graph_text(diff, twin_err)
        if diff:
            e_err = float((eager.u - ue).abs().max())
            gtext += f"; eager max|u-ue|={e_err:.3e}"
            same = same and e_err <= 1.5 * twin_err
        ok = (rel <= MG_TOL and rel_ind <= 4 * MG_TOL and finite
              and res.u.dtype == torch.float32
              and abs(res.iterations - twin.iterations) <= 1
              and err <= 1.5 * twin_err and launches == want
              and same and eager.iterations == res.iterations
              and e_launches == launches)
        line = (f"phase 5 multigrid {MG_NX}^2 poly fp32 {variant}: "
                f"{res.iterations} cycles (twin {twin.iterations}, tol +-1; "
                f"eager {eager.iterations}) rms/rms0={rel:.3e} (tol "
                f"{MG_TOL:g}) fp64 recheck {rel_ind:.3e} (tol "
                f"{4 * MG_TOL:g}); max|u-ue|={err:.3e} (twin "
                f"{twin_err:.3e}, tol 1.5x); graphed {best:.6f} s/solve best "
                f"of 3 [{', '.join(f'{t:.6f}' for t in times)}] = "
                f"{1e3 * best / max(res.iterations, 1):.4f} ms/cycle, eager "
                f"(graph=False) {e_best:.6f} s/solve; {gtext}; launches "
                f"{launches} (pyramid of {n_levels} levels: {want}), eager "
                f"run {'the same' if e_launches == launches else e_launches}"
                f" {'ok' if ok else 'FAIL'}")
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


def timed_steps(step, state, graph, n_first, n_total):
    """n_first steps through the loop layer (the capture, when graphed),
    then n_total - n_first timed ones between synchronisations; the state
    and the timed seconds."""
    from cfd_julia_torch.stepping import loop

    state = loop.advance(step, state, n_first, graph=graph)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.advance(step, state, n_total - n_first, graph=graph)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def phase_euler():
    """The three anchored Euler runs on the port's default path
    (rhs_impl="auto": the CUDA kernel, graphed), each beside the same run
    with graph=False and the graphed run on the twin.  Steps/s count steps
    100-2000 (the first 100 capture the chunk).  Returns {(solver, nx):
    launches}, the hllc 8192 step and state, and its seconds per step."""
    import dataclasses

    from cfd_julia_torch.models import euler1d
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import ssprk3

    counts, main = {}, None
    n = EULER_STEPS - STEPS_FIRST
    for solver, nx in EULER_RUNS:
        cfg = euler1d.EulerConfig(nx=nx, solver=solver, dt=euler_dt(nx))
        _, q0 = euler1d.sod_initial_state(cfg, torch.float32, "cuda")
        results = {}
        for label, impl, graph in (("graph", "auto", True),
                                   ("eager", "auto", False),
                                   ("twin", "torch", True)):
            rhs = euler1d.make_rhs(dataclasses.replace(cfg, rhs_impl=impl),
                                   "cuda")

            def step(q, rhs=rhs):
                return ssprk3.ssprk3_step(rhs, q, cfg.dt)

            torch.cuda.synchronize()
            cuda_kernels.reset_launch_counts()
            q, seconds = timed_steps(step, q0, graph, STEPS_FIRST,
                                     EULER_STEPS)
            results[label] = (q, seconds, dict(cuda_kernels.LAUNCHES), step)
        q, seconds, launches, step = results["graph"]
        q_eager, e_seconds, e_launches, _ = results["eager"]
        q_twin, twin_s, twin_launches, _ = results["twin"]
        ok, text = euler_anchor_check(q, solver, nx)
        diff = float((q - q_twin).abs().max())
        same, gtext = graph_text(max_diff(q, q_eager), EULER_TWIN_TOL)
        if not gtext.endswith("(bitwise equal)"):
            e_ok, e_text = euler_anchor_check(q_eager, solver, nx)
            same, gtext = same and e_ok, f"{gtext}; eager {e_text}"
        finite = bool(torch.isfinite(q).all())
        want = dict.fromkeys(launches, 0)
        want["euler_rhs"] = 3 * EULER_STEPS
        ok = (ok and finite and q.dtype == torch.float32
              and launches == want and not any(twin_launches.values())
              and diff <= EULER_TWIN_TOL and same and e_launches == launches)
        line = (f"phase 7 euler {solver} {nx} fp32 @{EULER_STEPS} steps "
                f"(dt={cfg.dt:g}): {text}; max|q-q_twin|={diff:.3e} (tol "
                f"{EULER_TWIN_TOL:g}); steps {STEPS_FIRST}-{EULER_STEPS}: "
                f"graphed {n / seconds:.2f} steps/s, eager (graph=False) "
                f"{n / e_seconds:.2f} steps/s, graphed twin "
                f"{n / twin_s:.2f}; {gtext}; launches "
                f"{launches['euler_rhs']} euler_rhs (want "
                f"{want['euler_rhs']}), all kernels "
                f"{sum(launches.values())}, eager run "
                f"{'the same' if e_launches == launches else e_launches}, "
                f"twin run {sum(twin_launches.values())}; fields "
                f"{'finite' if finite else 'NOT finite'} "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
        counts[(solver, nx)] = launches
        if (solver, nx) == EULER_RUNS[0]:
            main = (step, q, seconds / n)
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


def vortex_run(cfg, n_first, n_total, graph=True):
    """n_first steps from the two-Gaussian state (the warm-up: cuFFT plans
    its transforms there, and the graphed loop captures its chunk), then
    on to n_total between synchronisations.  Returns the final vorticity,
    the timed steps' seconds, the step, its state and the peak of
    allocated device memory (MB) over the run."""
    from cfd_julia_torch.models import vortex

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step = vortex.make_step(cfg, torch.float32, "cuda")
    w0 = vortex.initial_vorticity(cfg, torch.float32, "cuda")
    spectral = cfg.solver != "fdm"
    state = vortex.half_init(w0) if spectral else w0
    del w0
    state, seconds = timed_steps(step, state, graph, n_first, n_total)
    w = vortex.half_decode(state, cfg.nx, cfg.ny) if spectral else state
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    return w, seconds, step, state, peak_mb


def phase_vortex():
    """The four anchored vortex-merger runs at 2048^2 on the port's default
    path (graphed), each beside the same run with graph=False, with the
    kernels' launches against VORTEX_STEP_LAUNCHES; fdm's whole run and
    the spectral solvers' first VORTEX_TWIN_STEPS steps also on the plain
    twins (rhs_impl="torch").  Returns {solver: launch counts}, {solver:
    (step, state, seconds a step)} and ps23's final vorticity."""
    import dataclasses

    from cfd_julia_torch.models import vortex
    from cfd_julia_torch.ops import cuda_kernels

    n = VORTEX_TOTAL - VORTEX_FIRST
    steps, all_launches, w_ps23 = {}, {}, None
    for solver in VORTEX_SOLVERS:
        cfg = vortex.VortexConfig(nx=VORTEX_NX, ny=VORTEX_NX, solver=solver,
                                  dt=1e-3, re=1000.0)
        torch.cuda.synchronize()
        cuda_kernels.reset_launch_counts()
        w, seconds, step, state, peak = vortex_run(cfg, VORTEX_FIRST,
                                                   VORTEX_TOTAL)
        launches = dict(cuda_kernels.LAUNCHES)
        cuda_kernels.reset_launch_counts()
        w_eager, e_seconds, _, _, e_peak = vortex_run(
            cfg, VORTEX_FIRST, VORTEX_TOTAL, graph=False)
        e_launches = dict(cuda_kernels.LAUNCHES)
        ok, text = vortex_anchor_check(w, solver)
        same, gtext = graph_text(max_diff(w, w_eager), VORTEX_TWIN_TOL)
        if not gtext.endswith("(bitwise equal)"):
            e_ok, e_text = vortex_anchor_check(w_eager, solver)
            same, gtext = same and e_ok, f"{gtext}; eager {e_text}"
        del w_eager
        finite = bool(torch.isfinite(w).all())
        want = dict.fromkeys(launches, 0)
        for name, per_step in VORTEX_STEP_LAUNCHES[solver].items():
            want[name] = per_step * VORTEX_TOTAL
        ok = (ok and finite and w.dtype == torch.float32
              and w.shape == (VORTEX_NX, VORTEX_NX) and launches == want
              and same and e_launches == launches)
        line = (f"phase 9 vortex {solver} {VORTEX_NX}^2 fp32 @{VORTEX_TOTAL} "
                f"steps (dt=1e-3, Re=1000): {text}; {n} steps (from step "
                f"{VORTEX_FIRST}) graphed {n / seconds:.2f} steps/s "
                f"({seconds:.4f} s), eager (graph=False) {n / e_seconds:.2f} "
                f"steps/s; {gtext}; peak device memory over the run: graphed "
                f"{peak:.1f} MB, eager {e_peak:.1f} MB; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})} "
                f"(want {json.dumps({k: v for k, v in want.items() if v})}"
                f"), all kernels {sum(launches.values())}, eager run "
                f"{'the same' if e_launches == launches else e_launches}; "
                f"fields {'finite' if finite else 'NOT finite'}")
        all_launches[solver] = launches
        if solver != "fdm":
            # the kernels against the twins over the first steps
            cuda_kernels.reset_launch_counts()
            w_k = vortex_run(cfg, VORTEX_TWIN_STEPS // 2,
                             VORTEX_TWIN_STEPS)[0]
            k_launches = {k: v for k, v in cuda_kernels.LAUNCHES.items()
                          if v}
            cuda_kernels.reset_launch_counts()
            w_twin = vortex_run(dataclasses.replace(cfg, rhs_impl="torch"),
                                VORTEX_TWIN_STEPS // 2,
                                VORTEX_TWIN_STEPS)[0]
            diff = float((w_k - w_twin).abs().max())
            twin_quiet = not any(cuda_kernels.LAUNCHES.values())
            k_want = {k: v * VORTEX_TWIN_STEPS for k, v in
                      VORTEX_STEP_LAUNCHES[solver].items()}
            ok = (ok and diff <= VORTEX_TWIN_TOL and twin_quiet
                  and k_launches == k_want)
            line += (f"; {VORTEX_TWIN_STEPS} graphed steps on the kernels "
                     f"({json.dumps(k_launches)}) against the twins "
                     f"(rhs_impl=\"torch\", {'no' if twin_quiet else 'SOME'}"
                     f" kernel launches): max|w-w_twin|={diff:.3e} "
                     f"({'bitwise' if diff == 0.0 else 'NOT bitwise'}, tol "
                     f"{VORTEX_TWIN_TOL:g})")
            del w_k, w_twin
        if solver == "fdm":
            cuda_kernels.reset_launch_counts()
            w_twin, twin_s, _, _, _ = vortex_run(
                dataclasses.replace(cfg, rhs_impl="torch"), VORTEX_FIRST,
                VORTEX_TOTAL)
            diff = float((w - w_twin).abs().max())
            twin_quiet = not any(cuda_kernels.LAUNCHES.values())
            ok = ok and diff <= VORTEX_TWIN_TOL and twin_quiet
            line += (f"; max|w-w_twin|={diff:.3e} (tol {VORTEX_TWIN_TOL:g}), "
                     f"graphed twin {n / twin_s:.2f} steps/s and "
                     f"{'no' if twin_quiet else 'SOME'} kernel launches")
            del w_twin
        line += " ok" if ok else " FAIL"
        print(line)
        check(ok, line)
        steps[solver] = (step, state, seconds / n)
        if solver == "ps23":
            w_ps23 = w
        del w
    return all_launches, steps, w_ps23


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


# cuFFT's kernels as the profiler names them: the transforms and a strided
# c2r's pre- and post-processing passes (CUFFT_LAYOUT_KERNELS: a
# transposing pass inside cuFFT, the layout's cost)
CUFFT_LAYOUT_KERNELS = ("preprocess_kernel", "postprocess_kernel")
CUFFT_KERNELS = ("fft", "dpRadix", *CUFFT_LAYOUT_KERNELS)


def profile_transforms(by_name, label, steps):
    """The profile's device time in cuFFT's kernels (of which its pre- and
    post-processing passes), in kernel 1 and in everything else
    (PyTorch's elementwise and copy kernels)."""
    total = sum(us for us, _ in by_name.values())

    def sums(kernels):
        hits = [v for name, v in by_name.items()
                if any(k.lower() in name.lower() for k in kernels)]
        return sum(us for us, _ in hits), sum(c for _, c in hits)

    fft_us, fft_n = sums(CUFFT_KERNELS)
    lay_us, lay_n = sums(CUFFT_LAYOUT_KERNELS)
    k1_us, k1_n = kernel_sums(by_name, "arakawa_rhs_kernel")
    rest_n = sum(c for _, c in by_name.values()) - fft_n - k1_n
    print(f"profile {label}: cuFFT {fft_us / steps:.1f} us/step "
          f"({100 * fft_us / total:.1f}%) in {fft_n / steps:.1f} launches "
          f"(of which its pre- and post-processing passes "
          f"{lay_us / steps:.1f} us/step in {lay_n / steps:.1f}), "
          f"arakawa_rhs_kernel {k1_us / steps:.1f} us/step "
          f"({100 * k1_us / total:.1f}%) in {k1_n / steps:.1f}, other "
          f"kernels {(total - fft_us - k1_us) / steps:.1f} us/step "
          f"({100 * (total - fft_us - k1_us) / total:.1f}%) in "
          f"{rest_n / steps:.1f}")


# each pass's kernel template (csrc/vortex_stage.cu) as the profiler names it
VORTEX_PASS_KERNELS = {"vortex_derivs_half": ("derivs_kernel",
                                              "derivs_buffer_kernel"),
                       "vortex_product": ("product_kernel",),
                       "vortex_cn_combine": ("combine_kernel",),
                       "vortex_truncate_32": ("truncate_kernel",)}
# PyTorch's copies and fills as the profiler names them
COPY_KERNELS = ("Memcpy", "Memset", "copy", "fill", "Fill", "CatArray")


def profile_vortex_passes(by_name, solver, steps):
    """Each stage pass's device us and launches a step inside the profiled
    2048^2 fp32 step of `solver`, against its bound a step (ps23: the
    derivative pass's whole buffer of the band; ps32: its 3/2-padded
    buffer, the product on the 3072^2 grid and the truncation); the
    profile's copies and fills (COPY_KERNELS) a step.  Fails unless every
    pass launches as VORTEX_STEP_LAUNCHES says, and for ps23 and ps32
    unless fewer copies and fills ran than steps (the twin route's inverse
    makes at least one a Jacobian)."""
    n, hy = VORTEX_NX, VORTEX_NX // 2 + 1
    if solver == "ps23":
        # the hy values of each row the c2r reads (not the pitch's tail)
        derivs = derivs_buffer_bound(n, ((2 * n) // 3) // 2, hy, n, 4, 1.0)
    elif solver == "ps32":
        ne = 3 * n // 2
        derivs = derivs_buffer_bound(n, n // 2, ne // 2 + 1, ne, 4, 1.0)
    else:
        derivs = derivs_bound(n, hy, 4, 1.0)
    n_phys = (3 * n // 2 if solver == "ps32" else n) ** 2
    bounds = {"vortex_derivs_half": 3 * derivs["bound_ms"],
              "vortex_product": 3 * product_bound(n_phys, 4, 1.0)["bound_ms"],
              "vortex_cn_combine": (
                  combine_bound(n * hy, 1, 4, 1.0)["bound_ms"]
                  + 2 * combine_bound(n * hy, 2, 4, 1.0)["bound_ms"]),
              "vortex_truncate_32": 3 * truncate_bound(n, hy, 4,
                                                       1.0)["bound_ms"]}
    parts, ok = [], True
    for name, kernels in VORTEX_PASS_KERNELS.items():
        us, n = kernel_sums(by_name, *kernels)
        want = VORTEX_STEP_LAUNCHES[solver].get(name, 0) * steps
        ok = ok and n == want
        if want:
            us_step = us / steps
            parts.append(f"{name} {us_step:.2f} us in {n / steps:.1f} "
                         f"launches ({100 * 1e3 * bounds[name] / us_step:.1f}"
                         f"% of its bound {1e3 * bounds[name]:.2f} us)")
    copies = {name: v for name, v in by_name.items()
              if any(c in name for c in COPY_KERNELS)}
    copy_us = sum(v[0] for v in copies.values())
    copy_n = sum(v[1] for v in copies.values())
    if solver in ("ps23", "ps32"):
        # none around the transforms; the loop's state copy at a replay
        # of the profiled chunk (under one a step) is not the step's
        ok = ok and copy_n < steps
    parts.append(f"copies and fills {copy_us / steps:.2f} us in "
                 f"{copy_n / steps:.1f} launches "
                 f"{sorted(name[:60] for name in copies)}")
    line = (f"profile vortex {solver} {VORTEX_NX}^2 stage passes a step: "
            + "; ".join(parts))
    print(line + (" ok" if ok else " FAIL"))
    check(ok, line)


def phase_cavity_fst(matmul_rates, profile):
    """The cavity with the rfft DST-I Poisson solves, beside the sine
    matmuls' graphed and eager steps/s of phase 3 in this run."""
    from cfd_julia_torch.stepping import loop

    rates = {"matmul": matmul_rates}
    for poisson in ("fst", "fst_half"):
        _, step, state, step_s, _, e_step_s = phase_main_path(
            poisson, f"phase 11 cavity poisson={poisson}")
        rates[poisson] = (1.0 / step_s, 1.0 / e_step_s)
        if profile and poisson == "fst":
            by_name = phase_profile(
                f"cavity {NX}^2 poisson=fst (graphed)",
                lambda: loop.run_steps(step, state, 20), 20, step_s)
            if by_name:
                profile_rhs(by_name, "arakawa_rhs_kernel", 20)
                profile_transforms(by_name, f"cavity {NX}^2 poisson=fst", 20)
        del step, state
    print(f"phase 11 cavity {NX}^2 fp32 steps/s by Poisson solve, graphed / "
          f"eager, one run of this script: " + ", ".join(
              f"{k} {g:.2f} / {e:.2f}" for k, (g, e) in rates.items()))
    return rates


def phase_fused_cavity(rates, matmul_state, profile):
    """The packed cavity (poisson="fused") of phase 3's configuration: the
    step through the loop layer graphed (the main run) and with
    graph=False, 100 steps and on to 2000, each with its launch counts;
    the same 2000 steps through cavity.solve, and on the stage's plain
    twin; psi against the matmul path's after 100 steps and phase 3's
    after 2000.  rates: {poisson: (graphed, eager) steps/s} of phases 3 and
    11.  Returns the main run's launch counts, the cavity.solve result and
    the rates with fused's added."""
    import dataclasses

    from cfd_julia_torch.models import cavity, cavity_fused
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import loop

    label = "phase 13 fused cavity"
    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                              poisson="fused", t_final=STEPS_TOTAL * 2e-5)
    check(cfg.nt == STEPS_TOTAL, f"fused cavity nt {cfg.nt}")
    step = cavity_fused.make_fused_step_fn(cfg, torch.float32, "cuda")
    packed0 = cavity_fused.init_state(cfg, torch.float32, "cuda")
    n = STEPS_TOTAL - STEPS_FIRST
    (first, state, rms, seconds, launches), \
        (e_first, e_state, e_rms, e_seconds, e_launches) = cavity_runs(
            step, packed0)
    w1, s1 = cavity_fused.decode_state(cfg, first)
    w, s = cavity_fused.decode_state(cfg, state)
    anchor_check(s1, STEPS_FIRST, label)
    anchor_check(s, STEPS_TOTAL, label)
    finite = all(bool(torch.isfinite(x).all()) for x in (w, s, rms))
    diff = max_diff((*first, *state, rms), (*e_first, *e_state, e_rms))
    want = dict.fromkeys(launches, 0)
    want["cavity_fused_stage"] = 3 * STEPS_TOTAL
    ok = (finite and diff == 0.0 and launches == want
          and e_launches == launches)
    line = (f"{label} {NX}^2 fp32 (buffer {tuple(first[0].shape)}): {n} "
            f"steps (from step {STEPS_FIRST}) graphed {n / seconds:.2f} "
            f"steps/s ({seconds:.4f} s), eager (graph=False) "
            f"{n / e_seconds:.2f} steps/s ({e_seconds:.4f} s); "
            f"max|graph-eager| over the packed states and rms {diff:.3e} "
            f"(want 0, bitwise); launches {launches} (want "
            f"{want['cavity_fused_stage']} cavity_fused_stage and nothing "
            f"else), eager run "
            f"{'the same' if e_launches == launches else e_launches}; fields "
            f"{'finite' if finite else 'NOT finite'} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # the user entry point over the same 2000 steps: pack, run, decode
    t0 = time.perf_counter()
    res = cavity.solve(cfg, torch.float32, "cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    sdiff = max_diff((res.w, res.s, res.rms_history), (w, s, rms))
    # the stage's plain twin on the card, graphed
    twin = cavity_fused.make_fused_step_fn(
        dataclasses.replace(cfg, rhs_impl="torch"), torch.float32, "cuda")
    cuda_kernels.reset_launch_counts()
    t_state, _ = loop.run_steps(twin, packed0, STEPS_TOTAL)
    twin_launches = sum(cuda_kernels.LAUNCHES.values())
    _, t_s = cavity_fused.decode_state(cfg, t_state)
    tdiff = float((t_s - s).abs().max())
    scale = float(s.abs().max())
    # the full-grid matmul path after 100 steps, and phase 3's after 2000
    mcfg = dataclasses.replace(cfg, poisson="matmul")
    mstep = cavity.make_step_fn(mcfg, torch.float32, "cuda")
    (_, m_s1, _), _ = loop.run_steps(
        mstep, cavity.initial_state(mcfg, torch.float32, "cuda"),
        STEPS_FIRST)
    m100 = float((m_s1 - s1).abs().max())
    m2000 = float((matmul_state[1] - s).abs().max())
    ok = (sdiff == 0.0 and tdiff <= CAVITY_GRAPH_TOL * scale
          and twin_launches == 0)
    line = (f"{label}: cavity.solve(poisson='fused') over {STEPS_TOTAL} steps "
            f"in {solve_s:.3f} s, max|solve - step-level run| {sdiff:.3e} "
            f"(want 0); the plain-twin stage run (graphed, {twin_launches} "
            f"kernel-wrapper launches): max|psi - psi_twin| {tdiff:.3e} "
            f"(tol {CAVITY_GRAPH_TOL:g}*max|psi| = "
            f"{CAVITY_GRAPH_TOL * scale:.3e}); max|psi_fused - psi_matmul| "
            f"{m100:.3e} after {STEPS_FIRST} steps, {m2000:.3e} after "
            f"{STEPS_TOTAL} (max|psi| {scale:.3e}) {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    rates = {**rates, "fused": (1.0 / (seconds / n), 1.0 / (e_seconds / n))}
    print(f"{label} {NX}^2 fp32 steps/s by Poisson solve, graphed / eager, "
          f"one run of this script: " + ", ".join(
              f"{k} {g:.2f} / {e:.2f}" for k, (g, e) in rates.items()))
    if profile:
        by_name = phase_profile(f"cavity {NX}^2 poisson=fused (graphed)",
                                lambda: loop.run_steps(step, state, 20), 20,
                                seconds / n)
        if by_name:
            profile_rhs(by_name, "cavity_stage_kernel", 20)
            profile_stages(by_name, 20)
    return launches, res, rates


# the bf16 precision tiers of the cavity (the JAX package's TPU
# configurations), phase 15
TIERS = ("matmul_bf16x3", "matmul_bf16x1", "fused_bf16x3", "fused_bf16x1")
# bf16x3's max|psi_tier - psi_fp32| of the same formulation after 2000
# steps, of max|psi| (the JAX package's record: ~5e-6 rel_l2 after 500
# steps, bench.py:294-305)
TIER_FP32_TOL = 1e-4
# bf16x3's Ghia deviation at 64^2: within 1.1x fp32's + 1e-3
GHIA_TIER_FACTOR, GHIA_TIER_SLACK = 1.1, 1e-3


def tier_path(tier):
    """The 1024^2 cavity of phase 3's configuration in a precision tier:
    graphed (the main run) and with graph=False, 100 steps and on to 2000,
    each with its launch counts.  Returns the step, the main run's final
    state, psi after 2000 steps, seconds a step graphed and eager, and the
    launches."""
    from cfd_julia_torch.models import cavity, cavity_fused

    label = f"phase 15 cavity poisson={tier}"
    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                              poisson=tier, t_final=STEPS_TOTAL * 2e-5)
    fused = tier.startswith("fused")
    if fused:
        step = cavity_fused.make_fused_step_fn(cfg, torch.float32, "cuda")
        state0 = cavity_fused.init_state(cfg, torch.float32, "cuda")

        def psi(state):
            return cavity_fused.decode_state(cfg, state)[1]
    else:
        step = cavity.make_step_fn(cfg, torch.float32, "cuda")
        state0 = cavity.initial_state(cfg, torch.float32, "cuda")

        def psi(state):
            return state[1]
    n = STEPS_TOTAL - STEPS_FIRST
    (first, state, rms, seconds, launches), \
        (e_first, e_state, e_rms, e_seconds, e_launches) = cavity_runs(
            step, state0)
    anchor_check(psi(first), STEPS_FIRST, label)
    anchor_check(psi(state), STEPS_TOTAL, label)
    finite = all(bool(torch.isfinite(x).all()) for x in (*state[:2], rms))
    diff = max_diff((*first, *state, rms), (*e_first, *e_state, e_rms))
    want = dict.fromkeys(launches, 0)
    # a solve: one split (its input) and four GEMMs, each writing the next
    # product's planes
    want["tier_gemm"], want["tier_split"] = 12 * STEPS_TOTAL, 3 * STEPS_TOTAL
    want["cavity_fused_stage" if fused else "arakawa_rhs"] = 3 * STEPS_TOTAL
    ok = finite and diff == 0.0 and launches == want and e_launches == launches
    line = (f"{label} {NX}^2 fp32: {n} steps (from step {STEPS_FIRST}) "
            f"graphed {n / seconds:.2f} steps/s ({seconds:.4f} s), eager "
            f"(graph=False) {n / e_seconds:.2f} steps/s ({e_seconds:.4f} s); "
            f"max|graph-eager| over the states and rms {diff:.3e} (want 0, "
            f"bitwise); launches "
            f"{ {k: v for k, v in launches.items() if v} } (want "
            f"{ {k: v for k, v in want.items() if v} } and nothing else), "
            f"eager run "
            f"{'the same' if e_launches == launches else e_launches}; fields "
            f"{'finite' if finite else 'NOT finite'} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    return step, state, psi(state), seconds / n, e_seconds / n, launches


def tier_resume(tier, psi_ref):
    """The fused tier's checkpoint: cavity.solve over 2000 steps (bitwise
    the step-level graphed run's psi `psi_ref`), then stopped at 100 steps
    and resumed to 2000 from its checkpoint, bitwise that solve."""
    import dataclasses

    from cfd_julia_torch.models import cavity

    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                              poisson=tier, t_final=STEPS_TOTAL * 2e-5)
    ref = cavity.solve(cfg, torch.float32, "cuda")
    sdiff = max_diff(ref.s, psi_ref)
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "tier.npz")
        t0 = time.perf_counter()
        cavity.solve(dataclasses.replace(cfg, t_final=STEPS_FIRST * cfg.dt),
                     torch.float32, "cuda", checkpoint_every=500,
                     checkpoint_path=ck)
        res = cavity.solve(cfg, torch.float32, "cuda", checkpoint_every=500,
                           checkpoint_path=ck, resume=True)
        seconds = time.perf_counter() - t0
    diff = max_diff((res.w, res.s, res.rms_history),
                    (ref.w, ref.s, ref.rms_history))
    ok = diff == 0.0 and sdiff == 0.0
    line = (f"phase 15 checkpoint cavity poisson={tier} {NX}^2 fp32: "
            f"cavity.solve over {STEPS_TOTAL} steps, max|solve - step-level "
            f"run| {sdiff:.3e} (want 0); stopped at {STEPS_FIRST} steps and "
            f"resumed to {STEPS_TOTAL} (checkpoints every 500) in "
            f"{seconds:.2f} s of two solves; max|resumed - uninterrupted| "
            f"over w, s and the rms history {diff:.3e} (want 0, bitwise) "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def phase_tiers(rates, matmul_psi, fused_psi, ghia_fp32, profile):
    """The four bf16 tiers at 1024^2 (tier_path), each against both anchors
    and its fp32 formulation's psi after 2000 steps (phase 3's matmul,
    phase 13's fused); steps/s beside phases 3, 11 and 13; the fused_bf16x3
    checkpoint; then the 64^2 Ghia case through the CLI for each tier,
    beside phase 4's fp32 run.  Returns fused_bf16x3's launch counts."""
    from cfd_julia_torch.stepping import loop

    rates = dict(rates)
    main_launches = None
    for tier in TIERS:
        step, state, psi, step_s, e_step_s, launches = tier_path(tier)
        rates[tier] = (1.0 / step_s, 1.0 / e_step_s)
        ref = fused_psi if tier.startswith("fused") else matmul_psi
        scale = float(ref.abs().max())
        dpsi = float((psi - ref).abs().max())
        x3 = tier.endswith("x3")
        ok = dpsi <= TIER_FP32_TOL * scale or not x3
        line = (f"phase 15 cavity poisson={tier}: max|psi_tier - psi_fp32| "
                f"after {STEPS_TOTAL} steps {dpsi:.3e} = {dpsi / scale:.3e} "
                f"of max|psi| {scale:.3e} ("
                + (f"tol {TIER_FP32_TOL:g}" if x3 else "printed only")
                + f") {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
        if tier == "fused_bf16x3":
            main_launches = launches
            tier_resume(tier, psi)
            if profile:
                by_name = phase_profile(
                    f"cavity {NX}^2 poisson={tier} (graphed)",
                    lambda: loop.run_steps(step, state, 20), 20, step_s)
                if by_name:
                    profile_rhs(by_name, "cavity_stage_kernel", 20)
                    profile_stages(by_name, 20)
                    total = sum(v[0] for v in by_name.values())
                    for kernels, per_step in ((("tier_gemm_kernel",), 12),
                                              (("split_cols_kernel",
                                                "split_rows_kernel"), 3)):
                        us, n = kernel_sums(by_name, *kernels)
                        line = (f"profile {' + '.join(kernels)}: {n} device "
                                f"launches in 20 steps = {n / 20:.2f} a step "
                                f"(want {per_step}), {us / 20:.2f} us/step, "
                                f"{100 * us / total:.1f}% of the step's "
                                f"device time")
                        ok = n == per_step * 20
                        print(line + (" ok" if ok else " FAIL"))
                        check(ok, line)
        del step, state
    print(f"phase 15 cavity {NX}^2 fp32 steps/s by Poisson solve, graphed / "
          f"eager, one run of this script: " + ", ".join(
              f"{k} {g:.2f} / {e:.2f}" for k, (g, e) in rates.items()))

    du32, dv32 = ghia_fp32
    results, seconds = cli_runs("cavity", [["--poisson", t] for t in TIERS])
    for tier, (metrics, files) in zip(TIERS, results):
        du, dv = ghia_deviations(files)
        x3 = tier.endswith("x3")
        gate_u = GHIA_TIER_FACTOR * du32 + GHIA_TIER_SLACK
        gate_v = GHIA_TIER_FACTOR * dv32 + GHIA_TIER_SLACK
        ok = math.isfinite(metrics["steady_rms"]) and (
            not x3 or (du <= gate_u and dv <= gate_v))
        line = (f"phase 15 cli `run cavity --poisson {tier} --device cuda` "
                f"(64^2, Re=100, t=10): max|u-ghia|={du:.5f} "
                f"max|v-ghia|={dv:.5f} (fp32, phase 4: {du32:.5f} "
                f"{dv32:.5f}; "
                + (f"gate {GHIA_TIER_FACTOR:g}x fp32 + {GHIA_TIER_SLACK:g} = "
                   f"{gate_u:.5f} {gate_v:.5f}" if x3 else
                   "printed only; the JAX package's record: single-pass bf16 "
                   "stalls at rms ~1e-5 with 18x fp32's deviations at "
                   "1024^2, BASELINE.md")
                + f"), steady_rms={metrics['steady_rms']:.3e}, psi_min="
                f"{metrics['psi_min']:.6f}, solve "
                f"{metrics['wall_time_s']:.2f} s {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
    print(f"phase 15 cli: the {len(TIERS)} tier runs together in "
          f"{seconds:.2f} s (processes started at once on one card)")
    return main_launches


# the 1D family: CRWENO-5 periodic Burgers of `bench.py`'s worker_crweno
# (nx=1600, dt = 1e-4*200/nx, fp32), steps of its anchored window
CRWENO_NX, CRWENO_STEPS = 1600, 2000
# eager steps timed (~20 steps/s: ~2660 launches a step from the host)
CRWENO_EAGER = 50
# the heat presets' L2 bounds (tests/test_heat1d.py:14-17)
HEAT_L2 = {"heat_ftcs": 2.1e-4, "heat_rk3": 1.5e-4, "heat_cn": 1.5e-4,
           "heat_icp": 2e-7}
BURGERS_PRESETS = ("burgers_weno_dirichlet", "burgers_weno_periodic",
                   "burgers_central", "burgers_crweno_dirichlet",
                   "burgers_crweno_periodic", "burgers_flux_splitting",
                   "burgers_riemann")
# Burgers presets run in fp64: in fp32 WENO's weights overshoot max|u| = 1
# by up to 5e-6 (CPU runs of the port), past the 1 + 1e-6 gate.  The
# central baseline oscillates from the shock on (t = 1/(2 pi)) and is not
# finite at its preset's t = 0.25 in either package (fp64, CPU): it runs to
# t = 0.15, where the JAX package's fp64 run reaches max|u| = 1.0000548
BURGERS_UMAX = 1.0 + 1e-6
CENTRAL_T, CENTRAL_UMAX = 0.15, 1.0 + 1e-4
# the CLI runs fp32, where CRWENO-5 on an H100 overshoots max|u| = 1 by
# 6.5e-5 after 2000 steps of phase 14's run and 9.9e-5 after the preset's
# 2500: it is held to 1 + 1e-3, and its total variation to the fp64 run's
# within 1e-3 of it
CLI_UMAX, CLI_TV_REL = 1.0 + 1e-3, 1e-3


def crweno_anchor_check(u):
    anchor = json.loads(ANCHORS.read_text())[
        f"crweno:{CRWENO_NX}:{CRWENO_STEPS}"]
    u = u.double()
    got = {"u_max": float(u.abs().max()),
           "u_l2": float(torch.sqrt(torch.mean(u ** 2)))}
    tol = anchor["rel_tol"]
    rels = {k: abs(got[k] - anchor[k]) / abs(anchor[k]) for k in got}
    text = " ".join(f"{k}={got[k]:.9g} (anchor {anchor[k]:.9g}, rel "
                    f"{rels[k]:.2e})" for k in got) + f" tol {tol:g}"
    return all(r <= tol for r in rels.values()), text


def phase_1d():
    """CRWENO-5 periodic Burgers at nx=1600 graphed (steps 100-2000 timed)
    and eagerly (steps 10-60, bitwise the graphed run's first 60), device
    launches a step from a profile of 10 graphed steps; then the 11 heat
    and Burgers presets through run.run_preset on the card and two of
    them through the CLI."""
    from cfd_julia_torch import run
    from cfd_julia_torch.models import burgers1d
    from cfd_julia_torch.stepping import loop

    cfg = burgers1d.BurgersConfig(nx=CRWENO_NX, solver="crweno",
                                  bc="periodic", dt=1e-4 * 200 / CRWENO_NX)
    step = burgers1d.make_step_fn(cfg)
    _, u0 = burgers1d.initial_condition(cfg, torch.float32, "cuda")
    u, seconds = timed_steps(step, u0, True, STEPS_FIRST, CRWENO_STEPS)
    n = CRWENO_STEPS - STEPS_FIRST
    ok, text = crweno_anchor_check(u)
    e_u, e_seconds = timed_steps(step, u0, False, 10, 10 + CRWENO_EAGER)
    g_u = loop.advance(step, u0, 10 + CRWENO_EAGER)
    same = torch.equal(e_u, g_u)
    by_name = phase_profile(f"crweno periodic {CRWENO_NX} (graphed)",
                            lambda: loop.advance(step, u, 10), 10,
                            seconds / n)
    per_step = (sum(c for _, c in by_name.values()) / 10 if by_name
                else float("nan"))
    finite = bool(torch.isfinite(u).all())
    ok = ok and same and finite
    line = (f"phase 14 crweno periodic burgers {CRWENO_NX} fp32 "
            f"@{CRWENO_STEPS} steps (dt={cfg.dt:g}, PCR): {text}; steps "
            f"{STEPS_FIRST}-{CRWENO_STEPS} graphed {n / seconds:.2f} "
            f"steps/s, eager (graph=False, steps 10-{10 + CRWENO_EAGER}) "
            f"{CRWENO_EAGER / e_seconds:.2f} steps/s; eager = graphed after "
            f"{10 + CRWENO_EAGER} steps bitwise: {same}; {per_step:.1f} "
            f"device launches a step "
            f"(profile of 10 graphed steps) {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    fp64_metrics = {}
    for name in (*HEAT_L2, *BURGERS_PRESETS):
        fp32 = name in HEAT_L2 and name != "heat_icp"
        dtype = torch.float32 if fp32 else torch.float64
        over = {"t_final": CENTRAL_T} if name == "burgers_central" else {}
        umax = CENTRAL_UMAX if over else BURGERS_UMAX
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            m = run.run_preset(name, outdir=tmp, dtype=dtype, device="cuda",
                               **over)
            seconds = time.perf_counter() - t0
            fp64_metrics[name] = m
            if name in HEAT_L2:
                ok = m["l2_error"] < HEAT_L2[name]
                text = (f"L2 {m['l2_error']:.4e} (bound {HEAT_L2[name]:g}), "
                        f"Linf {m['linf_error']:.4e}")
            else:
                data = np.loadtxt(Path(tmp) / m["output"])
                ok = bool(np.isfinite(data).all()) and m["umax"] <= umax
                text = (f"{m['output']} {data.shape[0]} points x "
                        f"{data.shape[1] - 1} snapshots, finite "
                        f"{bool(np.isfinite(data).all())}, max|u| "
                        f"{m['umax']:.9g} (<= 1 + {umax - 1:.0e}), total "
                        f"variation {m['tv']:.6f}")
        line = (f"phase 14 preset {name} ({str(dtype)[6:]}"
                f"{', t_final ' + str(CENTRAL_T) if over else ''}, "
                f"run.run_preset on cuda, {seconds:.3f} s): {text} "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)

    metrics, files, seconds = cli_run("heat_cn")
    ok = (metrics["l2_error"] < HEAT_L2["heat_cn"]
          and {"output.txt", "field_final.csv"} <= set(files))
    line = (f"phase 14 cli `run heat_cn --device cuda`: L2 "
            f"{metrics['l2_error']:.4e}, files {sorted(files)}, process "
            f"{seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    metrics, files, seconds = cli_run("burgers_crweno_periodic")
    tv64 = fp64_metrics["burgers_crweno_periodic"]["tv"]
    tv_rel = abs(metrics["tv"] - tv64) / tv64
    ok = (metrics["umax"] <= CLI_UMAX and tv_rel <= CLI_TV_REL
          and metrics["output"] in files
          and metrics["device"] == torch.cuda.get_device_name())
    line = (f"phase 14 cli `run burgers_crweno_periodic --device cuda` "
            f"(fp32): max|u| {metrics['umax']:.9g} (<= 1 + "
            f"{CLI_UMAX - 1:.0e}), total variation {metrics['tv']:.6f} (the "
            f"fp64 run's {tv64:.6f}, rel {tv_rel:.2e}, tol {CLI_TV_REL:g}), "
            f"{metrics['output']}, process {seconds:.2f} s "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def phase_empty_graph(floor_ms):
    """An empty kernel (torch.cuda._sleep(0)) launched eagerly, beside a
    CUDA graph of 100 of them: device time a replay and a kernel, and a
    replay's time as the host issues it to an idle device."""
    n = 100
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        torch.cuda._sleep(0)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            torch.cuda._sleep(0)
    ms, call_ms = median_ms(graph.replay)
    print(f"phase 2 empty launch: eager {1e3 * floor_ms:.2f} us a kernel; a "
          f"CUDA graph of {n} empty kernels {1e3 * ms:.2f} us of device time "
          f"a replay = {1e3 * ms / n:.3f} us a kernel, {1e3 * call_ms:.2f} us "
          f"a replay issued to an idle device (medians of 30 replays, CUDA "
          f"events)")


def phase_checkpoint(cavity_ref, w_ps23, fused_ref):
    """Checkpoint and resume on the card, against the uninterrupted graphed
    runs of phases 3 and 9: the 1024^2 cavity stopped at 100 steps, then
    at 1000 (checkpoints every 500), then resumed to 2000; ps23 at 2048^2
    stopped at 100 steps and resumed to 200; then the CLI cavity with
    --checkpoint-every 200 and again with --resume; the packed cavity,
    stopped and resumed as the full-grid one, against phase 13's
    uninterrupted cavity.solve run `fused_ref`."""
    import dataclasses

    from cfd_julia_torch.models import cavity, vortex
    from cfd_julia_torch.utils import checkpoint

    state_ref, rms_ref = cavity_ref
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "cavity.npz")
        cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2)
        t0 = time.perf_counter()
        for steps in (STEPS_FIRST, 1000, STEPS_TOTAL):
            cfg = dataclasses.replace(cfg, t_final=steps * cfg.dt)
            check(cfg.nt == steps, f"cavity nt {cfg.nt} != {steps}")
            res = cavity.solve(cfg, torch.float32, "cuda",
                               checkpoint_every=500, checkpoint_path=ck,
                               resume=True)
            if steps == STEPS_FIRST:
                anchor_check(res.s, STEPS_FIRST, "phase 12 cavity resumed")
        seconds = time.perf_counter() - t0
        anchor_check(res.s, STEPS_TOTAL, "phase 12 cavity resumed")
        at = checkpoint.load_state(ck, (res.w, res.s, res.w.new_empty(0)))[1]
        diff = max_diff((res.w, res.s, res.rms_history),
                        (state_ref[0], state_ref[1], rms_ref))
        ok = diff == 0.0 and at == STEPS_TOTAL
        line = (f"phase 12 checkpoint cavity {NX}^2 fp32: stopped at "
                f"{STEPS_FIRST} and 1000 steps (checkpoints every 500), "
                f"resumed to {STEPS_TOTAL} in {seconds:.2f} s of three "
                f"solves; checkpoint at step {at}; max|resumed - "
                f"uninterrupted graphed run| over w, s and the rms history "
                f"{diff:.3e} (want 0, bitwise) {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)

        fk = str(Path(tmp) / "fused.npz")
        fcfg = dataclasses.replace(cfg, poisson="fused")
        t0 = time.perf_counter()
        for steps in (STEPS_FIRST, 1000, STEPS_TOTAL):
            fcfg = dataclasses.replace(fcfg, t_final=steps * fcfg.dt)
            check(fcfg.nt == steps, f"fused cavity nt {fcfg.nt} != {steps}")
            res = cavity.solve(fcfg, torch.float32, "cuda",
                               checkpoint_every=500, checkpoint_path=fk,
                               resume=True)
        seconds = time.perf_counter() - t0
        anchor_check(res.s, STEPS_TOTAL, "phase 12 fused cavity resumed")
        diff = max_diff((res.w, res.s, res.rms_history),
                        (fused_ref.w, fused_ref.s, fused_ref.rms_history))
        ok = diff == 0.0
        line = (f"phase 12 checkpoint fused cavity {NX}^2 fp32: stopped at "
                f"{STEPS_FIRST} and 1000 steps (checkpoints every 500, the "
                f"full-grid format), resumed to {STEPS_TOTAL} in "
                f"{seconds:.2f} s of three solves; max|resumed - "
                f"uninterrupted cavity.solve run| over w, s and the rms "
                f"history {diff:.3e} (want 0, bitwise) "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
        del res

        vk = str(Path(tmp) / "ps23.npz")
        vcfg = vortex.VortexConfig(nx=VORTEX_NX, ny=VORTEX_NX,
                                   solver="ps23", dt=1e-3, re=1000.0)
        for steps, ns in ((VORTEX_FIRST, 1), (VORTEX_TOTAL, 2)):
            vcfg = dataclasses.replace(vcfg, t_final=steps * vcfg.dt, ns=ns)
            check(vcfg.nt == steps, f"vortex nt {vcfg.nt} != {steps}")
            res = vortex.solve(vcfg, torch.float32, "cuda",
                               checkpoint_every=VORTEX_FIRST,
                               checkpoint_path=vk, resume=True)
        ok, text = vortex_anchor_check(res.w, "ps23")
        diff = max_diff(res.w, w_ps23)
        snaps_ok = torch.equal(res.snapshots[-1], res.w) and \
            res.snapshots.shape == (3, VORTEX_NX, VORTEX_NX)
        ok = ok and diff == 0.0 and snaps_ok
        line = (f"phase 12 checkpoint ps23 {VORTEX_NX}^2 fp32: stopped at "
                f"{VORTEX_FIRST} steps, resumed to {VORTEX_TOTAL}: {text}; "
                f"max|resumed - uninterrupted graphed run| {diff:.3e} (want "
                f"0, bitwise); snapshots {tuple(res.snapshots.shape)} "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
        del res

        out = Path(tmp) / "cli"
        m1, files, s1 = cli_run("cavity", outdir=out,
                                extra=["--checkpoint-every", "200"])
        m2, _, s2 = cli_run("cavity", outdir=out, extra=["--resume"])
        at = checkpoint.load_state(
            str(out / "checkpoint.npz"),
            (torch.zeros(65, 65), torch.zeros(65, 65), torch.zeros(0)))[1]
        ok = (m1["psi_min"] == m2["psi_min"] and at == 10000
              and "checkpoint.npz" in files)
        line = (f"phase 12 cli `run cavity --checkpoint-every 200` then "
                f"`--resume` (64^2, 10000 steps): psi_min {m1['psi_min']!r} "
                f"and {m2['psi_min']!r}, checkpoint at step {at}; processes "
                f"{s1:.2f} s and {s2:.2f} s {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)


def phase_ensemble(fdm_step_s):
    """The 8-member fdm ensemble at 2048^2 (fp32): the batched step
    graphed (launches counted from 0 over its 200 steps) and eager, the
    user's vortex_fdm_re_sweep, the Re=1000 member against its anchor and
    every member against its own single run (phase 9's path); member-
    steps/s beside phase 9's fdm steps/s (fdm_step_s: its seconds a
    step).  Returns the launch counts of the graphed run."""
    import dataclasses

    from cfd_julia_torch.models import ensemble, vortex
    from cfd_julia_torch.ops import cuda_kernels

    cfg = vortex.VortexConfig(nx=VORTEX_NX, ny=VORTEX_NX, solver="fdm",
                              dt=1e-3, re=1000.0,
                              t_final=VORTEX_TOTAL * 1e-3)
    check(cfg.nt == VORTEX_TOTAL, f"ensemble nt {cfg.nt}")
    n_members, n = len(ENSEMBLE_RE), VORTEX_TOTAL - VORTEX_FIRST
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = torch.tensor(ENSEMBLE_RE, dtype=torch.float32, device="cuda")
    step, w0 = ensemble.make_sweep_step(cfg, res, torch.float32, "cuda")
    cuda_kernels.reset_launch_counts()
    w, seconds = timed_steps(step, w0, True, VORTEX_FIRST, VORTEX_TOTAL)
    launches = dict(cuda_kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    cuda_kernels.reset_launch_counts()
    w_eager, e_seconds = timed_steps(step, w0, False, VORTEX_FIRST,
                                     VORTEX_TOTAL)
    e_launches = dict(cuda_kernels.LAUNCHES)
    same = torch.equal(w, w_eager)
    del w_eager
    sweep = ensemble.vortex_fdm_re_sweep(cfg, ENSEMBLE_RE, torch.float32,
                                         "cuda")
    entry_same = torch.equal(sweep.w, w)
    del sweep
    anchor_ok, text = vortex_anchor_check(w[ENSEMBLE_RE.index(1000.0)],
                                          "fdm")
    rel, bitwise = [], []
    for k, re in enumerate(ENSEMBLE_RE):
        single = vortex_run(dataclasses.replace(cfg, re=re), VORTEX_FIRST,
                            VORTEX_TOTAL)[0]
        rel.append(float((w[k] - single).abs().max() / single.abs().max()))
        bitwise.append(torch.equal(w[k], single))
        del single
    finite = bool(torch.isfinite(w).all())
    want = dict.fromkeys(launches, 0)
    want["arakawa_rhs"] = 3 * VORTEX_TOTAL
    ok = (anchor_ok and same and entry_same and finite
          and launches == want and e_launches == launches
          and w.shape == (n_members, VORTEX_NX, VORTEX_NX)
          and max(rel) <= VORTEX_TWIN_TOL)
    line = (f"phase 16 ensemble fdm {n_members} x {VORTEX_NX}^2 fp32 "
            f"@{VORTEX_TOTAL} steps (dt=1e-3, re={list(ENSEMBLE_RE)}): "
            f"Re=1000 member {text}; {n} steps (from step {VORTEX_FIRST}) "
            f"graphed {n_members * n / seconds:.2f} member-steps/s "
            f"({n / seconds:.2f} batch steps/s, {seconds:.4f} s), eager "
            f"{n_members * n / e_seconds:.2f} member-steps/s; phase 9's "
            f"single fdm run {1.0 / fdm_step_s:.2f} steps/s; graphed == "
            f"eager bitwise: {same}; vortex_fdm_re_sweep == the step-level "
            f"run bitwise: {entry_same}; launches {launches['arakawa_rhs']} "
            f"arakawa_rhs (want {want['arakawa_rhs']}: 3 a step for the "
            f"batch), all kernels {sum(launches.values())}, eager run "
            f"{'the same' if e_launches == launches else e_launches}; each "
            f"member against its single run (phase 9's path): max|w_b - "
            f"w_single|/max|w_single| {[f'{r:.2e}' for r in rel]} (tol "
            f"{VORTEX_TWIN_TOL:g}), bitwise {bitwise}; peak device memory "
            f"{peak:.1f} MB; fields {'finite' if finite else 'NOT finite'} "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    return launches


# phase 16's gradients: the cavity (a), the fdm ensemble (b), ps23 (c)
GRAD_CAVITY_STEPS = 50
GRAD_ENSEMBLE_RE = (600.0, 1000.0, 2000.0, 4000.0)
GRAD_VORTEX_STEPS = 10


def peak_gb(fn):
    """fn()'s result and the peak of allocated device memory over it, GB
    above what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_gradients():
    """Reverse-mode gradients in fp64 through the port on the card, each
    against the plain RHS's autograd and central finite differences.
    Returns the launch counts of (a), the cavity's kernel run, and of
    (b), the ensemble's, under "cavity" and "ensemble"."""
    import dataclasses

    from cfd_julia_torch.models import cavity, ensemble, vortex
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import loop
    from torch.utils.checkpoint import checkpoint

    f64, dev = torch.float64, "cuda"

    # (a) the cavity
    def cavity_loss(rhs_impl, re_value, grad):
        cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                                  poisson="matmul", rhs_impl=rhs_impl)
        re = torch.tensor(re_value, dtype=f64, device=dev,
                          requires_grad=grad)
        step = cavity.make_step_fn(cfg, f64, dev, re=re)
        with torch.set_grad_enabled(grad):
            final = loop.advance(step, cavity.initial_state(cfg, f64, dev),
                                 GRAD_CAVITY_STEPS, graph=False)
            loss = 1e6 * torch.mean(final[1] ** 2)
        if not grad:
            return float(loss)
        (g,) = torch.autograd.grad(loss, re)
        return float(g)

    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    g_kernel, peak_k = peak_gb(lambda: cavity_loss("kernel", RE, True))
    seconds = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    cuda_kernels.reset_launch_counts()
    g_twin, peak_t = peak_gb(lambda: cavity_loss("torch", RE, True))
    twin_quiet = not any(cuda_kernels.LAUNCHES.values())
    h = 0.5
    fd = (cavity_loss("kernel", RE + h, False)
          - cavity_loss("kernel", RE - h, False)) / (2 * h)
    rel_twin = abs(g_kernel - g_twin) / abs(g_twin)
    rel_fd = abs(g_kernel - fd) / abs(fd)
    n_fwd = launches["arakawa_rhs"]
    ok = (rel_twin <= 1e-9 and rel_fd <= 1e-4 and twin_quiet
          and n_fwd == 3 * GRAD_CAVITY_STEPS
          and launches["arakawa_rhs_backward"] == n_fwd
          and not any(k.endswith("_re_grad") for k in launches)
          and math.isfinite(g_kernel) and g_kernel != 0.0)
    cavity_grad = g_kernel
    line = (f"phase 16 gradient (a) cavity {NX}^2 fp64 (dt=2e-5, Re={RE:g}, "
            f"{GRAD_CAVITY_STEPS} steps from rest, matmul, graph=False): "
            f"d(1e6 mean psi^2)/dRe = {g_kernel!r} through the kernel RHS "
            f"and its backward kernel ({seconds:.2f} s with the forward); "
            f"plain RHS's autograd {g_twin!r} (rel {rel_twin:.2e}, tol "
            f"1e-9; {'no' if twin_quiet else 'SOME'} kernel launches); "
            f"central FD h={h:g} {fd!r} (rel {rel_fd:.2e}, tol 1e-4); "
            f"launches {n_fwd} arakawa_rhs, "
            f"{launches['arakawa_rhs_backward']} arakawa_rhs_backward (want "
            f"{3 * GRAD_CAVITY_STEPS} each; the Re sum inside the backward "
            f"kernel, no second launch); peak device memory "
            f"{peak_k:.2f} GB kernel, {peak_t:.2f} GB plain "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # (b) the fdm ensemble, one Re gradient a member
    vcfg = vortex.VortexConfig(nx=VORTEX_NX, ny=VORTEX_NX, solver="fdm",
                               dt=1e-3, t_final=GRAD_VORTEX_STEPS * 1e-3)
    check(vcfg.nt == GRAD_VORTEX_STEPS, f"gradient nt {vcfg.nt}")

    def member_losses(w):
        return torch.mean(w ** 2, (-2, -1))

    def ensemble_grad():
        r = torch.tensor(GRAD_ENSEMBLE_RE, dtype=f64, device=dev,
                         requires_grad=True)
        out = ensemble.vortex_fdm_re_sweep(vcfg, r, f64, dev)
        (g,) = torch.autograd.grad(member_losses(out.w).sum(), r)
        return g

    def twin_grad():
        """The same through the plain RHS, each step recomputed in the
        backward (torch.utils.checkpoint): its autograd would hold ~56 GB
        of the plain Jacobian's intermediates over 10 steps."""
        r = torch.tensor(GRAD_ENSEMBLE_RE, dtype=f64, device=dev,
                         requires_grad=True)
        step, w = ensemble.make_sweep_step(
            dataclasses.replace(vcfg, rhs_impl="torch"), r, f64, dev)
        for _ in range(GRAD_VORTEX_STEPS):
            w = checkpoint(step, w, use_reentrant=False)
        (g,) = torch.autograd.grad(member_losses(w).sum(), r)
        return g

    cuda_kernels.reset_launch_counts()
    g_k, peak_k = peak_gb(ensemble_grad)
    e_launches = dict(cuda_kernels.LAUNCHES)
    cuda_kernels.reset_launch_counts()
    g_t, peak_t = peak_gb(twin_grad)
    twin_quiet = not any(cuda_kernels.LAUNCHES.values())
    k = GRAD_ENSEMBLE_RE.index(1000.0)
    h = 1.0
    with torch.no_grad():
        losses = []
        for sign in (1, -1):
            res = list(GRAD_ENSEMBLE_RE)
            res[k] += sign * h
            losses.append(float(member_losses(ensemble.vortex_fdm_re_sweep(
                vcfg, res, f64, dev).w)[k]))
        w_k = ensemble.vortex_fdm_re_sweep(vcfg, GRAD_ENSEMBLE_RE, f64,
                                           dev).w
        w_t = ensemble.vortex_fdm_re_sweep(
            dataclasses.replace(vcfg, rhs_impl="torch"), GRAD_ENSEMBLE_RE,
            f64, dev).w
        w_diff = float((w_k - w_t).abs().max())
        del w_k, w_t
    fd = (losses[0] - losses[1]) / (2 * h)
    rel_twin = float(((g_k - g_t).abs() / g_t.abs()).max())
    rel_fd = abs(float(g_k[k]) - fd) / abs(fd)
    values = [float(x) for x in g_k]
    n_fwd = e_launches["arakawa_rhs"]
    ok = (rel_twin <= 1e-9 and rel_fd <= 1e-4 and twin_quiet
          and len(set(values)) == len(values)
          and all(math.isfinite(x) for x in values)
          and n_fwd == 3 * GRAD_VORTEX_STEPS
          and e_launches["arakawa_rhs_backward"] == n_fwd
          and not any(k.endswith("_re_grad") for k in e_launches))
    line = (f"phase 16 gradient (b) fdm ensemble {len(GRAD_ENSEMBLE_RE)} x "
            f"{VORTEX_NX}^2 fp64 (re={list(GRAD_ENSEMBLE_RE)}, "
            f"{GRAD_VORTEX_STEPS} steps, dt=1e-3): d mean(w_b^2)/d re_b = "
            f"{values} in one backward pass (distinct: "
            f"{len(set(values)) == len(values)}); plain RHS's autograd "
            f"(each step recomputed under torch.utils.checkpoint) "
            f"{[float(x) for x in g_t]}, rel {rel_twin:.2e} (tol 1e-9; "
            f"{'no' if twin_quiet else 'SOME'} kernel launches; the "
            f"forward runs' max|w_kernel - w_plain| {w_diff:.3e}); central FD of the Re=1000 member h={h:g} "
            f"{fd!r} (rel {rel_fd:.2e}, tol 1e-4); launches {n_fwd} "
            f"arakawa_rhs, {e_launches['arakawa_rhs_backward']} "
            f"arakawa_rhs_backward (want {3 * GRAD_VORTEX_STEPS} each); "
            f"peak device memory {peak_k:.2f} GB kernel, {peak_t:.2f} GB "
            f"plain {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # (c) ps23, w.r.t. the initial field: through the stage kernels (their
    # autograd Functions) and through the twins
    pcfg = vortex.VortexConfig(nx=VORTEX_NX, ny=VORTEX_NX, solver="ps23",
                               dt=1e-3, re=1000.0)
    psteps = {impl: vortex.make_spectral_step_half(
        dataclasses.replace(pcfg, rhs_impl=impl), f64, dev)
        for impl in ("auto", "torch")}

    def ps23_loss(w0, impl="auto"):
        hf = loop.advance(psteps[impl], vortex.half_init(w0),
                          GRAD_VORTEX_STEPS, graph=False)
        return torch.sum(vortex.half_decode(hf, pcfg.nx, pcfg.ny) ** 2)

    w0 = vortex.initial_vorticity(pcfg, f64, dev)
    v = grad_direction(VORTEX_NX, dev)

    def ps23_grad(impl="auto"):
        x = w0.clone().requires_grad_()
        (g,) = torch.autograd.grad(ps23_loss(x, impl), x)
        return g

    cuda_kernels.reset_launch_counts()
    g_k, peak_p = peak_gb(ps23_grad)
    p_launches = {k: n for k, n in cuda_kernels.LAUNCHES.items() if n}
    cuda_kernels.reset_launch_counts()
    g_t = ps23_grad("torch")
    twin_quiet = not any(cuda_kernels.LAUNCHES.values())
    rel_twin = float((g_k - g_t).abs().max() / g_t.abs().max())
    directional = float(torch.sum(g_k * v))
    del g_k, g_t
    h = 1e-6
    with torch.no_grad():
        fd = (float(ps23_loss(w0 + h * v)) - float(ps23_loss(w0 - h * v))) \
            / (2 * h)
    rel_fd = abs(directional - fd) / abs(fd)
    p_want = {k: n * GRAD_VORTEX_STEPS
              for k, n in VORTEX_STEP_LAUNCHES["ps23"].items()}
    ok = (rel_fd <= 1e-6 and math.isfinite(directional) and rel_twin <= 1e-12
          and twin_quiet and p_launches == p_want)
    line = (f"phase 16 gradient (c) ps23 {VORTEX_NX}^2 fp64 "
            f"({GRAD_VORTEX_STEPS} steps, dt=1e-3, Re=1000, graph=False): "
            f"directional derivative of sum(w^2) w.r.t. the initial field "
            f"along a seeded normal field {directional!r}, central FD "
            f"h={h:g} {fd!r} (rel {rel_fd:.2e}, tol 1e-6); the gradient "
            f"through the stage kernels ({json.dumps(p_launches)}, want "
            f"{json.dumps(p_want)}; backward torch ops) against the twins' "
            f"(rhs_impl=\"torch\", {'no' if twin_quiet else 'SOME'} kernel "
            f"launches): max|g_k - g_t| / max|g_t| = {rel_twin:.2e} (tol "
            f"1e-12); peak device memory {peak_p:.2f} GB "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    return {"cavity": launches, "ensemble": e_launches,
            "cavity_grad": cavity_grad}


# phase 18: the packed cavity's and the tiers' gradients; the fp32
# formulations' rel. bounds against the fp64 packed gradient (bf16x1, the
# tier that stalls: finite, the same sign, within 0.5)
GRAD_TIERS = {"fused": 1e-3, "fused_bf16x3": 2e-3, "fused_bf16x1": 0.5,
              "matmul_bf16x3": 2e-3, "matmul_bf16x1": 0.5}


def cavity_gradient(poisson, dtype, re_value, grad=True, w_grad=False):
    """The 1024^2 cavity of phase 16 (a) (dt=2e-5, Jensen walls,
    GRAD_CAVITY_STEPS eager steps from rest) on `poisson`: the full-grid
    step, or the packed one for fused*, its psi decoded.  Returns loss =
    1e6 mean(psi^2) (in fp64), d loss/dRe, d loss/d(initial w) (w_grad),
    the forward's and the backward's launches, and the seconds and the
    peak device memory (GB) of forward and backward together."""
    from cfd_julia_torch.models import cavity, cavity_fused
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import loop

    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                              poisson=poisson)
    fused = poisson.startswith("fused")
    out = {}

    def run():
        re = torch.tensor(re_value, dtype=dtype, device="cuda",
                          requires_grad=grad)
        if fused:
            step = cavity_fused.make_fused_step_fn(cfg, dtype, "cuda", re=re)
            state = cavity_fused.init_state(cfg, dtype, "cuda")
        else:
            step = cavity.make_step_fn(cfg, dtype, "cuda", re=re)
            state = cavity.initial_state(cfg, dtype, "cuda")
        w0 = state[0].clone().requires_grad_(w_grad)
        cuda_kernels.reset_launch_counts()
        with torch.set_grad_enabled(grad):
            final = loop.advance(step, (w0, *state[1:]), GRAD_CAVITY_STEPS,
                                 graph=False)
            psi = (cavity_fused.decode_state(cfg, final)[1] if fused
                   else final[1])
            loss = 1e6 * torch.mean(psi.double() ** 2)
        out["loss"] = float(loss.detach())
        out["forward"] = dict(cuda_kernels.LAUNCHES)
        if grad:
            cuda_kernels.reset_launch_counts()
            grads = torch.autograd.grad(loss, (re, w0) if w_grad else (re,))
            torch.cuda.synchronize()
            out["backward"] = dict(cuda_kernels.LAUNCHES)
            out["grad"] = float(grads[0])
            out["w_grad"] = grads[1] if w_grad else None

    t0 = time.perf_counter()
    _, out["peak_gb"] = peak_gb(run)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_packed_gradients(matmul_grad):
    """Phase 18 (after phase 16): gradients through the packed cavity and
    the bf16 tiers at phase 16 (a)'s configuration.  fp64 `fused` (the
    stage kernel and its backward kernel, fp64 cuBLAS products): d loss/dRe
    and d loss/d(initial w) in one backward pass, against phase 16's
    full-grid gradient matmul_grad (rel 1e-9) and central FD (h=0.5, rtol
    1e-4), the state gradient against the full-grid one mapped by
    pack_state (1e-9 of its scale, 0 in the padding); then each fp32
    formulation's d loss/dRe against the fp64 one beside its loss's own
    rel. difference, with as many backward stage (or RHS) launches as
    forward ones and, for a tier, as many tier_split and tier_gemm
    launches in the backward as in the forward (3 + 12 a step: a solve's
    chain, forward or backward, is one split and four GEMMs).  Returns
    the fp64 fused run's backward launches."""
    from cfd_julia_torch.models import cavity, cavity_fused

    f64, steps = torch.float64, GRAD_CAVITY_STEPS
    full = cavity_gradient("matmul", f64, RE, w_grad=True)
    ref = cavity_gradient("fused", f64, RE, w_grad=True)
    h = 0.5
    fd = (cavity_gradient("fused", f64, RE + h, grad=False)["loss"]
          - cavity_gradient("fused", f64, RE - h, grad=False)["loss"]) / (2 * h)
    g = ref["grad"]
    rel_matmul = abs(g - matmul_grad) / abs(matmul_grad)
    rel_full = abs(g - full["grad"]) / abs(full["grad"])
    rel_fd = abs(g - fd) / abs(fd)
    cfg = cavity.CavityConfig(nx=NX, ny=NX)
    mapped = cavity_fused.pack_state(cfg, full["w_grad"],
                                     torch.zeros_like(full["w_grad"]))[0]
    gw = ref["w_grad"]
    w_scale = float(mapped.abs().max())
    w_err = float((gw - mapped).abs().max()) / w_scale
    m = NX - 1
    pad_zero = not (gw[m:].any() or gw[:, m:].any())
    fwd, bwd = ref["forward"], ref["backward"]
    n_stage = fwd["cavity_fused_stage"]
    ok = (rel_matmul <= 1e-9 and rel_fd <= 1e-4 and w_err <= 1e-9
          and pad_zero and w_scale > 0 and math.isfinite(g) and g != 0.0
          and n_stage == 3 * steps
          and bwd["cavity_stage_backward"] == n_stage
          and not any(k.endswith("_re_grad") for k in bwd)
          and fwd["arakawa_rhs"] == bwd["arakawa_rhs_backward"] == 0
          and full["backward"]["arakawa_rhs_backward"]
          == full["forward"]["arakawa_rhs"] == 3 * steps)
    line = (f"phase 18 gradient (a) packed cavity {NX}^2 fp64 (poisson="
            f"fused, dt=2e-5, Re={RE:g}, {steps} steps from rest, graph="
            f"False): d(1e6 mean psi^2)/dRe = {g!r} through the stage kernel "
            f"and its backward kernel; phase 16's full-grid matmul gradient "
            f"{matmul_grad!r} (rel {rel_matmul:.2e}, tol 1e-9; recomputed "
            f"with the state gradient {full['grad']!r}, rel {rel_full:.2e}); "
            f"central FD h={h:g} {fd!r} (rel {rel_fd:.2e}, tol 1e-4); d/d(w0) "
            f"against the full-grid one mapped by pack_state: max|diff| "
            f"{w_err:.2e} of its scale {w_scale:.3e} (tol 1e-9), padding 0: "
            f"{pad_zero}; launches {n_stage} cavity_fused_stage, "
            f"{bwd['cavity_stage_backward']} cavity_stage_backward (want "
            f"{3 * steps} each); {ref['seconds']:.2f} s and "
            f"{ref['peak_gb']:.2f} GB peak (forward and backward), the "
            f"full-grid one {full['seconds']:.2f} s and "
            f"{full['peak_gb']:.2f} GB {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    for poisson, tol in GRAD_TIERS.items():
        r = cavity_gradient(poisson, torch.float32, RE)
        rel = abs(r["grad"] - g) / abs(g)
        rel_loss = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        fwd, bwd = r["forward"], r["backward"]
        rhs, rhs_back = (("cavity_fused_stage", "cavity_stage_backward")
                         if poisson.startswith("fused") else
                         ("arakawa_rhs", "arakawa_rhs_backward"))
        # a solve's chain (forward or backward): 1 split, 4 GEMMs
        gemms = 0 if poisson == "fused" else 12 * steps
        splits = gemms // 4
        ok = (math.isfinite(r["grad"]) and rel <= tol
              and math.copysign(1.0, r["grad"]) == math.copysign(1.0, g)
              and fwd[rhs] == bwd[rhs_back] == 3 * steps
              and fwd["tier_gemm"] == bwd["tier_gemm"] == gemms
              and fwd["tier_split"] == bwd["tier_split"] == splits)
        line = (f"phase 18 gradient (b) {poisson} {NX}^2 fp32: d(1e6 mean "
                f"psi^2)/dRe = {r['grad']!r}, rel {rel:.3e} of the fp64 "
                f"fused gradient (tol {tol:g}{', finite, the same sign' if tol == 0.5 else ''}); "
                f"the loss's own rel. difference {rel_loss:.3e}; launches "
                f"forward / backward: {rhs} {fwd[rhs]} / {rhs_back} "
                f"{bwd[rhs_back]}, tier_split {fwd['tier_split']} / "
                f"{bwd['tier_split']}, tier_gemm {fwd['tier_gemm']} / "
                f"{bwd['tier_gemm']} (want {3 * steps}, {splits} and "
                f"{gemms}); "
                f"{r['seconds']:.2f} s, {r['peak_gb']:.2f} GB peak "
                f"{'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
    return ref["backward"]


# ------------------------------------------------------- the user surface

# phase 17: the kernels (LAUNCHES keys) each preset's path must launch in
# run-all on the card; the other presets launch none of the hand-written
# kernels (cuFFT, cuBLAS and eager torch: heat, Burgers, the direct and
# the relaxation Poisson solves)
MG_PATH = ("smooth_residual_restrict", "prolong_correct_smooth",
           "redblack_sweeps")
# multigrid.solve also takes its rms0 through the residual sum (MG-CG
# keeps its own residuals)
MG_SOLVE_PATH = (*MG_PATH, "residual_ssq")
RUN_ALL_KERNELS = {
    "cavity": ("arakawa_rhs",), "vortex_merger_fdm": ("arakawa_rhs",),
    "tgv": ("arakawa_rhs",), "vortex_merger_ps23": VORTEX_PLANNED,
    "vortex_merger_ps32": (*VORTEX_PLANNED, "vortex_truncate_32"),
    "vortex_merger_hybrid": ("vortex_cn_combine",),
    "poisson_mg2": MG_SOLVE_PATH, "poisson_mgcg": MG_PATH,
    "poisson_mgN": MG_SOLVE_PATH,
    "euler_roe": ("euler_rhs",), "euler_hllc": ("euler_rhs",),
    "euler_rusanov": ("euler_rhs",),
}
# the order studies of tests/test_cli_tools.py, with its bounds on the
# observed orders (self-convergence: the p column)
ORDER_STUDIES = [
    (["heat", "--scheme", "icp", "--grids", "20,40,80"], "> 3.5",
     lambda p: p > 3.5),
    (["poisson", "--scheme", "fft", "--self", "--grids", "32,64,128"],
     "|p - 2| < 0.3", lambda p: abs(p - 2.0) < 0.3),
    (["burgers", "--scheme", "crweno", "--self", "--bc", "dirichlet",
      "--grids", "100,200,400"], "> 3.5", lambda p: p > 3.5),
]


def cli_main(argv):
    """cfd_julia_torch.cli.main(argv) in this process: (rc, stdout)."""
    from cfd_julia_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def cli_process(argv, timeout=600):
    """`python -m cfd_julia_torch <argv>` as its own process: (rc, stdout,
    stderr, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cfd_julia_torch", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def phase_cli_surface():
    """`list` and `validate` as processes on the card."""
    rc, out, err, seconds = cli_process(["list"])
    names = [ln.split()[0] for ln in out.splitlines()
             if ln and not ln.startswith(" ")]
    ok = rc == 0 and len(names) == 29 and names == sorted(names)
    line = (f"phase 17 cli `list`: rc {rc}, {len(names)} presets (want 29), "
            f"{seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, f"{line}\n{err[-2000:]}")
    rc, out, err, seconds = cli_process(["validate"])
    rows = out.splitlines()
    checks = [r for r in rows if r.startswith(("PASS ", "FAIL "))]
    ok = (rc == 0 and len(checks) == 7
          and all(r.startswith("PASS ") for r in checks)
          and rows[-1] == "validate: PASS")
    for r in checks:
        print(f"phase 17 cli `validate --device cuda`: {r}")
    line = (f"phase 17 cli `validate --device cuda`: rc {rc}, "
            f"{sum(r.startswith('PASS ') for r in checks)}/7 PASS, "
            f"process {seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, f"{line}\n{out[-2000:]}\n{err[-2000:]}")


# run-all's depth here: the point-Jacobi and red-black presets (eager
# relaxation sweeps, no hand-written kernel; 215 of run-all's 264 s on a
# slow host, PERF.md) stop at this many sweeps, not the quick table's 200k
RUN_ALL_RELAXATION_SWEEPS = 20_000


def phase_run_all():
    """`run-all` (its quick table, cli.QUICK, the relaxation presets cut to
    RUN_ALL_RELAXATION_SWEEPS: `--full` runs the point-Jacobi and red-black
    presets at 512^2 to their 2M-sweep cap, over 1000 s on an H100 at 700
    W, PERF.md) through cli.main in this process, every preset on the
    card: 29/29 OK, each metrics.json's device the card, seconds and
    kernel launches a preset (the counts set to 0 just before run-all and
    read after each preset), the path kernels launched; burgers_central's
    non-finite field reported, not gated (ROADMAP C).  Returns the
    counts over the whole run."""
    from cfd_julia_torch import run
    from cfd_julia_torch.ops import cuda_kernels

    card = torch.cuda.get_device_name()
    per = {}
    real = run.run_preset

    def recorded(name, **kw):
        if name in ("poisson_jacobi", "poisson_gs_redblack"):
            kw["max_iter"] = RUN_ALL_RELAXATION_SWEEPS
        before = dict(cuda_kernels.LAUNCHES)
        t0 = time.perf_counter()
        try:
            return real(name, **kw)
        finally:
            torch.cuda.synchronize()
            per[name] = (time.perf_counter() - t0, {
                k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items()
                if v != before[k]})

    with tempfile.TemporaryDirectory() as tmp:
        run.run_preset = recorded
        cuda_kernels.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            rc, out = cli_main(["run-all", "--outdir", tmp])
            total = time.perf_counter() - t0
        finally:
            run.run_preset = real
        launches = dict(cuda_kernels.LAUNCHES)
        lines = out.splitlines()
        ok_names = [ln.split()[1] for ln in lines if ln.startswith("OK ")]
        metrics = {name: json.loads((Path(tmp) / name / "metrics.json")
                                    .read_text()) for name in ok_names}
    names = sorted(per)
    all_ok = (rc == 0 and len(names) == 29 and ok_names == names
              and lines[-1] == "run-all: 29/29 presets OK")
    for name in names:
        seconds, counts = per[name]
        m = metrics.get(name, {})
        want = RUN_ALL_KERNELS.get(name, ())
        ok = (m.get("device") == card
              and all(counts.get(k, 0) > 0 for k in want))
        finite = all(math.isfinite(v) for v in m.values()
                     if isinstance(v, float))
        note = ""
        if not finite:
            # the central baseline is not finite past the shock in either
            # package at its t = 0.25 (ROADMAP C): reported, not gated
            ok = ok and name == "burgers_central"
            note = " non-finite field (reported, not gated)"
        all_ok = all_ok and ok
        print(f"phase 17 run-all {name} (quick): {seconds:.3f} s, launches "
              f"{json.dumps(counts, sort_keys=True)} (want > 0: "
              f"{', '.join(want) or 'none'}){note} {'ok' if ok else 'FAIL'}")
    line = (f"phase 17 cli `run-all` in-process on {card}: "
            f"{lines[-1] if lines else 'no output'}, "
            f"rc {rc}, {total:.2f} s; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})} "
            f"{'ok' if all_ok else 'FAIL'}")
    print(line)
    check(all_ok, line)
    return launches


def order_numbers(outdir, self_pairs):
    """(errors, orders) of an order study's text file: the errors and
    observed orders (order.txt), or each (triplet, norm)'s e1, e2 and p
    (order_self.txt)."""
    if self_pairs:
        rows = [ln.split() for ln in (Path(outdir) / "order_self.txt")
                .read_text().splitlines() if not ln.startswith("#")]
        errs = [float(v) for r in rows for v in r[4:6]]
        return errs, [float(r[6]) for r in rows]
    rows = (Path(outdir) / "order.txt").read_text().splitlines()
    errs = [float(r.split()[1]) for r in rows if not r.startswith("#")]
    ns = [int(r.split()[0]) for r in rows if not r.startswith("#")]
    return errs, [math.log(errs[i] / errs[i + 1]) / math.log(ns[i + 1] / ns[i])
                  for i in range(len(errs) - 1)]


def phase_order():
    """The three order studies of tests/test_cli_tools.py through cli.main
    in fp64 on the card, each against the same study with --device cpu in
    this process: errors within 1e-9 relative or 1e-12 absolute, whichever
    is larger (the errors are differences of O(1) fields; two fp64 runs of
    thousands of steps part by ~1e-13), orders at the tests' bounds."""
    for argv, bound_text, bound in ORDER_STUDIES:
        self_pairs = "--self" in argv
        res = {}
        for dev in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                rc, _ = cli_main(["order", *argv, "--outdir", tmp,
                                  "--device", dev])
                seconds = time.perf_counter() - t0
                check(rc == 0, f"order {' '.join(argv)} --device {dev}: "
                      f"rc {rc}")
                res[dev] = (*order_numbers(tmp, self_pairs), seconds)
        (eg, pg, sg), (ec, pc, sc) = res["cuda"], res["cpu"]
        worst = max(abs(a - b) / max(1e-9 * abs(b), 1e-12)
                    for a, b in zip(eg, ec))
        ok = worst <= 1.0 and all(bound(p) for p in pg)
        line = (f"phase 17 cli `order {' '.join(argv)}` fp64: orders on "
                f"the card {[round(p, 4) for p in pg]} ({bound_text}), "
                f"errors {[float(f'{e:.6e}') for e in eg]}; against "
                f"--device cpu: max |e_cuda - e_cpu| / max(1e-9 e, 1e-12) "
                f"{worst:.3f} (want <= 1); {sg:.2f} s on the card, "
                f"{sc:.2f} s on the CPU {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)


# the sweep's fp32 WENO runs overshoot max|u| = 1 by roundoff near the
# shock: up to 5e-6 on the CPU, 1e-4 on the card (ROADMAP C)
SWEEP_UMAX = 1.0 + 1e-4


def phase_sweep():
    """`run burgers_weno_dirichlet --sweep nx=100,200,400` on the card:
    three points in sweep_metrics.json, each on the card, and the
    reference's per-grid aliases solution_d_<nx>.txt in the top outdir."""
    card = torch.cuda.get_device_name()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc, _ = cli_main(["run", "burgers_weno_dirichlet", "--outdir", tmp,
                          "--sweep", "nx=100,200,400"])
        seconds = time.perf_counter() - t0
        sweep = json.loads((Path(tmp) / "sweep_metrics.json").read_text())
        top = sorted(p.name for p in Path(tmp).iterdir() if p.is_file())
    want = [f"solution_d_{n}.txt" for n in (100, 200, 400)]
    ok = (rc == 0 and [m["nx"] for m in sweep] == [100, 200, 400]
          and all(m["device"] == card for m in sweep)
          and all(w in top for w in want)
          and all(m["umax"] <= SWEEP_UMAX for m in sweep))
    line = (f"phase 17 cli `run burgers_weno_dirichlet --sweep "
            f"nx=100,200,400`: rc {rc}, {len(sweep)} points on "
            f"{sweep[0]['device'] if sweep else '?'}, umax "
            f"{[m['umax'] for m in sweep]}, tv {[m['tv'] for m in sweep]}, "
            f"top-level files {top}; {seconds:.2f} s "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def phase_examples():
    """examples.adjoint_cavity (fp64 d loss/dRe through kernel 1 and its
    backward kernel, against its central difference) and
    examples.vortex_diagnostics (128^2 ps23, t = 10: the budget identity)
    on the card, each with the counts set to 0 just before it."""
    from cfd_julia_torch.examples import adjoint_cavity, vortex_diagnostics
    from cfd_julia_torch.ops import cuda_kernels

    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = adjoint_cavity.main(["--device", "cuda"])
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in cuda_kernels.LAUNCHES.items() if v}
    ok = (res["fd_rel"] <= 1e-4 and counts.get("arakawa_rhs", 0) > 0
          and counts.get("arakawa_rhs_backward", 0) > 0
          and res["grads"][50.0] < res["grads"][100.0] < res["grads"][200.0]
          < 0)
    line = (f"phase 17 examples.adjoint_cavity (32^2, 100 steps, fp64): "
            f"loss {res['loss']!r}, d/dRe {res['grad']!r}, central FD "
            f"{res['fd']!r} (rel {res['fd_rel']:.2e}, tol 1e-4), d/dRe at "
            f"Re 50/100/200 {[res['grads'][r] for r in (50.0, 100.0, 200.0)]}"
            f"; launches {json.dumps(counts)}; {seconds:.2f} s "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)
    cuda_kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = vortex_diagnostics.main(["--nx", "128", "--device", "cuda",
                                           "--outdir", tmp])
        seconds = time.perf_counter() - t0
    z = [r[2] for r in res["rows"]]
    ok = (res["budget_defect"] < 1e-2 and np.isfinite(res["spectrum"]).all()
          and all(b < a for a, b in zip(z, z[1:])))
    line = (f"phase 17 examples.vortex_diagnostics (128^2 ps23, Re=1000, "
            f"t=10, fp32): Z {z[0]:.6e} -> {z[-1]:.6e} (decreasing), "
            f"enstrophy budget max relative defect "
            f"{res['budget_defect']:.3e} (tol 1e-2), E(k) peak at k="
            f"{res['k_peak']}; {seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def phase_nan_guard():
    """utils.debug.nan_guard on the card: a NaN fed to kernel 6 (Sod
    (3, 8192) fp32) and to kernel 1 (1025^2 fp32) raises
    FloatingPointError naming the kernel; the same calls outside the guard
    return (their output holds the NaN)."""
    from cfd_julia_torch.models import euler1d
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.utils import debug

    dev = torch.device("cuda")
    cfg = euler1d.EulerConfig(nx=8192)
    q = euler1d.sod_initial_state(cfg, torch.float32, dev)[1].contiguous()
    q[0, 4000] = float("nan")
    w = torch.randn(NX + 1, NX + 1, device=dev)
    s = torch.randn(NX + 1, NX + 1, device=dev)
    w[7, 9] = float("nan")
    calls = {
        "euler_rhs": lambda: cuda_kernels.euler_rhs_fused(q, cfg.gamma,
                                                          cfg.dx, "hllc"),
        "arakawa_rhs": lambda: cuda_kernels.arakawa_rhs_fused(
            w, s, 1.0 / NX, 1.0 / NX, RE),
    }
    for name, call in calls.items():
        out = call()
        unguarded = bool(torch.isnan(out).any())
        message = None
        try:
            with debug.nan_guard():
                call()
        except FloatingPointError as e:
            message = str(e)
        ok = (unguarded and message is not None and name in message
              and not cuda_kernels.CHECK_NAN)
        line = (f"phase 17 nan_guard {name}: a NaN fed to the kernel; "
                f"outside the guard it returns (NaN in its output: "
                f"{unguarded}), under it raises FloatingPointError "
                f"{message!r} {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)


def phase_user_surface():
    """Phase 17: the CLI's subcommands, the examples and the NaN guard on
    the card.  Returns run-all's launch counts."""
    t0 = time.perf_counter()
    phase_cli_surface()
    launches = phase_run_all()
    phase_order()
    phase_sweep()
    phase_examples()
    phase_nan_guard()
    print(f"phase 17 user surface: {time.perf_counter() - t0:.2f} s")
    return launches


# phase 19: the multi-device path (cfd_julia_torch/parallel/).  The 2x2
# runs put four ranks on the one card over gloo, halos and gathers staged
# through host memory: a correctness check, no scaling number.
MESH_RANKS = 4
MESH_MG = dict(tol=MG_TOL, max_cycles=20, transfers="matmul",
               smoother="cheb", fused="off")
# reps of a sharded cavity step's collectives replayed alone (halo/collective
# share)
MESH_COMM_REPS = 10


def card_text():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0].strip()


def mesh_cavity_cfg():
    from cfd_julia_torch.models import cavity

    return cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2)


def mesh_problem(device):
    """Phase 5's 4096^2 poly problem: (f, u0, ue, dx, dy)."""
    from cfd_julia_torch.models import poisson2d

    cfg = poisson2d.PoissonConfig(nx=MG_NX, ny=MG_NX, solver="multigrid",
                                  problem="poly")
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, torch.float32, device)
    return f, poisson2d._dirichlet_init(ue), ue, cfg.dx, cfg.dy


def cavity_comm_ms(mesh, shape, device):
    """ms of one sharded cavity step's collectives replayed alone on
    blocks of the step's shapes: a stage's width-2 exchange of the stacked
    (w, psi) and its solve's four gathers, three stages, and the rms sum."""
    from cfd_julia_torch.parallel import halo
    from cfd_julia_torch.parallel import mesh as mesh_lib

    rows, cols = mesh_lib.block_slices(shape, mesh)
    blk = torch.zeros((rows.stop - rows.start, cols.stop - cols.start),
                      device=device)
    stack, one = torch.stack([blk, blk]), torch.zeros((), device=device)

    def step():
        for _ in range(3):
            halo.halo_exchange_periodic(stack, mesh, 2)
            for _ in range(2):
                halo.all_gather_axis(blk, mesh, "x", 0)
                halo.all_gather_axis(blk, mesh, "y", 1)
        halo.all_reduce_sum(one)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_COMM_REPS):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / MESH_COMM_REPS


# phase 19 (f)-(h): the periodic spectral family and the cavity's fst /
# fst_half solve on the mesh.  Steps of (g) and of (f) held against the
# single-device step; ps23's full-spectrum run against the half form; the
# cavity's one-rank and 2x2 runs; replays of a step's transposes
MESH_VORTEX_CHECK = 10
MESH_PS23_FULL = 20
MESH_CAVITY_ONE, MESH_CAVITY_QUAD = 100, 20
REPLAY_REPS = 5
# the bodies of the collectives of parallel/halo.py and
# parallel/transpose.py, which their autograd Functions run forward and
# backward: (f)-(h) replay a step's transposes, (i) a backward's all
COLLECTIVES = {"halo": ("_shift", "_reduce_scatter", "_sum_over_ranks"),
               "transpose": ("_move",)}
TRANSPOSES = {"transpose": ("_move",)}
# eager steps of a one-rank mesh step and of the single-device step timed
# and profiled for their device time, side by side
MESH_PROFILE_STEPS = 5


def vortex_mesh_cfg(solver):
    from cfd_julia_torch.models import vortex

    return vortex.VortexConfig(nx=VORTEX_NX, ny=VORTEX_NX, solver=solver,
                               dt=1e-3, re=1000.0)


class Blank(NamedTuple):
    """A recorded call's tensor argument: what a replay makes zeros of."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


@contextlib.contextmanager
def recorded_collectives(calls, names=COLLECTIVES):
    """Append each call made inside of the functions `names` ({module of
    parallel/: function names}) to `calls`, as (function, arguments with
    every tensor a Blank)."""
    from cfd_julia_torch.parallel import halo, transpose

    saved = []
    for mod in (halo, transpose):
        for name in names.get(mod.__name__.rsplit(".", 1)[1], ()):
            real = getattr(mod, name)

            def spy(*args, real=real):
                calls.append((real, [
                    Blank(tuple(a.shape), a.dtype, a.device)
                    if isinstance(a, torch.Tensor) else a for a in args]))
                return real(*args)

            setattr(mod, name, spy)
            saved.append((mod, name, real))
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def recorded_moves(step, state):
    """The transposes (the parallel/transpose._move calls) of one step of
    `step` from `state`, recorded_collectives's way."""
    calls = []
    with recorded_collectives(calls, TRANSPOSES):
        step(state)
    torch.cuda.synchronize()
    return calls


def replay_calls_ms(calls):
    """ms of the recorded collectives replayed alone on zero tensors: the
    median of REPLAY_REPS replays after a warm one (0 for none).  The
    median: the 2x2 ranks share the host, whose other work makes single
    replays slower by up to twice."""
    if not calls:
        return 0.0
    bufs = [(fn, [torch.zeros(a.shape, dtype=a.dtype, device=a.device)
                  if isinstance(a, Blank) else a for a in args])
            for fn, args in calls]

    def once():
        for fn, args in bufs:
            fn(*args)
        torch.cuda.synchronize()

    once()
    times = []
    for _ in range(REPLAY_REPS):
        t0 = time.perf_counter()
        once()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def eager_step_times(step, state, steps=MESH_PROFILE_STEPS):
    """(ms a step, device busy ms a step, kernels a step) of `steps` eager
    steps from `state`, their results dropped: the wall time unprofiled,
    then the device's busy time under torch.profiler (profiled_kernels;
    None where it records no device event)."""
    def run():
        s = state
        for _ in range(steps):
            s = step(s)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels, _ = profiled_kernels(run)
    if not kernels:
        return ms, None, None
    return ms, busy_us(kernels)[0] / steps / 1e3, len(kernels) / steps


def eager_text(rec, single):
    """A one-rank mesh step's eager times beside the single-device step's
    (eager_step_times each)."""
    def one(t):
        ms, dev, kern = t
        busy = "device time not measured" if dev is None else \
            f"device busy {dev:.4f} ms in {kern:.0f} kernels"
        return f"{ms:.4f} ms a step, {busy}"

    return (f"eager: the mesh step {one(rec)}; the single-device step "
            f"{one(single)}")


def mesh_vortex(device, mesh, steps):
    """(f) / (g) on this rank: the four solvers at 2048^2 through the
    sharded steps (ps23, ps32, hybrid on row slabs of the half spectrum,
    fdm on blocks), MESH_VORTEX_CHECK steps, then on to `steps`: w
    gathered at the check (and, for ps23 on one rank, after
    MESH_PS23_FULL steps, beside its full-spectrum run), kernel-1 launches
    over the run, ms a step, a step's transposes replayed alone, peak
    memory."""
    from cfd_julia_torch.models import vortex
    from cfd_julia_torch.ops import cuda_kernels, spectral
    from cfd_julia_torch.parallel import halo, sharded, transpose
    from cfd_julia_torch.parallel import mesh as mesh_lib

    n = VORTEX_NX
    out = {"transport": halo.transport(mesh, device)}
    for solver in VORTEX_SOLVERS:
        cfg = vortex_mesh_cfg(solver)
        w0 = vortex.initial_vorticity(cfg, torch.float32, device)
        if solver == "fdm":
            step = sharded.make_sharded_vortex_step(cfg, mesh, torch.float32,
                                                    device)
            state = sharded.place(w0, mesh)

            def decode(s):
                return sharded.gather(s, mesh).cpu()
        else:
            step = sharded.make_sharded_vortex_step_half(
                cfg, mesh, torch.float32, device)
            state = vortex.half_init(mesh_lib.place_slab(w0, mesh), mesh)

            def decode(s):
                return sharded.gather_slab(vortex.half_decode(s, n, n, mesh),
                                           mesh, (n, n)).cpu()
        rec = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(MESH_VORTEX_CHECK):
            state = step(state)
        torch.cuda.synchronize()
        rec["first_s"] = time.perf_counter() - t0
        rec["w_check"] = decode(state)
        done = MESH_VORTEX_CHECK
        if steps > done and solver == "ps23":
            for _ in range(MESH_PS23_FULL - done):
                state = step(state)
            rec["w_full_check"] = decode(state)
            done = MESH_PS23_FULL
        if steps > done:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps - done):
                state = step(state)
            torch.cuda.synchronize()
            rec["step_ms"] = 1e3 * (time.perf_counter() - t0) / (steps - done)
            rec["w_last"] = decode(state)
        else:
            rec["step_ms"] = 1e3 * rec["first_s"] / MESH_VORTEX_CHECK
        rec["launches"] = dict(cuda_kernels.LAUNCHES)
        moves = recorded_moves(step, state)
        rec["moves"] = len(moves)
        rec["transpose_ms"] = replay_calls_ms(moves)
        rec["peak"] = torch.cuda.max_memory_allocated()
        if mesh_lib.world_size(mesh) == 1:
            rec["eager"] = eager_step_times(step, state)
        out[solver] = rec
        del state, step, moves
        if steps > MESH_VORTEX_CHECK and solver == "ps23":
            # the full complex spectrum in blocks, against the half form
            full = sharded.make_sharded_vortex_step(cfg, mesh, torch.float32,
                                                    device)
            wf = sharded.place(spectral.zero_mean_mode(spectral.fft2(
                w0.to(torch.complex64))), mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_PS23_FULL):
                wf = full(wf)
            torch.cuda.synchronize()
            out["ps23_full"] = {
                "step_ms": 1e3 * (time.perf_counter() - t0) / MESH_PS23_FULL,
                "w": sharded.gather_slab(spectral.ifft2(
                    transpose.move(wf, transpose.block_to_cols(mesh, (n, n))),
                    transpose.pencil(mesh, (n, n))).real, mesh, (n, n)).cpu()}
            del full, wf
        del w0
    return out


def mesh_cavity_fst(device, mesh, steps):
    """(h) on this rank: the 1024^2 cavity of phase 3's configuration with
    poisson="fst" and "fst_half" through cavity.make_step_fn(mesh=), psi
    gathered after MESH_CAVITY_QUAD steps and after `steps`, kernel-1
    launches, ms a step, a step's transposes replayed alone, peak memory."""
    import dataclasses

    from cfd_julia_torch.models import cavity
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.parallel import mesh as mesh_lib
    from cfd_julia_torch.parallel import sharded

    out = {}
    shape = mesh_lib.padded_shape((NX + 1, NX + 1), mesh)
    for poisson in ("fst", "fst_half"):
        cfg = dataclasses.replace(mesh_cavity_cfg(), poisson=poisson)
        step = cavity.make_step_fn(cfg, torch.float32, device, mesh=mesh)
        w0 = sharded.place(torch.zeros(shape, device=device), mesh)
        state = (w0, torch.zeros_like(w0), torch.zeros((), device=device))
        rec = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(MESH_CAVITY_QUAD):
            state = step(state)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        rec["psi_check"] = sharded.gather(state[1], mesh).cpu()
        if steps > MESH_CAVITY_QUAD:
            t0 = time.perf_counter()
            for _ in range(steps - MESH_CAVITY_QUAD):
                state = step(state)
            torch.cuda.synchronize()
            rec["step_ms"] = (1e3 * (time.perf_counter() - t0)
                              / (steps - MESH_CAVITY_QUAD))
            rec["psi_last"] = sharded.gather(state[1], mesh).cpu()
        else:
            rec["step_ms"] = 1e3 * first_s / MESH_CAVITY_QUAD
        rec["launches"] = dict(cuda_kernels.LAUNCHES)
        moves = recorded_moves(step, state)
        rec["moves"] = len(moves)
        rec["transpose_ms"] = replay_calls_ms(moves)
        rec["peak"] = torch.cuda.max_memory_allocated()
        if mesh_lib.world_size(mesh) == 1:
            rec["eager"] = eager_step_times(step, state)
        out[poisson] = rec
        del step, state, w0
    return out


# phase 19 (i): gradients through the mesh steps, fp64.  One rank: the fst
# cavity over phase 16 (a)'s 50 steps (and 10, for the 2x2 runs to meet);
# everything else 10 steps.  Central differences of the loss in Re with
# phase 16's step
MESH_GRAD_STEPS = GRAD_CAVITY_STEPS
MESH_GRAD_SHORT = GRAD_VORTEX_STEPS
MESH_GRAD_H = 0.5
MESH_GRAD_BUDGET_S = 90.0
def grad_run(forward):
    """forward() (the loss, replicated on every rank) and its .backward(),
    the kernels' counts set to 0 before each: the loss, the forward's and
    the backward's launches, seconds of both, the backward's ms, the peak
    device memory, and the backward's collectives (their number, and ms
    replayed alone)."""
    from cfd_julia_torch.ops import cuda_kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loss = forward()
    torch.cuda.synchronize()
    rec = {"loss": float(loss.detach()),
           "forward": dict(cuda_kernels.LAUNCHES)}
    cuda_kernels.reset_launch_counts()
    calls = []
    t1 = time.perf_counter()
    with recorded_collectives(calls):
        loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rec.update(backward=dict(cuda_kernels.LAUNCHES), seconds=t2 - t0,
               backward_ms=1e3 * (t2 - t1),
               peak=torch.cuda.max_memory_allocated(),
               collectives=len(calls), collective_ms=replay_calls_ms(calls))
    return rec


def grad_cavity_cfg(poisson):
    """Phase 16 (a)'s cavity with another Poisson solve."""
    from cfd_julia_torch.models import cavity

    return cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2,
                               poisson=poisson)


def grad_direction(n, device, dtype=torch.float64):
    """Phase 16 (c)'s seeded direction in the initial field."""
    return torch.as_tensor(np.random.default_rng(11).standard_normal(
        (n, n)), dtype=dtype, device=device)


def mesh_gradients(device, mesh):
    """(i) on this rank, fp64, each loss replicated by halo.all_reduce_sum
    and its .backward() run on every rank: the cavity's d(1e6 mean
    psi^2)/dRe and d/d(initial w) through make_step_fn(mesh=, re=<0-d
    tensor>), fst over MESH_GRAD_STEPS and MESH_GRAD_SHORT steps (one rank)
    or MESH_GRAD_SHORT (2x2), fst_half over MESH_GRAD_SHORT, and on one
    rank their central differences; the fdm vortex's d mean(w^2)/dRe
    through make_fdm_rhs(mesh=, re=); on one rank ps23's directional
    derivative of sum(w^2) in the initial field."""
    import dataclasses

    from cfd_julia_torch.models import cavity, vortex
    from cfd_julia_torch.parallel import halo, sharded
    from cfd_julia_torch.parallel import mesh as mesh_lib
    from cfd_julia_torch.stepping import ssprk3

    f64 = torch.float64
    one = mesh_lib.world_size(mesh) == 1
    shape = mesh_lib.padded_shape((NX + 1, NX + 1), mesh)
    n_nodes = float((NX + 1) ** 2)

    def cavity_run(poisson, steps, re_value, grad=True):
        re = torch.tensor(re_value, dtype=f64, device=device,
                          requires_grad=grad)
        step = cavity.make_step_fn(grad_cavity_cfg(poisson), f64, device,
                                   re=re, mesh=mesh)
        w0 = sharded.place(torch.zeros(shape, dtype=f64, device=device),
                           mesh).requires_grad_(grad)

        def forward():
            st = (w0, torch.zeros_like(w0),
                  torch.zeros((), dtype=f64, device=device))
            for _ in range(steps):
                st = step(st)
            return 1e6 * halo.all_reduce_sum((st[1] ** 2).sum()) / n_nodes

        if not grad:
            with torch.no_grad():
                return float(forward())
        rec = grad_run(forward)
        rec.update(re_grad=float(re.grad),
                   w_grad=sharded.gather(w0.grad, mesh).cpu())
        return rec

    out = {"cavity": {}}
    runs = [("fst", MESH_GRAD_SHORT), ("fst_half", MESH_GRAD_SHORT)]
    if one:
        runs.insert(0, ("fst", MESH_GRAD_STEPS))
    for poisson, steps in runs:
        rec = cavity_run(poisson, steps, RE)
        if one and (poisson, steps) != ("fst", MESH_GRAD_SHORT):
            rec["fd"] = (cavity_run(poisson, steps, RE + MESH_GRAD_H, False)
                         - cavity_run(poisson, steps, RE - MESH_GRAD_H,
                                      False)) / (2 * MESH_GRAD_H)
        out["cavity"][(poisson, steps)] = rec
        torch.cuda.empty_cache()

    cfg = vortex_mesh_cfg("fdm")
    re = torch.tensor(cfg.re, dtype=f64, device=device, requires_grad=True)
    rhs = vortex.make_fdm_rhs(cfg, f64, device, re=re, mesh=mesh)
    w0 = sharded.place(vortex.initial_vorticity(cfg, f64, device), mesh)

    def fdm_forward():
        w = w0
        for _ in range(MESH_GRAD_SHORT):
            w = ssprk3.ssprk3_step(rhs, w, cfg.dt)
        return halo.all_reduce_sum((w ** 2).sum()) / (cfg.nx * cfg.ny)

    out["fdm"] = grad_run(fdm_forward)
    out["fdm"]["re_grad"] = float(re.grad)
    del rhs, w0
    torch.cuda.empty_cache()
    if one:
        # ps23 through the stage kernels, and through their twins
        cfg = vortex_mesh_cfg("ps23")
        n = cfg.nx
        v = mesh_lib.place_slab(grad_direction(n, device), mesh)
        grads = {}
        for impl, key in [("auto", "ps23"), ("torch", "ps23_twin")]:
            step = vortex.make_spectral_step_half(
                dataclasses.replace(cfg, rhs_impl=impl), f64, device,
                mesh=mesh)
            w0 = mesh_lib.place_slab(
                vortex.initial_vorticity(cfg, f64, device),
                mesh).requires_grad_()

            def ps23_forward():
                h = vortex.half_init(w0, mesh)
                for _ in range(MESH_GRAD_SHORT):
                    h = step(h)
                return halo.all_reduce_sum(
                    (vortex.half_decode(h, n, n, mesh) ** 2).sum())

            out[key] = grad_run(ps23_forward)
            with torch.no_grad():
                out[key]["directional"] = float(
                    halo.all_reduce_sum((w0.grad * v).sum()))
            grads[key] = w0.grad
            del step, w0
        # the two gradients' difference, of the twins' scale
        out["ps23"]["rel_twin"] = float(
            (grads["ps23"] - grads["ps23_twin"]).abs().max()
            / grads["ps23_twin"].abs().max())
        del v, grads
        torch.cuda.empty_cache()
    return out


def single_gradients(dev="cuda"):
    """The single-device fp64 gradients phase 19 (i) is held against, on
    the card: the cavity's (fst over MESH_GRAD_STEPS, fst_half over
    MESH_GRAD_SHORT steps: d loss/dRe and d loss/d(initial w)), fdm's
    d mean(w^2)/dRe and ps23's directional derivative, each loss as
    mesh_gradients's."""
    from cfd_julia_torch.models import cavity, vortex
    from cfd_julia_torch.stepping import ssprk3

    f64 = torch.float64
    out = {}
    t0 = time.perf_counter()
    for poisson, steps in [("fst", MESH_GRAD_STEPS),
                           ("fst_half", MESH_GRAD_SHORT)]:
        cfg = grad_cavity_cfg(poisson)
        re = torch.tensor(RE, dtype=f64, device=dev, requires_grad=True)
        step = cavity.make_step_fn(cfg, f64, dev, re=re)
        st = cavity.initial_state(cfg, f64, dev)
        w0 = st[0].clone().requires_grad_()
        st = (w0, *st[1:])
        for _ in range(steps):
            st = step(st)
        (1e6 * (st[1] ** 2).sum() / float((NX + 1) ** 2)).backward()
        out[poisson] = {"re_grad": float(re.grad), "w_grad": w0.grad.cpu()}
        del step, st, w0
    cfg = vortex_mesh_cfg("fdm")
    re = torch.tensor(cfg.re, dtype=f64, device=dev, requires_grad=True)
    rhs = vortex.make_fdm_rhs(cfg, f64, dev, re=re)
    w = vortex.initial_vorticity(cfg, f64, dev)
    for _ in range(MESH_GRAD_SHORT):
        w = ssprk3.ssprk3_step(rhs, w, cfg.dt)
    ((w ** 2).sum() / (cfg.nx * cfg.ny)).backward()
    out["fdm"] = float(re.grad)
    del rhs, w
    cfg = vortex_mesh_cfg("ps23")
    step = vortex.make_spectral_step_half(cfg, f64, dev)
    w0 = vortex.initial_vorticity(cfg, f64, dev).requires_grad_()
    h = vortex.half_init(w0)
    for _ in range(MESH_GRAD_SHORT):
        h = step(h)
    (vortex.half_decode(h, cfg.nx, cfg.ny) ** 2).sum().backward()
    out["ps23"] = float((w0.grad * grad_direction(cfg.nx, dev)).sum())
    del step, w0, h
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_rank(device, steps, save_to, load_from):
    """One rank of phase 19 (run by parallel/launch.py): the sharded 1024^2
    cavity for `steps` steps, psi gathered at step 100 and at the end, the
    kernel launches of the first 100 steps; save_to: save the state with
    save_sharded and load it back on this mesh; load_from: (path, global
    shape) of another mesh's checkpoint to load here; the 4096^2 mesh
    multigrid solve."""
    import torch.distributed as dist

    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.parallel import halo, sharded
    from cfd_julia_torch.parallel import mesh as mesh_lib
    from cfd_julia_torch.poisson import multigrid
    from cfd_julia_torch.utils import checkpoint

    mesh = mesh_lib.make_mesh("cuda")
    out = {"mesh": tuple(mesh.shape), "backend": dist.get_backend(),
           "transport": halo.transport(mesh, device)}
    shape = mesh_lib.padded_shape((NX + 1, NX + 1), mesh)
    step = sharded.make_sharded_cavity_step(mesh_cavity_cfg(), mesh,
                                            torch.float32, device)
    w0 = sharded.place(torch.zeros(shape, device=device), mesh)
    state = (w0, torch.zeros_like(w0), torch.zeros((), device=device))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(STEPS_FIRST):
        state = step(state)
    torch.cuda.synchronize()
    out["step_ms"] = 1e3 * (time.perf_counter() - t0) / STEPS_FIRST
    out["psi_first"] = sharded.gather(state[1], mesh).cpu()
    t1 = time.perf_counter()
    for _ in range(steps - STEPS_FIRST):
        state = step(state)
    torch.cuda.synchronize()
    out["cavity_s"] = time.perf_counter() - t0
    if steps > STEPS_FIRST:
        out["late_ms"] = 1e3 * (time.perf_counter() - t1) / (steps - STEPS_FIRST)
    out["launches"] = dict(cuda_kernels.LAUNCHES)
    out["psi_last"] = sharded.gather(state[1], mesh).cpu()
    out["cavity_peak"] = torch.cuda.max_memory_allocated()
    out["comm_ms"] = cavity_comm_ms(mesh, shape, device)

    if save_to:
        as_saved = (sharded.as_dtensor(state[0], mesh),
                    sharded.as_dtensor(state[1], mesh), state[2])
        t0 = time.perf_counter()
        checkpoint.save_sharded(save_to, as_saved)
        out["save_s"] = time.perf_counter() - t0
        blank = tuple(torch.full_like(t, float("nan")) for t in state)
        back = checkpoint.load_sharded(
            save_to, (sharded.as_dtensor(blank[0], mesh),
                      sharded.as_dtensor(blank[1], mesh), blank[2]))
        out["reload_bitwise"] = all(
            torch.equal(a, b) for a, b in
            zip((back[0].to_local(), back[1].to_local(), back[2]), state))
        out["saved"] = tuple(sharded.gather(t, mesh) for t in state[:2]) \
            + (state[2],)
    if load_from:
        path, global_shape = load_from
        blank = sharded.place(torch.full(global_shape, float("nan"),
                                         device=device), mesh)
        t0 = time.perf_counter()
        got = checkpoint.load_sharded(
            path, (sharded.as_dtensor(blank, mesh),
                   sharded.as_dtensor(blank.clone(), mesh),
                   torch.zeros((), device=device)))
        out["load_s"] = time.perf_counter() - t0
        out["loaded"] = (sharded.gather(got[0].to_local(), mesh),
                         sharded.gather(got[1].to_local(), mesh), got[2])

    f, u0, _, dx, dy = mesh_problem(device)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = multigrid.solve(f, u0, dx, dy, cfg=multigrid.MGConfig(**MESH_MG),
                          mesh=mesh)
    torch.cuda.synchronize()
    out["mg"] = {"u": res.u, "iterations": res.iterations,
                 "rel": float(res.rms / res.rms0),
                 "seconds": time.perf_counter() - t0,
                 "peak": torch.cuda.max_memory_allocated()}
    del f, u0, res
    torch.cuda.empty_cache()
    one = mesh_lib.world_size(mesh) == 1
    t0 = time.perf_counter()
    out["vortex"] = mesh_vortex(device, mesh,
                                VORTEX_TOTAL if one else MESH_VORTEX_CHECK)
    out["vortex_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["cavity_fst"] = mesh_cavity_fst(
        device, mesh, MESH_CAVITY_ONE if one else MESH_CAVITY_QUAD)
    out["cavity_fst_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["grad"] = mesh_gradients(device, mesh)
    out["grad_s"] = time.perf_counter() - t0
    return out


def phase_mesh():
    """Phase 19: (b, c, d-save) on 2x2 ranks over gloo, then (a, c, d-load)
    on one rank over NCCL, each group launched once; the single-device
    padded step and multigrid solve in this process; (e) the example.
    Returns the kernel-1 launches of each 2x2 rank and of world 1."""
    from cfd_julia_torch.models import cavity
    from cfd_julia_torch.parallel import launch
    from cfd_julia_torch.poisson import multigrid

    card = card_text()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "cavity_2x2")
        t0 = time.perf_counter()
        quad = launch.run(mesh_rank, MESH_RANKS, "cuda",
                          args=(STEPS_FIRST, ckpt, None))
        quad_s = time.perf_counter() - t0
        shape = tuple(quad[0]["saved"][0].shape)
        t0 = time.perf_counter()
        one = launch.run(mesh_rank, 1, "cuda",
                         args=(STEPS_TOTAL, None, (ckpt, shape)))[0]
        one_s = time.perf_counter() - t0

    def gb(b):
        return f"{b / 2**30:.3f} GB"

    # (a) world 1 over NCCL at full width, against the anchors and the
    # single-device padded step
    cfg = mesh_cavity_cfg()
    step = cavity.make_padded_step_fn(cfg, (NX + 1, NX + 1), torch.float32,
                                      "cuda")
    w = torch.zeros((NX + 1, NX + 1), device="cuda")
    st = (w, torch.zeros_like(w), torch.zeros((), device="cuda"))
    for _ in range(STEPS_FIRST):
        st = step(st)
    single = st[1].cpu()
    scale = float(single.abs().max())
    anchor_check(one["psi_first"], STEPS_FIRST, "phase 19 (a) world 1")
    anchor_check(one["psi_last"], STEPS_TOTAL, "phase 19 (a) world 1")
    d_one = float((one["psi_first"] - single).abs().max())
    k1 = one["launches"]["arakawa_rhs"]
    ok = (one["backend"] == "nccl" and d_one <= 1e-5 * scale
          and k1 == 3 * STEPS_TOTAL)
    line = (f"phase 19 (a) sharded cavity {NX}^2 fp32, world 1 {one['mesh']} "
            f"({one['transport']}): {STEPS_TOTAL} steps in "
            f"{one['cavity_s']:.3f} s ({one['step_ms']:.4f} ms a step over the "
            f"first {STEPS_FIRST}, {one['late_ms']:.4f} over the rest), peak "
            f"{gb(one['cavity_peak'])}, the step's collectives alone "
            f"{one['comm_ms']:.4f} ms ({one['comm_ms'] / one['late_ms']:.1%}); "
            f"kernel 1 {k1} launches (want {3 * STEPS_TOTAL}); max|psi - padded single-device step| @"
            f"{STEPS_FIRST} = {d_one:.3e} (tol 1e-5 x {scale:.6g}); group "
            f"{one_s:.2f} s; {card} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # (b) 2x2 ranks on the one card over gloo, host-staged
    n = NX + 1
    for rank, r in enumerate(quad):
        d = float((r["psi_first"][:n, :n] - one["psi_first"]).abs().max())
        pad = float(r["psi_first"][n:].abs().max()
                    + r["psi_first"][:, n:].abs().max())
        k1 = r["launches"]["arakawa_rhs"]
        ok = (r["backend"] == "gloo" and "host memory" in r["transport"]
              and d <= 1e-5 * scale and pad == 0.0
              and k1 == 3 * STEPS_FIRST)
        line = (f"phase 19 (b) sharded cavity {NX}^2 fp32, rank {rank} of "
                f"{r['mesh']} on one card ({r['transport']}): {STEPS_FIRST} "
                f"steps in {r['cavity_s']:.3f} s ({r['step_ms']:.4f} ms a "
                f"step), peak {gb(r['cavity_peak'])}, the step's collectives "
                f"alone {r['comm_ms']:.4f} ms "
                f"({r['comm_ms'] / r['step_ms']:.1%} of the step); kernel 1 "
                f"{k1} launches (want {3 * STEPS_FIRST}); max|psi - world "
                f"1| @{STEPS_FIRST} = {d:.3e} (tol 1e-5 x {scale:.6g}), "
                f"padding {pad:g}; {card} {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
    anchor_check(quad[0]["psi_first"][:n, :n], STEPS_FIRST,
                 "phase 19 (b) 2x2")

    # (c) the 4096^2 mesh multigrid solve against the single-device one
    f, u0, ue, dx, dy = mesh_problem("cuda")
    mgc = multigrid.MGConfig(**MESH_MG)
    multigrid.solve(f, u0, dx, dy, cfg=mgc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = multigrid.solve(f, u0, dx, dy, cfg=mgc)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    u_scale = float(ref.u.abs().max())
    for label, r, world in [("world 1", one["mg"], 1),
                            *((f"2x2 rank {k}", q["mg"], MESH_RANKS)
                              for k, q in enumerate(quad))]:
        u = r["u"].cuda()
        d = float((u - ref.u).abs().max())
        rel_ind = recheck_rel(u, f, u0, dx, dy)
        extra = r["iterations"] - ref.iterations
        ok = (0 <= extra <= 1 and r["rel"] <= MG_TOL
              and rel_ind <= 4 * MG_TOL and d <= 1e-5 * u_scale
              and bool(torch.isfinite(u).all()))
        line = (f"phase 19 (c) mesh multigrid {MG_NX}^2 poly fp32 cheb/"
                f"matmul, {label}: {r['iterations']} cycles (single-device "
                f"{ref.iterations}, {extra:+d}; at most one more) rms/rms0="
                f"{r['rel']:.3e} (tol {MG_TOL:g}) fp64 recheck of the gathered "
                f"u {rel_ind:.3e} (tol {4 * MG_TOL:g}); max|u - single| = "
                f"{d:.3e} (tol 1e-5 x {u_scale:.6g}); {r['seconds']:.3f} s a "
                f"solve (single-device {ref_s:.3f} s), peak "
                f"{gb(r['peak'])}; {card} {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
    del f, u0, ue, ref

    # (d) save_sharded on 2x2, load_sharded on 2x2 and on world 1
    saved, loaded = quad[0]["saved"], one["loaded"]
    same = [bool(r["reload_bitwise"]) for r in quad]
    cross = all(torch.equal(a, b) for a, b in zip(saved, loaded))
    ok = all(same) and cross
    line = (f"phase 19 (d) save_sharded of the 2x2 state {tuple(shape)} "
            f"({max(r['save_s'] for r in quad):.3f} s), load_sharded on 2x2 "
            f"bitwise {same}, on world 1 bitwise {cross} "
            f"({one['load_s']:.3f} s); {card} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # (e) the example, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cfd_julia_torch.examples.multichip_cavity",
         "--ranks", str(MESH_RANKS), "--device", "cuda"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    ex_s = time.perf_counter() - t0
    m = re.search(r"\|\|dpsi\|\| = (\S+),", proc.stdout)
    dpsi = float(m.group(1).rstrip(",")) if m else float("nan")
    ok = (proc.returncode == 0 and math.isfinite(dpsi) and dpsi > 0
          and "staged through host memory" in proc.stdout)
    line = (f"phase 19 (e) `python -m cfd_julia_torch.examples.multichip_cavity"
            f" --ranks {MESH_RANKS} --device cuda`: rc {proc.returncode}, "
            f"||dpsi|| = {dpsi:.9g}, {ex_s:.2f} s; {card} "
            f"{'ok' if ok else 'FAIL'}")
    print(line)
    for text in proc.stdout.strip().splitlines():
        print(f"  {text}")
    if not ok:
        print(proc.stderr[-4000:])
    check(ok, line)
    vortex_launches = phase_mesh_spectral(one, quad, card, gb)
    grad_launches = phase_mesh_gradients(one, quad, card, gb)
    print(f"phase 19 multi-device: 2x2 group {quad_s:.2f} s (its (g) "
          f"{max(r['vortex_s'] for r in quad):.2f} s, (h) "
          f"{max(r['cavity_fst_s'] for r in quad):.2f} s), world-1 group "
          f"{one_s:.2f} s ((f) {one['vortex_s']:.2f} s, (h) "
          f"{one['cavity_fst_s']:.2f} s), phase "
          f"{time.perf_counter() - t_phase:.2f} s; {card}")
    return ([r["launches"]["arakawa_rhs"] for r in quad],
            one["launches"]["arakawa_rhs"], vortex_launches, grad_launches)


def phase_mesh_gradients(one, quad, card, gb, device="cuda"):
    """Phase 19 (i) from the two groups' results (mesh_gradients), against
    the single-device gradients run here.  Returns the kernel-1 backward
    launches of each 2x2 rank and of world 1, for the cavity and fdm."""
    single = single_gradients(device)
    n = NX + 1

    def launches_ok(rec, steps):
        f, b = rec["forward"], rec["backward"]
        return (f["arakawa_rhs"] == 3 * steps
                and b["arakawa_rhs_backward"] == f["arakawa_rhs"]
                and not any(k.endswith("_re_grad") for k in b))

    def cost(rec):
        share = rec["collective_ms"] / rec["backward_ms"]
        return (f"{rec['seconds']:.3f} s forward and backward (backward "
                f"{rec['backward_ms']:.2f} ms, its {rec['collectives']} "
                f"collectives replayed alone {rec['collective_ms']:.2f} ms, "
                f"{share:.1%}), peak {gb(rec['peak'])}; launches forward "
                f"{rec['forward']['arakawa_rhs']} arakawa_rhs, backward "
                f"{rec['backward']['arakawa_rhs_backward']} "
                f"arakawa_rhs_backward")

    def field_err(got, ref):
        """max|got - ref| over the logical nodes, over max|ref|, and the
        largest |got| on the padding."""
        pad = max((float(t.abs().max()) for t in (got[n:], got[:, n:])
                   if t.numel()), default=0.0)
        return float((got[:n, :n] - ref).abs().max()
                     / ref.abs().max()), pad

    # (i-1) one NCCL rank against the single-device gradients and FD
    g1 = one["grad"]
    for poisson, steps in [("fst", MESH_GRAD_STEPS),
                           ("fst_half", MESH_GRAD_SHORT)]:
        rec, ref = g1["cavity"][(poisson, steps)], single[poisson]
        rel = abs(rec["re_grad"] - ref["re_grad"]) / abs(ref["re_grad"])
        rel_fd = abs(rec["re_grad"] - rec["fd"]) / abs(rec["fd"])
        w_err, pad = field_err(rec["w_grad"], ref["w_grad"])
        ok = (rel <= 1e-9 and rel_fd <= 1e-4 and w_err <= 1e-9
              and pad == 0.0 and launches_ok(rec, steps)
              and one["backend"] == "nccl")
        line = (f"phase 19 (i-1) cavity gradient {NX}^2 fp64 poisson="
                f"{poisson}, make_step_fn(mesh=, re=<0-d tensor>), world 1 "
                f"{one['mesh']}, {steps} steps from rest: d(1e6 mean "
                f"psi^2)/dRe = {rec['re_grad']!r}, single-device "
                f"{ref['re_grad']!r} (rel {rel:.2e}, tol 1e-9), central FD "
                f"h={MESH_GRAD_H:g} {rec['fd']!r} (rel {rel_fd:.2e}, tol "
                f"1e-4); d/d(initial w) within {w_err:.2e} of max|single| "
                f"{float(ref['w_grad'].abs().max()):.6g} (tol 1e-9), padding "
                f"{pad:g}; {cost(rec)}; {card} {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)

    # (i-2) 2x2 gloo ranks against the one rank's 10-step gradients
    for poisson in ("fst", "fst_half"):
        ref = g1["cavity"][(poisson, MESH_GRAD_SHORT)]
        for rank, r in enumerate(quad):
            rec = r["grad"]["cavity"][(poisson, MESH_GRAD_SHORT)]
            rel = abs(rec["re_grad"] - ref["re_grad"]) / abs(ref["re_grad"])
            w_err, pad = field_err(rec["w_grad"], ref["w_grad"])
            ok = (rel <= 1e-9 and w_err <= 1e-9 and pad == 0.0
                  and launches_ok(rec, MESH_GRAD_SHORT)
                  and r["backend"] == "gloo")
            line = (f"phase 19 (i-2) cavity gradient {NX}^2 fp64 poisson="
                    f"{poisson}, rank {rank} of {r['mesh']} on one card "
                    f"({r['transport']}), {MESH_GRAD_SHORT} steps: dRe "
                    f"{rec['re_grad']!r}, world 1 {ref['re_grad']!r} (rel "
                    f"{rel:.2e}, tol 1e-9); d/d(initial w) within "
                    f"{w_err:.2e} of max|world 1| (tol 1e-9), padding "
                    f"{pad:g}; {cost(rec)}; {card} {'ok' if ok else 'FAIL'}")
            print(line)
            check(ok, line)

    # (i-3) fdm on one rank and on 2x2 against the single-device gradient
    for label, r in [("world 1", one), *((f"rank {k} of 2x2", q)
                                         for k, q in enumerate(quad))]:
        rec = r["grad"]["fdm"]
        rel = abs(rec["re_grad"] - single["fdm"]) / abs(single["fdm"])
        ok = rel <= 1e-9 and launches_ok(rec, MESH_GRAD_SHORT)
        line = (f"phase 19 (i-3) fdm gradient {VORTEX_NX}^2 fp64, "
                f"make_fdm_rhs(mesh=, re=<0-d tensor>), {label} {r['mesh']} "
                f"({r['transport']}), {MESH_GRAD_SHORT} SSP-RK3 steps: d "
                f"mean(w^2)/dRe = {rec['re_grad']!r}, single-device "
                f"{single['fdm']!r} (rel {rel:.2e}, tol 1e-9); {cost(rec)}; "
                f"{card} {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)

    # (i-4) ps23's half step on one rank, through the stage kernels and
    # through their twins
    rec, twin = g1["ps23"], g1["ps23_twin"]
    rel = abs(rec["directional"] - single["ps23"]) / abs(single["ps23"])
    rel_twin = rec["rel_twin"]
    fwd = {k: c for k, c in rec["forward"].items() if c}
    # the mesh step runs the passes alone (its transforms are torch.fft's)
    want = {k: c * MESH_GRAD_SHORT
            for k, c in VORTEX_STEP_LAUNCHES["ps23"].items()
            if k in VORTEX_PASSES}
    ok = (rel <= 1e-9 and math.isfinite(rec["directional"])
          and rel_twin <= 1e-12 and fwd == want
          and not any(twin["forward"].values()))
    line = (f"phase 19 (i-4) ps23 gradient {VORTEX_NX}^2 fp64, "
            f"make_spectral_step_half(mesh=), world 1, {MESH_GRAD_SHORT} "
            f"steps: the directional derivative of sum(w^2) in the initial "
            f"field along phase 16 (c)'s direction {rec['directional']!r}, "
            f"single-device {single['ps23']!r} (rel {rel:.2e}, tol 1e-9); "
            f"the stage kernels' launches {json.dumps(fwd)} (want "
            f"{json.dumps(want)}), the gradient against the twins' "
            f"(rhs_impl=\"torch\", {twin['seconds']:.3f} s): max|g_k - g_t| "
            f"/ max|g_t| = {rel_twin:.2e} (tol 1e-12); "
            f"{rec['seconds']:.3f} s forward and backward, peak "
            f"{gb(rec['peak'])}; {card} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    quad_s = max(r["grad_s"] for r in quad)
    total = one["grad_s"] + quad_s + single["seconds"]
    ok = total <= MESH_GRAD_BUDGET_S
    line = (f"phase 19 (i) gradients: {total:.2f} s (world 1 "
            f"{one['grad_s']:.2f} s, 2x2 {quad_s:.2f} s, the single-device "
            f"references {single['seconds']:.2f} s; budget "
            f"{MESH_GRAD_BUDGET_S:g} s); {card} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    def backward_launches(r, kind):
        recs = (r["grad"]["cavity"].values() if kind == "cavity"
                else [r["grad"]["fdm"]])
        return {"arakawa_rhs_backward": sum(
            rec["backward"]["arakawa_rhs_backward"] for rec in recs)}

    return {kind: ([backward_launches(r, kind) for r in quad],
                   backward_launches(one, kind))
            for kind in ("cavity", "fdm")}


def single_vortex(solver, steps, device="cuda"):
    """The single-device step of phase 9's path after `steps` steps: w,
    and the eager step's times from there (eager_step_times)."""
    from cfd_julia_torch.models import vortex
    from cfd_julia_torch.stepping import loop

    cfg = vortex_mesh_cfg(solver)
    step = vortex.make_step(cfg, torch.float32, device)
    w0 = vortex.initial_vorticity(cfg, torch.float32, device)
    if solver == "fdm":
        w = loop.advance(step, w0, steps, graph=False)
        return w.cpu(), eager_step_times(step, w)
    h = loop.advance(step, vortex.half_init(w0), steps, graph=False)
    return (vortex.half_decode(h, cfg.nx, cfg.ny).cpu(),
            eager_step_times(step, h))


def phase_mesh_spectral(one, quad, card, gb, device="cuda"):
    """Phase 19 (f)-(h) from the two groups' results, against the
    single-device steps run here on `device`.  Returns the fdm kernel-1
    launches of world 1 and of each 2x2 rank."""
    import dataclasses

    from cfd_julia_torch.models import cavity
    from cfd_julia_torch.stepping import loop

    def share(rec):
        return (f"{rec['step_ms']:.4f} ms a step, its {rec['moves']} "
                f"transposes alone {rec['transpose_ms']:.4f} ms "
                f"({rec['transpose_ms'] / rec['step_ms']:.1%}), peak "
                f"{gb(rec['peak'])}")

    # (f) one rank over NCCL at 2048^2
    f = one["vortex"]
    checks = {}
    for solver in VORTEX_SOLVERS:
        rec = f[solver]
        single, single_times = single_vortex(solver, MESH_VORTEX_CHECK,
                                             device)
        scale = float(single.abs().max())
        d = float((rec["w_check"] - single).abs().max())
        checks[solver] = scale
        a_ok, a_text = vortex_anchor_check(rec["w_last"], solver)
        k1 = rec["launches"]["arakawa_rhs"]
        want = 3 * VORTEX_TOTAL if solver == "fdm" else 0
        ok = (a_ok and d <= 1e-5 * scale and k1 == want
              and one["backend"] == "nccl"
              and bool(torch.isfinite(rec["w_last"]).all()))
        line = (f"phase 19 (f) sharded vortex {solver} {VORTEX_NX}^2 fp32, "
                f"world 1 {one['mesh']} ({f['transport']}), "
                f"{'make_sharded_vortex_step (blocks)' if solver == 'fdm' else 'make_sharded_vortex_step_half (row slabs)'}"
                f": @{VORTEX_TOTAL} {a_text}; max|w - single-device step| "
                f"@{MESH_VORTEX_CHECK} = {d:.3e} (tol 1e-5 x {scale:.6g}); "
                f"kernel 1 {k1} launches (want {want}); {share(rec)}; "
                f"{eager_text(rec['eager'], single_times)}; "
                f"{card} {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
    full = f["ps23_full"]
    half = f["ps23"]["w_full_check"]
    scale = float(half.abs().max())
    d = float((full["w"] - half).abs().max())
    ok = d <= 1e-5 * scale and bool(torch.isfinite(full["w"]).all())
    line = (f"phase 19 (f) sharded vortex ps23 {VORTEX_NX}^2 fp32, world 1, "
            f"the full spectrum in blocks (make_sharded_vortex_step): "
            f"{MESH_PS23_FULL} steps, {full['step_ms']:.4f} ms a step; "
            f"max|w - half form| @{MESH_PS23_FULL} = {d:.3e} (tol 1e-5 x "
            f"{scale:.6g}); {card} {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)

    # (g) 2x2 ranks on the one card over gloo, host-staged
    for rank, r in enumerate(quad):
        g = r["vortex"]
        for solver in VORTEX_SOLVERS:
            rec = g[solver]
            scale = checks[solver]
            d = float((rec["w_check"] - f[solver]["w_check"]).abs().max())
            k1 = rec["launches"]["arakawa_rhs"]
            want = 3 * MESH_VORTEX_CHECK if solver == "fdm" else 0
            ok = (r["backend"] == "gloo" and "host memory" in g["transport"]
                  and d <= 1e-5 * scale and k1 == want)
            line = (f"phase 19 (g) sharded vortex {solver} {VORTEX_NX}^2 "
                    f"fp32, rank {rank} of {r['mesh']} on one card "
                    f"({g['transport']}): {MESH_VORTEX_CHECK} steps; max|w - "
                    f"world 1| @{MESH_VORTEX_CHECK} = {d:.3e} (tol 1e-5 x "
                    f"{scale:.6g}); kernel 1 {k1} launches (want {want}); "
                    f"{share(rec)}; {card} {'ok' if ok else 'FAIL'}")
            print(line)
            check(ok, line)

    # (h) the 1024^2 cavity with the pencil DST
    n = NX + 1
    for poisson in ("fst", "fst_half"):
        h1 = one["cavity_fst"][poisson]
        label = f"phase 19 (h) sharded cavity poisson={poisson}"
        anchor_check(h1["psi_last"][:n, :n], MESH_CAVITY_ONE,
                     f"{label} world 1")
        cfg = dataclasses.replace(mesh_cavity_cfg(), poisson=poisson)
        step = cavity.make_step_fn(cfg, torch.float32, device)
        st, _ = loop.run_steps(step, cavity.initial_state(cfg, torch.float32,
                                                          device),
                               MESH_CAVITY_ONE, graph=False)
        single = st[1].cpu()
        single_times = eager_step_times(step, st)
        scale = float(single.abs().max())
        d = float((h1["psi_last"][:n, :n] - single).abs().max())
        k1 = h1["launches"]["arakawa_rhs"]
        ok = (d <= 1e-5 * scale and k1 == 3 * MESH_CAVITY_ONE
              and one["backend"] == "nccl")
        line = (f"{label} {NX}^2 fp32, world 1 {one['mesh']}: "
                f"{MESH_CAVITY_ONE} steps; max|psi - single-device {poisson} "
                f"step| @{MESH_CAVITY_ONE} = {d:.3e} (tol 1e-5 x {scale:.6g});"
                f" kernel 1 {k1} launches (want {3 * MESH_CAVITY_ONE}); "
                f"{share(h1)}; {eager_text(h1['eager'], single_times)}; "
                f"{card} {'ok' if ok else 'FAIL'}")
        print(line)
        check(ok, line)
        ref = h1["psi_check"][:n, :n]
        scale = float(ref.abs().max())
        for rank, r in enumerate(quad):
            rec = r["cavity_fst"][poisson]
            psi = rec["psi_check"]
            d = float((psi[:n, :n] - ref).abs().max())
            pad = float(psi[n:].abs().max() + psi[:, n:].abs().max())
            k1 = rec["launches"]["arakawa_rhs"]
            ok = (d <= 1e-5 * scale and pad == 0.0
                  and k1 == 3 * MESH_CAVITY_QUAD)
            line = (f"{label} {NX}^2 fp32, rank {rank} of {r['mesh']} on one "
                    f"card ({r['vortex']['transport']}): {MESH_CAVITY_QUAD} "
                    f"steps; max|psi - world 1| @{MESH_CAVITY_QUAD} = "
                    f"{d:.3e} (tol 1e-5 x {scale:.6g}), padding {pad:g}; "
                    f"kernel 1 {k1} launches (want {3 * MESH_CAVITY_QUAD}); "
                    f"{share(rec)}; {card} {'ok' if ok else 'FAIL'}")
            print(line)
            check(ok, line)
    return (f["fdm"]["launches"]["arakawa_rhs"],
            [r["vortex"]["fdm"]["launches"]["arakawa_rhs"] for r in quad])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler breakdowns of the "
                             "1024^2 cavity step, the 4096^2 multigrid "
                             "solve (fused and fused=\"off\"), the hllc "
                             "8192 Euler step, the four 2048^2 vortex "
                             "steps and ps23's two inverses, the fst, the "
                             "fused and the fused_bf16x3 cavity steps")
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
    batched_records = phase_arakawa_batched()
    mg_records = phase_mg_kernels()
    euler_record = phase_euler_kernels()
    stage_record = phase_stage_kernel()
    stage_back_record = phase_stage_backward_kernel()
    tier_record, split_record = phase_tier_kernel()
    vortex_records = phase_vortex_stage_kernels()
    inverses, vortex_records[0]["planned_inverse"] = phase_vortex_inverse()
    if args.profile:
        for name, (call, ms) in inverses.items():
            phase_profile(f"vortex inverse {name} {VORTEX_NX}^2 fp32 (4 "
                          f"fields)", lambda call=call: [call() for _ in
                                                         range(10)],
                          10, ms * 1e-3, unit="call")
    del inverses
    phase_empty_graph(mg_records["redblack_sweeps"]["floor_ms"])
    launches, step, state, step_s, rms, cavity_eager_s = phase_main_path()
    cavity_ref = ((state[0], state[1]), rms)
    if args.profile:
        by_name = phase_profile(f"cavity {NX}^2 (graphed)",
                                lambda: loop.run_steps(step, state, 20), 20,
                                step_s)
        if by_name:
            profile_rhs(by_name, "arakawa_rhs_kernel", 20)
    ghia_fp32 = phase_cli()
    mg_counts, mg_solves = phase_multigrid()
    if args.profile:
        from cfd_julia_torch.ops import cuda_kernels

        for variant, check_profile in [("fused", profile_edges),
                                       ("off", profile_off)]:
            solve, best = mg_solves[variant]
            by_name = phase_profile(f"multigrid {MG_NX}^2 {variant} "
                                    f"(graphed)",
                                    lambda solve=solve: [solve()
                                                         for _ in range(3)],
                                    3, best, unit="solve")
            if by_name:
                check_profile(by_name, dict(cuda_kernels.LAUNCHES), 3)
    phase_cli_poisson()
    euler_counts, (e_step, e_state, e_step_s) = phase_euler()
    if args.profile:
        by_name = phase_profile(f"euler hllc {EULER_RUNS[0][1]} (graphed)",
                                lambda: loop.advance(e_step, e_state, 20), 20,
                                e_step_s)
        if by_name:
            profile_rhs(by_name, "euler_rhs_kernel", 20)
    phase_cli_euler()
    del e_step, e_state
    vortex_launches, v_steps, w_ps23 = phase_vortex()
    fdm_step_s = v_steps["fdm"][2]
    if args.profile:
        for solver in VORTEX_SOLVERS:
            v_step, v_state, v_step_s = v_steps[solver]
            label = f"vortex {solver} {VORTEX_NX}^2 (graphed)"
            by_name = phase_profile(
                label, lambda: loop.advance(v_step, v_state, 10), 10,
                v_step_s)
            if by_name:
                profile_transforms(by_name, label, 10)
                if solver == "fdm":
                    profile_rhs(by_name, "arakawa_rhs_kernel", 10)
                else:
                    profile_vortex_passes(by_name, solver, 10)
    del v_steps
    phase_cli_spectral()
    rates = phase_cavity_fst((1.0 / step_s, 1.0 / cavity_eager_s),
                             args.profile)
    fused_launches, fused_ref, rates = phase_fused_cavity(rates, state,
                                                          args.profile)
    tier_launches = phase_tiers(rates, state[1], fused_ref.s, ghia_fp32,
                                args.profile)
    del step, state
    phase_checkpoint(cavity_ref, w_ps23, fused_ref)
    del fused_ref
    phase_1d()
    ensemble_launches = phase_ensemble(fdm_step_s)
    grad_launches = phase_gradients()
    packed_launches = phase_packed_gradients(grad_launches["cavity_grad"])
    phase_user_surface()
    mesh_launches, mesh_launches_one, (vortex_one, vortex_quad), \
        mesh_grad_launches = phase_mesh()

    record["launches"] = launches[record["name"]]
    record["path"] = f"cavity {NX}^2, {STEPS_TOTAL} steps"
    record["at_2048"]["launches"] = vortex_launches["fdm"]["arakawa_rhs"]
    record["at_2048"]["path"] = (f"vortex fdm {VORTEX_NX}^2, {VORTEX_TOTAL} "
                                 f"steps")
    record["sharded"].update(
        launches=mesh_launches,
        path=(f"sharded cavity {NX}^2, {STEPS_FIRST} steps on each of "
              f"{MESH_RANKS} ranks (2x2, one card, gloo)"))
    record["sharded"]["world_1"].update(
        launches=mesh_launches_one,
        path=f"sharded cavity {NX}^2, {STEPS_TOTAL} steps, one rank (NCCL)")
    record["sharded_vortex"].update(
        launches=vortex_quad,
        path=(f"sharded fdm vortex {VORTEX_NX}^2, {MESH_VORTEX_CHECK} steps "
              f"on each of {MESH_RANKS} ranks (2x2, one card, gloo)"))
    record["sharded_vortex"]["world_1"].update(
        launches=vortex_one,
        path=(f"sharded fdm vortex {VORTEX_NX}^2, {VORTEX_TOTAL} steps, one "
              f"rank (NCCL)"))
    record["batched"] = batched_records["batched"]
    record["batched"]["launches"] = ensemble_launches["arakawa_rhs"]
    record["batched"]["path"] = (f"ensemble fdm {len(ENSEMBLE_RE)} x "
                                 f"{VORTEX_NX}^2, {VORTEX_TOTAL} steps")
    backward = batched_records["backward"]
    # a backward call with the Re gradient is one launch: its sum is
    # folded into the kernel's last block
    backward["launches"] = grad_launches["cavity"]["arakawa_rhs_backward"]
    backward["path"] = (f"cavity {NX}^2 fp64 gradient, {GRAD_CAVITY_STEPS} "
                        f"steps")
    backward["at_batch"]["launches"] = \
        grad_launches["ensemble"]["arakawa_rhs_backward"]
    backward["at_batch"]["path"] = (
        f"fdm ensemble {len(GRAD_ENSEMBLE_RE)} x {VORTEX_NX}^2 fp64 "
        f"gradient, {GRAD_VORTEX_STEPS} steps")
    # phase 19 (i): the backward on each rank's framed block
    for key, kind, path, path_one in [
            ("sharded", "cavity",
             f"cavity {NX}^2 fp64 gradients (fst, fst_half), "
             f"{MESH_GRAD_SHORT} steps each on each of {MESH_RANKS} ranks "
             f"(2x2, one card, gloo)",
             f"cavity {NX}^2 fp64 gradients, one rank (NCCL): fst "
             f"{MESH_GRAD_STEPS} and {MESH_GRAD_SHORT} steps, fst_half "
             f"{MESH_GRAD_SHORT}"),
            ("sharded_vortex", "fdm",
             f"fdm vortex {VORTEX_NX}^2 fp64 gradient, {MESH_GRAD_SHORT} "
             f"steps on each of {MESH_RANKS} ranks (2x2, one card, gloo)",
             f"fdm vortex {VORTEX_NX}^2 fp64 gradient, {MESH_GRAD_SHORT} "
             f"steps, one rank (NCCL)")]:
        quad_l, one_l = mesh_grad_launches[kind]
        backward[key].update(
            launches=[q["arakawa_rhs_backward"] for q in quad_l], path=path)
        backward[key]["world_1"].update(
            launches=one_l["arakawa_rhs_backward"], path=path_one)
    for name, rec in mg_records.items():
        variant = "fmg" if name == "residual_restrict" else "fused"
        rec["launches"] = mg_counts[variant][name]
        rec["path"] = f"multigrid {MG_NX}^2 {variant} solve"
    euler_record["launches"] = euler_counts[EULER_RUNS[0]]["euler_rhs"]
    euler_record["path"] = (f"euler {EULER_RUNS[0][0]} {EULER_RUNS[0][1]} "
                            f"fp32, {EULER_STEPS} steps")
    stage_record["launches"] = fused_launches["cavity_fused_stage"]
    stage_record["path"] = (f"fused cavity {NX}^2, {STEPS_TOTAL} steps")
    stage_back_record["launches"] = packed_launches["cavity_stage_backward"]
    stage_back_record["path"] = (f"packed cavity {NX}^2 fp64 gradient, "
                                 f"{GRAD_CAVITY_STEPS} steps")
    for rec in (tier_record, split_record):
        rec["launches"] = tier_launches[rec["name"]]
        rec["path"] = f"fused_bf16x3 cavity {NX}^2, {STEPS_TOTAL} steps"
    for rec in vortex_records:
        # the truncation runs on ps32's path alone
        main = "ps32" if rec["name"] == "vortex_truncate_32" else "ps23"
        rec["launches"] = vortex_launches[main][rec["name"]]
        rec["path"] = (f"vortex {main} {VORTEX_NX}^2, {VORTEX_TOTAL} steps; "
                       f"ps32 {vortex_launches['ps32'][rec['name']]}, hybrid "
                       f"{vortex_launches['hybrid'][rec['name']]} launches")
    print(json.dumps({"kernels": [record, backward, *mg_records.values(),
                                  euler_record, stage_record,
                                  stage_back_record, tier_record,
                                  split_record, *vortex_records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
