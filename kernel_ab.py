#!/usr/bin/env python3
"""Time the port's kernels from several source trees against each other on
one NVIDIA GPU, in turns.

    python3 kernel_ab.py [--rounds N] [--sass] [--only REGEX] DIR [DIR ...]

Each DIR holds kernel sources like cfd_julia_torch/csrc/ (*.cu, *.cuh): a
copy of an earlier commit's, say, made with
`git archive <commit> cfd_julia_torch/csrc | tar -x --strip-components=2
-C DIR`, or a variant of the current ones.  Each is built into its own
library (ops/_cuda_build.build), and the port's wrappers (ops/cuda_kernels)
run on each library in turn, so every tree is timed through the same
checks, allocations and launches as the main path.  Timed, with
chip_smoke.median_ms at the main path's shapes, in rounds that visit the
trees in order and then in reverse (a, b, b, a for two trees and two
rounds):
  - arakawa_rhs at 1025^2 fp32, with the fields warm in L2 (as in the
    cavity step) and with L2 flushed (a 128 MB write before each call);
    batched at chip_smoke's (8, 2048, 2048) with one device Re a member,
    and its backward kernel (with and without the Re gradient) at the
    shapes chip_smoke's phase 2 times it at (1025^2, 2048^2, the batch and
    the framed 517^2, 1029^2, 1026^2 and 2050^2 blocks; fp32, and the 2-D
    ones in fp64), for the trees that have them;
  - euler_rhs at (3, 8192) fp32 on the Sod state after 100 steps, for
    hllc, roe, rusanov/roe and rusanov/spectral;
  - the two multigrid level edges at 4097^2 fp32, 2 sweeps, and the
    residual sum (residual_ssq: alone, as a solve's rms0, and with r
    written, as fmg's g) at 4097^2 fp32, for the trees that have them, and
    the smoother (redblack_sweeps) on every level of the 4096^2 pyramid
    (4097^2 down to 3x3), fp32, 2 sweeps;
  - the tier GEMM (csrc/tier_gemm.cu) at 1024^3 and 1023^3 (the fused
    and matmul tiers' shapes), 1 and 3 passes, on the cavity's sine
    matrix and a random field: a product as the Poisson solve makes it
    (`tier product`: a TierPlan call, the field's split and the GEMM; on
    a tree with the earlier ABI, whose one kernel split both operands in
    its main loop, that kernel), the GEMM alone on split planes, the split
    pass alone in both roles, and tier_matmul on raw operands; the
    tier solve (`tier solve`: chained on a tree with the planes
    epilogue, tier_gemm_tn_planes, else per product; `tier solve per
    product` on every tree) and each epilogue of the chain (`tier
    epilogue A | B | C`, on a tree without it today's GEMM +
    torch op + split; `tier GEMM + op + split` on every tree);
  - the 1024^2 fused_bf16x3 cavity step, graphed, under torch.profiler on
    each tree's library (`profile tier step`): device us and kernels a
    step, the tier GEMM's and the split's share (a tree without the
    planes epilogue solves per product);
  - the vortex step's derivative pass in its buffer mode
    (csrc/vortex_stage.cu) at 2048^2 fp32, into the ps23 and ps32
    inverses' buffers (chip_smoke.planned_inputs);
  - the packed cavity's stage kernel (csrc/cavity_stage.cu) at 1024^2
    fp32 on chip_smoke.stage_inputs with Jensen walls, stages 1, 2 and 3,
    warm and L2-flushed, and stage 2 in fp64; besides max|kernel - twin|
    it prints max|this tree - the first tree| over the new interior and
    over the four wall vectors; and, for the trees that have it, the
    stage's backward kernel at stage 2 on chip_smoke.stage_backward_inputs:
    with the Re gradient in fp32 (warm and L2-flushed) and fp64 (warm),
    and without it in fp32 (warm);
  - the empty-launch floor (torch.cuda._sleep(0)) and, as a yardstick of
    the Arakawa RHS's bytes alone, torch.add of two 1025^2 fp32 fields,
    beside them;
  - the stage backward's call at 1024^2 fp32, and kernel 1's backward at
    the shapes above, under torch.profiler on each tree's library: the
    device time a call of each kernel (the backward kernel and, on a tree
    from before the Re sum was folded into its last block, the sum's
    second launch);
  - the 4096^2 fused="off" multigrid solve (chip_smoke's problem), where
    every smoother is the smoother kernel: a torch.profiler window of 3
    solves on each tree's library, in turns, with its device time a solve
    and the smoother kernels' (every kernel whose name starts with rb_,
    and convert_kernel) time and launches.
Each call is also held against its plain twin (max|kernel - twin| is
printed), and each tree's RHS, smoother, residual-sum, stage and tier
kernels' ptxas registers and spills are printed; --sass also counts the CALL instructions (the
slow paths of IEEE division, reciprocal and square root) in their SASS
(cuobjdump).  A tree that does not build is reported with nvcc's output
and left out; the first tree must build.  A tree from before the fold
(no arakawa_rhs_backward_constant) takes the backward entries' earlier
C ABI, without the completion counter's argument.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs
from cfd_julia_torch.ops import _cuda_build
from cfd_julia_torch.ops import cuda_kernels as ck


# the backward entries' completion counter (the Re fold's): its place in
# the wrappers' argument lists, which a tree from before the fold lacks
_FOLD_COUNTER_ARG = {"arakawa_rhs_backward": 7, "cavity_stage_backward": 19}


def folded(lib):
    """Whether a library's backward entries fold the Re sum (and take the
    counter argument)."""
    return has(lib, "arakawa_rhs_backward_constant")


# the fp32-C tier GEMM entry of a tree from before the planes epilogue
# (map_a, map_b, c, M, N, ldc, k-blocks, a_lo, b_lo, passes, stream), whose
# calls the planes entry's epilogue 0 (fp32 C, no op) stands in for
_TIER_GEMM_TN_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p]


def bind(path: Path) -> ctypes.CDLL:
    """Load a kernel library and set the signatures of the symbols it has
    (a tree may hold only some of the sources); a tree from before the fold
    gets its backward entries' earlier signatures, one from before the
    planes epilogue its tier_gemm_tn's."""
    lib = ctypes.CDLL(str(path))
    if has(lib, "tier_gemm_tn"):
        lib.tier_gemm_tn.restype = ctypes.c_int
        lib.tier_gemm_tn.argtypes = _TIER_GEMM_TN_ARGS
    for name, (restype, argtypes) in _cuda_build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = restype
            fn.argtypes = argtypes
            key = name.rsplit("_", 1)[0]
            if key in _FOLD_COUNTER_ARG and not folded(lib):
                k = _FOLD_COUNTER_ARG[key]
                fn.argtypes = argtypes[:k] + argtypes[k + 1:]
    return lib


def has(lib, symbol):
    return getattr(lib, symbol, None) is not None


@contextlib.contextmanager
def use(lib):
    """The port's wrappers on `lib`: its load_library; for a tree from
    before the fold no counters and a launch that drops their argument; for
    one from before the planes epilogue, fp32 C through its tier_gemm_tn
    (any other epilogue raises there)."""
    launch = ck._launch
    planes = has(lib, "tier_gemm_tn_planes")

    def legacy(name, symbol, device, *args, outputs=()):
        k = _FOLD_COUNTER_ARG.get(name)
        if k is not None and not folded(lib):
            args = args[:k] + args[k + 1:]
        if symbol == "tier_gemm_tn_planes" and not planes:
            (ma, mb, out, m, n, ld, _, kb, a_lo, b_lo, passes, kind, _, _,
             op, _) = args
            if kind != 0 or op != 0:
                raise RuntimeError("this tree has no planes epilogue")
            symbol, args = "tier_gemm_tn", (ma, mb, out, m, n, ld, kb, a_lo,
                                            b_lo, passes)
        return launch(name, symbol, device, *args, outputs=outputs)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(_cuda_build, "load_library",
                                              lambda: lib))
        if not folded(lib) or not planes:
            stack.enter_context(mock.patch.object(ck, "_launch", legacy))
        if not folded(lib):
            stack.enter_context(mock.patch.object(ck, "_fold_counters",
                                                  lambda device: None))
        yield


# the tier GEMM's C ABI before the split pass (a, b, c, M, N, K, passes,
# stream: fp32 operands split inside the kernel's main loop), for timing
# a tree that has it
_LEGACY_TIER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p]


def legacy_tier(a, b, passes):
    """C = A @ B through the earlier tier_gemm entry of the library in
    use."""
    fn = _cuda_build.load_library().tier_gemm
    fn.restype, fn.argtypes = ctypes.c_int, _LEGACY_TIER_ARGS
    (m, k), n = a.shape, b.shape[1]
    out = a.new_empty((m, n))
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, passes,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tier_gemm failed: CUDA error {err}")
    return out


def per_library(make):
    """A call that builds its object with make() once per kernel library
    (a TierPlan splits its constant with the library in use) and calls
    it."""
    built = {}

    def call():
        key = id(_cuda_build.load_library())
        if key not in built:
            built[key] = make()
        return built[key]()
    return call


def tier_cases(dev):
    """label -> [(call, plain, before, symbol), ...]: the alternatives, the
    first whose symbol a library has is timed on it."""
    out = {}
    for n in (cs.NX, cs.NX - 1):
        sine = cs.tier_sines(n)
        rng = np.random.default_rng(n)
        g = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32,
                            device=dev)
        for passes in (1, 3):
            tag = f"{n}^3 passes {passes}"

            def plain(passes=passes):
                return ck.tier_matmul_plain(sine, g, passes)

            def plan(passes=passes):
                return ck.TierPlan(sine, passes, "left", (n, n))

            out[f"tier product S@g {tag}"] = [
                (per_library(lambda plan=plan: lambda p=plan(): p(g)),
                 plain, None, "tier_encode"),
                (lambda passes=passes: legacy_tier(sine, g, passes), plain,
                 None, "tier_gemm")]

            def gemm_only(plan=plan):
                p = plan()
                p.split(g)
                return p.gemm

            out[f"tier gemm on split planes {tag}"] = [
                (per_library(gemm_only), plain, None, "tier_encode")]
            out[f"tier_matmul raw operands {tag}"] = [
                (lambda passes=passes: ck.tier_matmul(sine, g, passes),
                 plain, None, "tier_encode"),
                (lambda passes=passes: legacy_tier(sine, g, passes), plain,
                 None, "tier_gemm")]
            out.update(tier_solve_cases(n, passes, dev))
            kp = ck._round_up(n, ck.TIER_BK)
            for role, transpose, rows in (("A", False, ck.TIER_BM),
                                          ("B", True, ck.TIER_BN)):
                out[f"tier_split {role} {n}^2 passes {passes}"] = [(
                    lambda transpose=transpose, rows=rows, passes=passes:
                    ck.tier_split(g, transpose, ck._round_up(n, rows), kp,
                                  passes),
                    lambda transpose=transpose, rows=rows, passes=passes:
                    ck.tier_split_plain(g, transpose, ck._round_up(n, rows),
                                        kp, passes),
                    None, "tier_split")]
    return out


def tier_solve(n, passes, dev):
    """The tier solve of the 1024^2 cavity (built with the library in
    use): the packed step's solve_neg on 1024^2 buffers (n = 1024), or the
    interior solve of the full-grid step (n = 1023), with a field."""
    from cfd_julia_torch.models import cavity, cavity_fused
    from cfd_julia_torch.poisson import direct

    tier = "bf16x3" if passes == 3 else "bf16x1"
    if n == cs.NX:
        solve = cavity_fused.make_solve_neg(
            cavity.CavityConfig(nx=cs.NX, ny=cs.NX, poisson=f"fused_{tier}"),
            torch.float32, dev)
    else:
        solve = direct.make_fst_matmul_interior(
            cs.NX, cs.NX, 1 / cs.NX, 1 / cs.NX, torch.float32, dev,
            tier).interior
    f = torch.as_tensor(np.random.default_rng(n + passes).standard_normal(
        (n, n)), dtype=torch.float32, device=dev)
    return solve, f


def tier_solve_cases(n, passes, dev):
    """label -> alternatives: the tier solve chained (one split, four
    GEMMs writing each other's planes; a tree with tier_gemm_tn_planes)
    or per product (four splits, four GEMMs, torch's / and *: every
    tree), and each epilogue of the chain at 1024^3 (fused) beside
    today's GEMM + torch op + split of the same product."""
    tag = f"{n}^2 passes {passes}"
    ref = {}

    def plain():
        if "u" not in ref:
            solve, f = tier_solve(n, passes, dev)
            mm = ck.tier_matmul_plain
            sx, sy = solve.left.const, solve.right.const
            coeff = mm(mm(sx, f, passes), sy, passes) / solve.den
            ref["u"] = mm(mm(sx, coeff, passes), sy, passes) * solve.scale
        return ref["u"]

    def made(route):
        def make():
            solve, f = tier_solve(n, passes, dev)
            return (lambda: solve(f)) if route == "chained" else \
                (lambda: solve.products(f))
        return per_library(make)

    out = {f"tier solve {tag}": [
        (made("chained"), plain, None, "tier_gemm_tn_planes"),
        (made("per product"), plain, None, "tier_encode")],
        f"tier solve per product {tag}": [
        (made("per product"), plain, None, "tier_encode")]}
    if n != cs.NX:
        return out

    def epilogue(role, today):
        """A call of the chain's GEMM that writes role's output (today:
        the GEMM, the torch op and the split pass instead), its planes
        in place."""
        def make():
            solve, f = tier_solve(n, passes, dev)
            left, right, den = solve.left, solve.right, solve.den
            left.split(f)
            right.split(left.gemm())
            m = left.mnk[0]
            if role == "A":
                ext = ck.tier_plane_extents("A", m, m)
                return ((lambda: ck.tier_split(left.gemm(), False, *ext,
                                               passes, out=right._field))
                        if today else
                        (lambda: left.gemm_into("A", right._field)))
            if role == "B":
                ext = ck.tier_plane_extents("B", m, m)
                return ((lambda: ck.tier_split(right.gemm() / den, True,
                                               *ext, passes,
                                               out=left._field))
                        if today else
                        (lambda: right.gemm_into("B", left._field,
                                                 table=den)))
            return ((lambda: right.gemm() * solve.scale) if today else
                    (lambda: right.gemm_into(role, scale=solve.scale)))
        return per_library(make)

    def epilogue_plain(role):
        def call():
            solve, f = tier_solve(n, passes, dev)
            c = ck.tier_matmul_plain(solve.left.const, f, passes)
            if role == "A":
                return ck.tier_split_plain(
                    c, False, *ck.tier_plane_extents("A", n, n), passes
                ).float()
            c = ck.tier_matmul_plain(c, solve.right.const, passes)
            if role == "B":
                return ck.tier_split_plain(
                    c / solve.den, True, *ck.tier_plane_extents("B", n, n),
                    passes).float()
            return c * solve.scale
        return call

    def variant(role, op):
        """The chain's epilogue `role` with another op (a solve's den as
        the table), to tell the op's cost from the layout's."""
        def make():
            solve, f = tier_solve(n, passes, dev)
            left, right = solve.left, solve.right
            left.split(f)
            right.split(left.gemm())
            kw = {"none": {}, "divide": {"table": solve.den},
                  "scale": {"scale": solve.scale}}[op]
            out = right._field if role == "A" else left._field
            plan = left if role == "A" else right
            return lambda: plan.gemm_into(role, out, **kw)
        return per_library(make)

    def variant_plain(role, op):
        def call():
            solve, f = tier_solve(n, passes, dev)
            c = ck.tier_matmul_plain(solve.left.const, f, passes)
            if role == "B":
                c = ck.tier_matmul_plain(c, solve.right.const, passes)
            kw = {"none": {}, "divide": {"table": solve.den},
                  "scale": {"scale": solve.scale}}[op]
            return ck.tier_split_plain(
                ck._tier_op(c, **kw), role == "B",
                *ck.tier_plane_extents(role, n, n), passes).float()
        return call

    for role, op in (("A", "divide"), ("B", "none"), ("B", "scale")):
        out[f"tier epilogue variant {role} {op} {tag}"] = [
            (variant(role, op), variant_plain(role, op), None,
             "tier_gemm_tn_planes")]
    for role in ("A", "B", "C"):
        out[f"tier epilogue {role} {tag}"] = [
            (epilogue(role, False), epilogue_plain(role), None,
             "tier_gemm_tn_planes"),
            (epilogue(role, True), epilogue_plain(role), None,
             "tier_encode")]
        out[f"tier GEMM + op + split {role} {tag}"] = [
            (epilogue(role, True), epilogue_plain(role), None,
             "tier_encode")]
    return out


def tier_step_profiles(libs, rounds):
    """The 1024^2 fused_bf16x3 cavity step, graphed (20-step windows), on
    each library in turns under torch.profiler: device us a step, kernels
    a step, and the tier kernels' share; a tree without
    tier_gemm_tn_planes runs its solves per product (four splits, four
    GEMMs, / and *)."""
    from cfd_julia_torch.models import cavity, cavity_fused
    from cfd_julia_torch.stepping import loop

    cfg = cavity.CavityConfig(nx=cs.NX, ny=cs.NX, dt=2e-5, re=cs.RE,
                              bc_order=2, poisson="fused_bf16x3")
    for r in range(rounds):
        for name, lib in (libs if r % 2 == 0 else libs[::-1]):
            with contextlib.ExitStack() as stack:
                stack.enter_context(use(lib))
                if not has(lib, "tier_gemm_tn_planes"):
                    stack.enter_context(mock.patch.object(
                        ck.TierSolve, "__call__",
                        lambda self, f: self.products(f)))
                step = cavity_fused.make_fused_step_fn(cfg, torch.float32,
                                                       "cuda")
                state = cavity_fused.init_state(cfg, torch.float32, "cuda")
                state, _ = loop.run_steps(step, state, 100)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = loop.run_steps(step, state, 100)
                torch.cuda.synchronize()
                step_s = (time.perf_counter() - t0) / 100
                by_name = cs.phase_profile(
                    f"ab tier step fused_bf16x3 {name} (graphed, "
                    f"{1 / step_s:.2f} steps/s unprofiled)",
                    lambda: loop.run_steps(step, state, 20), 20, step_s)
            if not by_name:
                continue
            total = sum(us for us, _ in by_name.values())
            n_all = sum(c for _, c in by_name.values())
            gemm = cs.kernel_sums(by_name, "tier_gemm_kernel")
            split = cs.kernel_sums(by_name, "split_cols_kernel",
                                   "split_rows_kernel")
            print(f"ab tier step {name}: device {total / 20:.2f} us/step in "
                  f"{n_all / 20:.1f} kernels/step; tier GEMM "
                  f"{gemm[0] / 20:.2f} us in {gemm[1] / 20:.1f}, split "
                  f"{split[0] / 20:.2f} us in {split[1] / 20:.1f}, the rest "
                  f"{(total - gemm[0] - split[0]) / 20:.2f} us in "
                  f"{(n_all - gemm[1] - split[1]) / 20:.1f}")


# the kernels whose registers and SASS are reported
KERNELS = "arakawa|euler|rb_|residual_ssq|tier|split|cavity_stage"


def sass_calls(path: Path):
    """{kernel: (CALL instructions, MUFU.RCP instructions)} of the RHS,
    stage and tier kernels in the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1) if re.search(KERNELS, m.group(1)) else None
            if name:
                counts[name] = [0, 0]
        elif name:
            counts[name][0] += bool(re.search(r"\bCALL\.", line))
            counts[name][1] += bool(re.search(r"\bMUFU\.RCP", line))
    return counts


def cases(dev):
    """label -> (call(), plain(), before or None, library symbol)."""
    n = cs.NX + 1
    rng = np.random.default_rng(n * 7919 + n)
    w, s = (torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32,
                            device=dev) for _ in range(2))
    dx = 1.0 / (n - 1)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    out = {}
    for label, before in [("warm", None), ("cold", flush.zero_)]:
        out[f"arakawa_rhs 1025^2 fp32 {label}"] = (
            lambda: ck.arakawa_rhs_fused(w, s, dx, dx, cs.RE),
            lambda: ck.arakawa_rhs_fused_plain(w, s, dx, dx, cs.RE),
            before, "arakawa_rhs_f32")
    shape = cs.ARAKAWA_BATCHED[0]
    arrays, dxb, dyb = cs.arakawa_inputs(shape, 3, sum(shape))
    wb, sb = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in arrays[:2])
    reb = cs.arakawa_re(shape, torch.float32, dev)
    tag = "x".join(map(str, shape))
    out[f"arakawa_rhs batched {tag} fp32"] = (
        lambda: ck.arakawa_rhs_fused(wb, sb, dxb, dyb, reb),
        lambda: ck.arakawa_rhs_fused_plain(wb, sb, dxb, dyb, reb),
        None, "arakawa_rhs_batched_f32")
    for label, (args, _) in backward_inputs(dev).items():
        symbol = f"arakawa_rhs_backward_{ck._SUFFIX[args[0].dtype]}"
        out[f"arakawa_rhs_backward {label}"] = (
            lambda args=args: ck.arakawa_rhs_backward(*args),
            lambda args=args: ck.arakawa_rhs_backward_plain(*args),
            None, symbol)
        out[f"arakawa_rhs_backward {label} no d/dre"] = (
            lambda args=args: ck.arakawa_rhs_backward(*args,
                                                      re_grad=False)[:2],
            lambda args=args: ck.arakawa_rhs_backward_plain(*args)[:2],
            None, symbol)
    nx = 8192
    q = cs.euler_sod_100(nx).float().contiguous()
    for solver, ws in cs.EULER_VARIANTS:
        out[f"euler_rhs 3x{nx} fp32 {solver}/{ws}"] = (
            lambda solver=solver, ws=ws: ck.euler_rhs_fused(
                q, 1.4, 1.0 / nx, solver, ws),
            lambda solver=solver, ws=ws: ck.euler_rhs_fused_plain(
                q, 1.4, 1.0 / nx, solver, ws),
            None, "euler_rhs_f32")
    # the derivative pass's buffer mode at the ps23 / ps32 steps' 2048^2,
    # into the inverse's buffer; compared as real pairs, on the values the
    # plans read (a tree may leave a pitched row's tail unwritten)
    for solver in ("ps23", "ps32"):
        H, rowk, colk, kw, inv = cs.planned_inputs(
            cs.VORTEX_NX, cs.VORTEX_NX, solver, True, torch.float32)
        cut = (..., slice(None, inv.n // 2 + 1)) if kw.get("ky_fastest") \
            else (...,)
        out[f"vortex_derivs_half buffer {solver} 2048^2 fp32"] = (
            lambda H=H, rowk=rowk, colk=colk, kw=kw, inv=inv, cut=cut:
                torch.view_as_real(ck.vortex_derivs_half(
                    H, rowk, colk, **kw, out=inv.buffer)[cut]),
            lambda H=H, rowk=rowk, colk=colk, kw=kw, cut=cut:
                torch.view_as_real(ck.vortex_derivs_half_plain(
                    H, rowk, colk, **kw)[cut]),
            None, "vortex_derivs_half_buffer_f32")
    for n in [(cs.MG_NX >> k) + 1 for k in range(12)]:
        rng = np.random.default_rng(n * 7919 + n)
        coarse = ((n - 1) // 2 + 1,) * 2
        u, f, uc = (torch.as_tensor(rng.standard_normal(shape),
                                    dtype=torch.float32, device=dev)
                    for shape in ((n, n), (n, n), coarse))
        h = 1.0 / (n - 1)
        for name, (kernel, plain) in cs.mg_calls(u, f, uc, h, h).items():
            finest = n == cs.MG_NX + 1
            if (name in cs.MG_EDGES and finest
                    or name.startswith("residual_ssq") and finest
                    or name == "redblack_sweeps"):
                symbol = {"redblack_sweeps": "rb_sweeps",
                          "residual_ssq_r": "residual_ssq"}.get(name, name)
                swept = "" if name.startswith("residual_ssq") else \
                    f" sweeps {cs.MG_SWEEPS}"
                out[f"{name} {n}^2 fp32{swept}"] = (
                    kernel, plain, None, f"mg_{symbol}_f32")
    return out


def backward_inputs(dev):
    """label -> ((w, s, g, dx, dy, re), shape) of kernel 1's backward
    races: the shapes chip_smoke's phase 2 times it at (1025^2, 2048^2, the
    ensemble's batch, the framed 517^2, 1029^2, 1026^2 and 2050^2 blocks)
    in fp32, and the 2-D ones in fp64 too, with a tensor Re."""
    out = {}
    for shape, dtype in [(shape, dtype) for dtype in (torch.float32,
                                                      torch.float64)
                         for shape in cs.ARAKAWA_BACKWARD_TIMED
                         if dtype == torch.float32 or len(shape) == 2]:
        arrays, dx, dy = cs.arakawa_inputs(shape, 3, sum(shape) + 1)
        w, s, g = (torch.as_tensor(a, dtype=dtype, device=dev)
                   for a in arrays)
        label = f"{'x'.join(map(str, shape))} {str(dtype)[6:]}"
        out[label] = ((w, s, g, dx, dy, cs.arakawa_re(shape, dtype, dev)),
                      shape)
    return out


def stage_cases(dev):
    """label -> [(call, plain, before, symbol)]: the stage kernel at the
    packed cavity's 1024^2 buffer, Jensen walls."""
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    m = n = cs.NX - 1
    out = {}
    for dtype, stages, temps in ((torch.float32, (1, 2, 3), ("warm", "cold")),
                                 (torch.float64, (2,), ("warm",))):
        sfx = str(dtype)[6:]
        for stage in stages:
            w, wt, s, walls = cs.stage_inputs(cs.NX, cs.NX, dtype,
                                              cs.NX + 7 * stage + 2)
            wt = w if stage == 1 else wt
            args = (w, wt, s, walls, stage, 2e-5, 1.0 / cs.NX, 1.0 / cs.NX,
                    cs.RE, m, n, 2)
            for temp in temps:
                out[f"cavity_fused_stage {cs.NX}^2 {sfx} stage {stage} "
                    f"{temp}"] = [(
                        lambda args=args: ck.cavity_fused_stage(*args),
                        lambda args=args: ck.cavity_fused_stage_plain(*args),
                        flush.zero_ if temp == "cold" else None,
                        f"cavity_stage_{ck._SUFFIX[dtype]}")]
    for dtype, variants in ((torch.float32, (("warm", True), ("cold", True),
                                             ("warm", False))),
                            (torch.float64, (("warm", True),))):
        sfx = str(dtype)[6:]
        wt, s, walls, g, h = cs.stage_backward_inputs(cs.NX, cs.NX, dtype,
                                                      cs.NX + 16)
        args = (wt, s, walls, g, h, 2, 2e-5, 1.0 / cs.NX, 1.0 / cs.NX, cs.RE,
                m, n, 2)
        for temp, re_grad in variants:
            # without d/dre the result ends before gre (None)
            keep = 5 if re_grad else 4
            out[f"cavity_stage_backward {cs.NX}^2 {sfx} stage 2 {temp}"
                f"{'' if re_grad else ' no d/dre'}"] = [(
                    lambda args=args, re_grad=re_grad, keep=keep:
                    ck.cavity_fused_stage_backward(
                        *args, re_grad=re_grad)[:keep],
                    lambda args=args, keep=keep:
                    ck.cavity_fused_stage_backward_plain(*args)[:keep],
                    flush.zero_ if temp == "cold" else None,
                    f"cavity_stage_backward_{ck._SUFFIX[dtype]}")]
    return out


def off_profiles(libs, rounds):
    """The fused="off" 4096^2 solve on each library in turns: device us a
    solve, and the smoother kernels' us and launches a solve."""
    from cfd_julia_torch.models import poisson2d
    from cfd_julia_torch.poisson import multigrid

    cfg = poisson2d.PoissonConfig(nx=cs.MG_NX, ny=cs.MG_NX,
                                  solver="multigrid", problem="poly")
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, torch.float32, "cuda")
    u0 = poisson2d._dirichlet_init(ue)
    mgc = multigrid.MGConfig(tol=cs.MG_TOL, max_cycles=20, fused="off")

    def solve():
        return multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)

    for r in range(rounds):
        for name, lib in (libs if r % 2 == 0 else libs[::-1]):
            with use(lib):
                solve()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve()
                torch.cuda.synchronize()
                solve_s = time.perf_counter() - t0
                by_name = cs.phase_profile(
                    f"ab off {name}", lambda: [solve() for _ in range(3)],
                    3, solve_s, unit="solve")
            if not by_name:
                continue
            total = sum(us for us, _ in by_name.values())
            rb = [v for k, v in by_name.items()
                  if re.search(r"\brb_\w*kernel<|convert_kernel<", k)]
            print(f"ab off solve {name}: {res.iterations} cycles, device "
                  f"{total / 3:.2f} us/solve; smoother kernels "
                  f"{sum(us for us, _ in rb) / 3:.2f} us/solve "
                  f"({100 * sum(us for us, _ in rb) / total:.1f}%) in "
                  f"{sum(n for _, n in rb) / 3:.1f} launches/solve")


def arakawa_backward_profiles(libs):
    """Kernel 1's backward with and without d/dRe on each library under
    torch.profiler, 20 calls at each of backward_inputs' shapes: device us
    a call of each kernel (the backward and, on a tree from before the
    fold, the Re sum's second launch), beside the event-timed ms (which
    also holds the launch and its gaps)."""
    for label, (args, _) in backward_inputs("cuda").items():
        for re_grad in (True, False):
            for name, lib in libs:
                if not has(lib, "arakawa_rhs_backward_f32"):
                    continue
                with use(lib):
                    call = lambda: ck.arakawa_rhs_backward(*args,
                                                           re_grad=re_grad)
                    ms = cs.median_ms(call)[0]
                    cs.phase_profile(
                        f"ab arakawa_rhs_backward {label}"
                        f"{'' if re_grad else ' no d/dre'} {name} (events "
                        f"{ms:.5f} ms a call)",
                        lambda: [call() for _ in range(20)], 20, ms * 1e-3,
                        unit="call")


def stage_backward_profiles(libs):
    """The stage backward's call (1024^2 fp32, stage 2, d/dRe) on each
    library under torch.profiler, 20 calls: device us a call of the main
    kernel and of the Re sum's second launch, beside the event-timed
    ms (which also holds the launch gaps)."""
    m = n = cs.NX - 1
    wt, s, walls, g, h = cs.stage_backward_inputs(cs.NX, cs.NX,
                                                  torch.float32, cs.NX + 16)
    args = (wt, s, walls, g, h, 2, 2e-5, 1.0 / cs.NX, 1.0 / cs.NX, cs.RE, m,
            n, 2)
    for name, lib in libs:
        if not has(lib, "cavity_stage_backward_f32"):
            continue
        with use(lib):
            call = lambda: ck.cavity_fused_stage_backward(*args)
            ms = cs.median_ms(call)[0]
            cs.phase_profile(f"ab stage backward {name} (events {ms:.5f} "
                             f"ms a call)", lambda: [call() for _ in
                                                     range(20)], 20,
                             ms * 1e-3, unit="call")


def flat(x):
    """The tensors of a call's result, nested tuples flattened."""
    if isinstance(x, (tuple, list)):
        return [t for part in x for t in flat(part)]
    return [x]


def max_err(got, ref):
    return max(float((g.double() - r.double()).abs().max())
               for g, r in zip(flat(got), flat(ref)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--only", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.phase_card()
    dirs = [d.resolve() for d in args.dirs]
    # one build per distinct library (two builds of one library would share
    # their temporary files)
    by_path = {_cuda_build.library_path(d): d for d in dirs}

    def try_build(d):
        try:
            return _cuda_build.build(d)
        except RuntimeError as err:
            print(f"build {d}: FAILED, left out\n{err}")
            return None

    with ThreadPoolExecutor(len(by_path)) as pool:
        built = dict(zip(by_path, pool.map(try_build, by_path.values())))
    if built[_cuda_build.library_path(dirs[0])] is None:
        return 1
    dirs = [d for d in dirs if built[_cuda_build.library_path(d)]]
    paths = [_cuda_build.library_path(d) for d in dirs]
    libs = [(str(d.relative_to(cs.REPO)) if d.is_relative_to(cs.REPO)
             else str(d), bind(p)) for d, p in zip(dirs, paths)]
    for (label, _), path in zip(libs, paths):
        for name, regs, spill in cs.ptxas_lines(
                path.with_name(_cuda_build.LOG_NAME), KERNELS):
            print(f"ptxas {label}: {name}: {regs} registers, {spill} bytes "
                  f"spill stores")
        if args.sass:
            for name, (calls, rcp) in sass_calls(path).items():
                print(f"sass {label}: {name}: {calls} CALL, {rcp} MUFU.RCP")

    dev = torch.device("cuda")
    floor = [cs.median_ms(lambda: torch.cuda._sleep(0))[0]
             for _ in range(args.rounds)]
    print(f"floor: empty launch (torch.cuda._sleep(0)) device ms "
          f"{[round(x, 5) for x in floor]}")
    # the Arakawa RHS's bytes without its stencil: read two 1025^2 fp32
    # fields once, write one
    a, b, c = (torch.zeros(cs.NX + 1, cs.NX + 1, device=dev)
               for _ in range(3))
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for label, before in [("warm", None), ("cold", flush.zero_)]:
        t = cs.median_ms(lambda: torch.add(a, b, out=c), before=before)[0]
        print(f"yardstick torch.add of two 1025^2 fp32 fields {label}: "
              f"device ms {t:.5f}")
    del a, b, c, flush
    only = re.compile(args.only) if args.only else None
    all_cases = {label: [case] for label, case in cases(dev).items()}
    all_cases.update(tier_cases(dev))
    all_cases.update(stage_cases(dev))
    for label, alternatives in all_cases.items():
        if only and not only.search(label):
            continue
        chosen = {name: next(((c, p, b) for c, p, b, symbol in alternatives
                              if has(lib, symbol)), None)
                  for name, lib in libs}
        times = {name: [] for name, c in chosen.items() if c is not None}
        errs, first, vs_first = {}, None, {}
        for r in range(args.rounds):
            for name, lib in (libs if r % 2 == 0 else libs[::-1]):
                if name not in times:
                    continue
                call, plain, before = chosen[name]
                with use(lib):
                    if r == 0:
                        got = flat(call())
                        errs[name] = max_err(got, plain())
                        first = first or got
                        # the result's first tensor, and the rest (the
                        # stage's wall vectors)
                        vs_first[name] = (
                            max_err(got[:1], first[:1]),
                            max_err(got[1:], first[1:]) if len(got) > 1
                            else None)
                    times[name].append(cs.median_ms(call, before=before)[0])
        for name, ts in times.items():
            out_d, rest_d = vs_first[name]
            print(f"ab {label}: {name}: device ms "
                  f"{[round(x, 5) for x in ts]} median {np.median(ts):.5f}; "
                  f"max|k-p|={errs[name]:.3e}; max|k-first tree| "
                  f"{out_d:.3e}" + ("" if rest_d is None else
                                    f", wall vectors {rest_d:.3e}"))
    if not only or only.search("off"):
        off_profiles(libs, args.rounds)
    if not only or only.search("profile tier step"):
        tier_step_profiles(libs, args.rounds)
    if not only or only.search("profile cavity_stage_backward"):
        stage_backward_profiles(libs)
    if not only or only.search("profile arakawa_rhs_backward"):
        arakawa_backward_profiles(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
