#!/usr/bin/env python3
"""Time the port's RHS kernels from several source trees against each other
on one NVIDIA GPU, in turns.

    python3 kernel_ab.py [--rounds N] [--sass] DIR [DIR ...]

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
  - euler_rhs at (3, 8192) fp32 on the Sod state after 100 steps, for
    hllc, roe, rusanov/roe and rusanov/spectral;
  - the two multigrid level edges at 4097^2 fp32, 2 sweeps, for the trees
    that have them;
  - the empty-launch floor (torch.cuda._sleep(0)) and, as a yardstick of
    the Arakawa RHS's bytes alone, torch.add of two 1025^2 fp32 fields,
    beside them.
Each call is also held against its plain twin (max|kernel - twin| is
printed), and each tree's RHS kernels' ptxas registers and spills are
printed; --sass also counts the CALL instructions (the slow paths of IEEE
division, reciprocal and square root) in their SASS (cuobjdump).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs
from cfd_julia_torch.ops import _cuda_build
from cfd_julia_torch.ops import cuda_kernels as ck


def bind(path: Path) -> ctypes.CDLL:
    """Load a kernel library and set the signatures of the symbols it has
    (a tree may hold only some of the sources)."""
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _cuda_build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


def has(lib, symbol):
    return getattr(lib, symbol, None) is not None


def ptxas_lines(path: Path):
    """(kernel, registers, spill stores) of the RHS kernels in nvcc.log."""
    text = path.with_name(_cuda_build.LOG_NAME).read_text()
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if re.search("arakawa|euler", m.group(1)) \
                else None
            spill = None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, spill))
            name = None
    return out


def sass_calls(path: Path):
    """{kernel: (CALL instructions, MUFU.RCP instructions)} of the RHS
    kernels in the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1) if re.search("arakawa|euler", m.group(1)) \
                else None
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
    nx = 8192
    q = cs.euler_sod_100(nx).float().contiguous()
    for solver, ws in cs.EULER_VARIANTS:
        out[f"euler_rhs 3x{nx} fp32 {solver}/{ws}"] = (
            lambda solver=solver, ws=ws: ck.euler_rhs_fused(
                q, 1.4, 1.0 / nx, solver, ws),
            lambda solver=solver, ws=ws: ck.euler_rhs_fused_plain(
                q, 1.4, 1.0 / nx, solver, ws),
            None, "euler_rhs_f32")
    big = (cs.MG_NX + 1, cs.MG_NX + 1)
    rng = np.random.default_rng(big[0] * 7919 + big[1])
    coarse = ((big[0] - 1) // 2 + 1, (big[1] - 1) // 2 + 1)
    u, f, uc = (torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=dev)
                for shape in (big, big, coarse))
    h = 1.0 / (big[0] - 1)
    for name, (kernel, plain) in cs.mg_calls(u, f, uc, h, h).items():
        if name in cs.MG_EDGES:
            out[f"{name} 4097^2 fp32 sweeps {cs.MG_SWEEPS}"] = (
                kernel, plain, None, f"mg_{name}_f32")
    return out


def max_err(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    return max(float((g.double() - r.double()).abs().max())
               for g, r in zip(got, ref))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dirs", nargs="+", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.phase_card()
    dirs = [d.resolve() for d in args.dirs]
    # one build per distinct library (two builds of one library would share
    # their temporary files)
    unique = list({_cuda_build.library_path(d): d for d in dirs}.values())
    with ThreadPoolExecutor(len(unique)) as pool:
        list(pool.map(_cuda_build.build, unique))
    paths = [_cuda_build.library_path(d) for d in dirs]
    libs = [(str(d.relative_to(cs.REPO)) if d.is_relative_to(cs.REPO)
             else str(d), bind(p)) for d, p in zip(dirs, paths)]
    for (label, _), path in zip(libs, paths):
        for name, regs, spill in ptxas_lines(path):
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
    for label, (call, plain, before, symbol) in cases(dev).items():
        times = {name: [] for name, lib in libs if has(lib, symbol)}
        errs = {}
        for r in range(args.rounds):
            for name, lib in (libs if r % 2 == 0 else libs[::-1]):
                if name not in times:
                    continue
                with mock.patch.object(_cuda_build, "load_library",
                                       lambda lib=lib: lib):
                    if r == 0:
                        errs[name] = max_err(call(), plain())
                    times[name].append(cs.median_ms(call, before=before)[0])
        for name, ts in times.items():
            print(f"ab {label}: {name}: device ms "
                  f"{[round(x, 5) for x in ts]} median {np.median(ts):.5f}; "
                  f"max|k-p|={errs[name]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
