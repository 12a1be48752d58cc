#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cfd_julia_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

Phases, one line each:
  0. the card (nvidia-smi name and power limit) and the fp32 matmul mode;
  1. builds the CUDA kernels from cfd_julia_torch/csrc/ with nvcc;
  2. each kernel against its plain PyTorch twin on seeded inputs, fp32
     and fp64, and its time beside the twin's at the main path's shape;
  3. the main path: the lid-driven cavity at 1024^2 (dt=2e-5, Re=100,
     Jensen wall BCs, fp32) from rest, 100 steps and then on to 2000,
     checked against the fp64 anchors of benchmarks/physics_anchors.json,
     with the kernels' launch counts over that run;
  4. the user entry point `python -m cfd_julia_torch run cavity` on the
     reference case (64^2, Re=100, t=10) against Ghia et al. (1982).
Then a JSON line with each kernel's record, and last
{"ok": true, "device": {...}}.  Any failure raises and the script exits
nonzero without that last line; without a GPU it fails at once.
"""
from __future__ import annotations

import argparse
import json
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


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, reps=30, warmup=5):
    """(device_ms, call_ms): medians of CUDA-event times of one call over
    `reps` calls after warm-up.  device_ms queues the call behind a
    busy-wait kernel, so its launches are all issued before the device
    reaches them and the events time the device alone; call_ms issues it
    to an idle device, so the host's launch overhead shows as well."""
    for _ in range(warmup):
        fn()
    times = {}
    for mode in ("device", "call"):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in events:
            torch.cuda.synchronize()
            if mode == "device":
                torch.cuda._sleep(5_000_000)   # ~3 ms of clock cycles
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times[mode] = float(np.median([s.elapsed_time(e) for s, e in events]))
    return times["device"], times["call"]


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
          f"(nvcc {' '.join(_cuda_build.NVCC_FLAGS)})")


def phase_kernels():
    """Kernel vs plain twin; returns the main-path record (1025^2 fp32)."""
    from cfd_julia_torch.ops import cuda_kernels

    dev = torch.device("cuda")
    record = None
    for shape in [(NX + 1, NX + 1), (37, 53), (8, 8)]:
        rng = np.random.default_rng(shape[0] * 7919 + shape[1])
        w_np, s_np = rng.standard_normal(shape), rng.standard_normal(shape)
        dx, dy = 1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1)
        # fp32 tolerance: FMA contraction and operation order
        for dtype, rel in [(torch.float32, 1e-5), (torch.float64, 1e-12)]:
            w = torch.as_tensor(w_np, dtype=dtype, device=dev)
            s = torch.as_tensor(s_np, dtype=dtype, device=dev)
            got = cuda_kernels.arakawa_rhs_fused(w, s, dx, dy, RE)
            ref = cuda_kernels.arakawa_rhs_fused_plain(w, s, dx, dy, RE)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            ok = err <= rel * scale
            line = (f"phase 2 kernel arakawa_rhs {shape[0]}x{shape[1]} "
                    f"{str(dtype)[6:]}: max|k-p|={err:.3e} "
                    f"max|p|={scale:.3e} tol={rel:g}*max|p| "
                    f"{'ok' if ok else 'FAIL'}")
            if shape[0] == NX + 1 and dtype == torch.float32:
                ms, call_ms = median_ms(lambda: cuda_kernels.arakawa_rhs_fused(
                    w, s, dx, dy, RE))
                plain_ms, plain_call_ms = median_ms(
                    lambda: cuda_kernels.arakawa_rhs_fused_plain(
                        w, s, dx, dy, RE))
                gbs = 3 * w.numel() * w.element_size() / (ms * 1e-3) / 1e9
                line += (f"; device time: kernel {ms:.4f} ms ({gbs:.0f} GB/s "
                         f"of 3 fields) plain {plain_ms:.4f} ms; eager call: "
                         f"kernel {call_ms:.4f} ms plain {plain_call_ms:.4f} "
                         f"ms (medians of 30 calls, CUDA events)")
                record = {"name": "arakawa_rhs", "route": "cuda",
                          "source": "cfd_julia_torch/csrc/arakawa_rhs.cu",
                          "replaces": "cfd_julia_tpu/ops/pallas_kernels.py:678",
                          "launches": None, "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms}
            print(line)
            check(ok, line)
    return record


def anchor_check(psi, total_steps):
    anchor = json.loads(ANCHORS.read_text())[f"cavity:{NX}:{total_steps}"]
    psi = psi.double()
    got = {"psi_min": float(psi.min()),
           "psi_l2": float(torch.sqrt(torch.mean(psi ** 2)))}
    tol = anchor["rel_tol"]
    rels = {k: abs(got[k] - anchor[k]) / abs(anchor[k]) for k in got}
    line = (f"phase 3 cavity {NX}^2 @{total_steps} steps: " + " ".join(
        f"{k}={got[k]:.9g} (anchor {anchor[k]:.9g}, rel {rels[k]:.2e})"
        for k in got) + f" tol {tol:g}")
    print(line)
    check(all(r <= tol for r in rels.values()), line)


def phase_main_path():
    """The headline cavity on the port's default path: rhs_impl="auto"
    resolves to the CUDA kernel on a GPU.  Returns the launch counts."""
    from cfd_julia_torch.models import cavity
    from cfd_julia_torch.ops import cuda_kernels
    from cfd_julia_torch.stepping import loop

    cfg = cavity.CavityConfig(nx=NX, ny=NX, dt=2e-5, re=RE, bc_order=2)
    step = cavity.make_step_fn(cfg, torch.float32, "cuda")
    state = cavity.initial_state(cfg, torch.float32, "cuda")

    cuda_kernels.reset_launch_counts()
    state, rms_a = loop.run_steps(step, state, STEPS_FIRST)
    torch.cuda.synchronize()
    anchor_check(state[1], STEPS_FIRST)
    n = STEPS_TOTAL - STEPS_FIRST
    t0 = time.perf_counter()
    state, rms_b = loop.run_steps(step, state, n)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)

    anchor_check(state[1], STEPS_TOTAL)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state[0], state[1], rms_a, rms_b))
    check(finite, "cavity fields or rms history not finite")
    print(f"phase 3 cavity {NX}^2 fp32: {n} steps (from step {STEPS_FIRST}) "
          f"in {seconds:.4f} s = {n / seconds:.2f} steps/s; "
          f"launches {launches}; fields finite")
    check(launches["arakawa_rhs"] == 3 * STEPS_TOTAL,
          f"arakawa_rhs launched {launches['arakawa_rhs']} times, expected "
          f"3 x {STEPS_TOTAL} = {3 * STEPS_TOTAL}")
    return launches, step, state, seconds / n


def phase_profile(step, state, step_s, steps=20):
    """Device time by kernel over a short steady window (torch.profiler);
    the busy share is taken against the unprofiled step time step_s."""
    from torch.profiler import ProfilerActivity, profile

    from cfd_julia_torch.stepping import loop

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run_steps(step, state, steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
    print(f"profile {NX}^2 {steps} steps: device busy {busy / steps:.1f} "
          f"us/step = {100 * busy / steps / (step_s * 1e6):.1f}% of the "
          f"unprofiled {step_s * 1e6:.1f} us/step; profiled host wall "
          f"{wall_us / steps:.1f} us/step, busy {100 * busy / span:.1f}% of "
          f"the kernels' span; {len(kernels) / steps:.1f} kernels/step")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"profile   {100 * us / total:5.1f}%  {us / steps:8.2f} us/step "
              f" {count / steps:5.1f}/step  {name[:110]}")


def phase_cli():
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "cfd_julia_torch", "run",
                        "cavity", "--device", "cuda", "--outdir", tmp],
                       cwd=REPO, check=True, capture_output=True, text=True,
                       timeout=900)
        seconds = time.perf_counter() - t0
        out = Path(tmp)
        for name in ("res_plot.txt", "field_final.txt", "centerlines.txt",
                     "metrics.json"):
            check((out / name).is_file(), f"CLI run wrote no {name}")
        metrics = json.loads((out / "metrics.json").read_text())
        cols = np.loadtxt(out / "centerlines.txt", skiprows=1)
    y, u, x, v = cols.T
    du = float(np.abs(np.interp(GHIA_Y, y, u) - GHIA_U).max())
    dv = float(np.abs(np.interp(GHIA_X, x, v) - GHIA_V).max())
    dpsi = abs(metrics["psi_min"] - (-0.103423))
    ok = (metrics["steady_rms"] < 1e-6 and du < 0.01 and dv < 0.01
          and dpsi < 2e-3 and metrics["device"] == torch.cuda.get_device_name())
    line = (f"phase 4 cli `python -m cfd_julia_torch run cavity --device cuda`"
            f" (64^2, Re=100, t=10) on {metrics['device']}: steady_rms="
            f"{metrics['steady_rms']:.3e} max|u-ghia|={du:.4f} "
            f"max|v-ghia|={dv:.4f} psi_min={metrics['psi_min']:.6f} "
            f"(ghia -0.103423); solve {metrics['wall_time_s']:.2f} s, "
            f"process {seconds:.2f} s {'ok' if ok else 'FAIL'}")
    print(line)
    check(ok, line)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of the "
                             "1024^2 cavity step")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not ANCHORS.is_file():
        print(f"chip_smoke: {ANCHORS} is missing; run from a checkout of "
              "the repository", file=sys.stderr)
        return 1

    phase_card()
    phase_build()
    record = phase_kernels()
    launches, step, state, step_s = phase_main_path()
    if args.profile:
        phase_profile(step, state, step_s)
    phase_cli()

    record["launches"] = launches[record["name"]]
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
