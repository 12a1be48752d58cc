#!/usr/bin/env python3
"""Time the port's one-rank mesh steps from several source trees against
each other, in turns, without grad.

    python3 mesh_step_ab.py [--rounds N] [--steps N] DIR [DIR ...]

Each DIR holds a whole checkout of the repo (`git archive <commit> | tar
-x -C DIR`, into a git-ignored directory) or is the repo itself.  A turn
runs one process that imports cfd_julia_torch from DIR, joins a one-rank
process group (NCCL on the card, gloo on the CPU) and times, eager and
with autograd on but nothing tracked (as chip_smoke.py's phase 19 runs
them): the 1024^2 cavity of chip_smoke.py's phase 19 (h) through
cavity.make_step_fn(mesh=) with poisson "fst" and "fst_half", the same
cavity's single-device fst step beside them (no mesh code: the control),
the 2048^2 fdm vortex through sharded.make_sharded_vortex_step, and one
call of halo.all_reduce_sum on a 0-d tensor (what a collective's call
costs the host beside its message).  Each is the median over REPS
windows of `--steps` steps (calls) of the ms a step, after WARM steps.
Rounds visit the trees in order and then in reverse (a, b, b,
a for two trees and two rounds).  Prints one line a case and turn, a table
of each tree's median over its turns, the card's name and power limit,
and last one JSON object.  `--device cpu --cavity-nx 32 --vortex-nx 32`
runs it small on the CPU.
"""
import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

WARM = 3
REPS = 5


def one_tree(args):
    """The turn of tree args.child: {case: ms a step}."""
    sys.path.insert(0, os.path.abspath(args.child))
    import torch
    import torch.distributed as dist

    import cfd_julia_torch
    from cfd_julia_torch.models import cavity, vortex
    from cfd_julia_torch.parallel import halo, sharded
    from cfd_julia_torch.parallel import mesh as mesh_lib

    if not cfd_julia_torch.__file__.startswith(os.path.abspath(args.child)):
        raise RuntimeError(f"imported {cfd_julia_torch.__file__}")
    dev = args.device
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    mesh = mesh_lib.make_mesh(dev)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def ms_a_step(step, state):
        for _ in range(WARM):
            state = step(state)
        times = []
        for _ in range(REPS):
            sync()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state = step(state)
            sync()
            times.append(1e3 * (time.perf_counter() - t0) / args.steps)
        return statistics.median(times)

    out = {}
    n = args.cavity_nx
    for poisson in ("fst", "fst_half"):
        cfg = cavity.CavityConfig(nx=n, ny=n, dt=2e-5, re=100.0, bc_order=2,
                                  poisson=poisson)
        w0 = torch.zeros(mesh_lib.padded_shape((n + 1, n + 1), mesh),
                         device=dev)
        out[f"cavity {poisson} mesh"] = ms_a_step(
            cavity.make_step_fn(cfg, torch.float32, dev, mesh=mesh),
            (w0, torch.zeros_like(w0), torch.zeros((), device=dev)))
    cfg = cavity.CavityConfig(nx=n, ny=n, dt=2e-5, re=100.0, bc_order=2,
                              poisson="fst")
    out["cavity fst single-device"] = ms_a_step(
        cavity.make_step_fn(cfg, torch.float32, dev),
        cavity.initial_state(cfg, torch.float32, dev))
    n = args.vortex_nx
    cfg = vortex.VortexConfig(nx=n, ny=n, solver="fdm", dt=1e-3, re=1000.0)
    w0 = vortex.initial_vorticity(cfg, torch.float32, dev)
    out["vortex fdm mesh"] = ms_a_step(
        sharded.make_sharded_vortex_step(cfg, mesh, torch.float32, dev),
        sharded.place(w0, mesh))
    out["all_reduce_sum a call"] = ms_a_step(
        halo.all_reduce_sum, torch.zeros((), device=dev))
    dist.destroy_process_group()
    return out


def card_text(device):
    if device != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="*")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--cavity-nx", type=int, default=1024)
    p.add_argument("--vortex-nx", type=int, default=2048)
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(one_tree(args)))
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
    if not args.trees:
        p.error("name at least one tree")
    order = []
    for r in range(args.rounds):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    got = {t: [] for t in args.trees}
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
               "--steps", str(args.steps), "--device", args.device,
               "--cavity-nx", str(args.cavity_nx),
               "--vortex-nx", str(args.vortex_nx)]
        res = subprocess.run(cmd, check=True, capture_output=True, text=True,
                             timeout=600)
        turn = json.loads(res.stdout.strip().splitlines()[-1])
        got[tree].append(turn)
        for case, ms in turn.items():
            print(f"turn {tree}: {case} {ms:.4f} ms")
    table = {t: {case: statistics.median(turn[case] for turn in turns)
                 for case in turns[0]} for t, turns in got.items()}
    for tree, cases in table.items():
        print(f"{tree}: " + "; ".join(f"{c} {ms:.4f} ms"
                                       for c, ms in cases.items()))
    print(card_text(args.device))
    print(json.dumps({"steps": args.steps, "rounds": args.rounds,
                      "median_ms": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
