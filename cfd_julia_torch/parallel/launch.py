"""Start the ranks of a torch.distributed program on this machine and
collect their results (the JAX package's single controller needs no
counterpart: one JAX process drives every device).

    results = launch.run(fn, world=4, device="cuda", args=(a, b))

runs fn(device, a, b) on `world` ranks, each its own process, and returns
the list of their return values, rank 0's first; `start` returns at once
and its join() waits for them, so the caller can work meanwhile.  Every
rank finds the default process group initialised and its device set; fn
builds its mesh (parallel/mesh.make_mesh) and its fields.

- Processes start with the `spawn` method: the caller may already hold a
  CUDA context, which a forked child cannot use.  A child imports fn's
  module to unpickle it, so fn lives in a module that is safe to import.
- The ranks meet through a `FileStore` in a fresh temporary directory: no
  TCP port to race for between concurrent launches, no network.
- Backend: NCCL where each rank has a GPU of its own (world <= the GPUs);
  gloo otherwise, with several ranks on one GPU (NCCL refuses two ranks
  on the same device) or on the CPU.  parallel/halo.py then stages CUDA
  tensors through host memory.
- Each rank runs fp32 matrix products in full fp32, as the single-device
  path does (TF32 off), and with one CPU thread (a spawned child does not
  inherit the caller's torch.set_num_threads; several ranks share the
  host's cores).
- fn's arguments reach the ranks through a file in that directory, not
  the spawn pipe: a child reads the pipe only as far as it has imported
  fn's module, so large arguments in it would start the ranks one after
  another, each waiting for the last one's imports.
- A rank still running TIMEOUT_S seconds after the start is stopped; the
  same bound holds each collective inside the ranks.
- A rank that raises, or dies, stops the others, and join() raises
  RuntimeError naming the rank, with its traceback.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 900.0


def backend_for(device_type: str, world: int) -> str:
    """NCCL when every rank has a GPU of its own, else gloo."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, world, device_type, backend, tmp):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        result = fn(device, *args)
        torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))
    except BaseException:
        # the time first: a failing rank makes its peers fail in turn, and
        # the parent names the rank that failed first
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as fh:
            fh.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


class Ranks:
    """A started group of ranks (`start`); join() waits for them."""

    def __init__(self, fn, world, device_type, args):
        self.world = world
        self.tmp = tempfile.mkdtemp(prefix="cfd_julia_torch_ranks_")
        self.deadline = time.monotonic() + TIMEOUT_S
        try:
            torch.save(tuple(args), os.path.join(self.tmp, "args.pt"))
            self.ctx = mp.start_processes(
                _rank_main, nprocs=world, join=False, start_method="spawn",
                args=(fn, world, device_type,
                      backend_for(device_type, world), self.tmp))
        except BaseException:
            shutil.rmtree(self.tmp, ignore_errors=True)
            raise

    def _first_error(self, rank, text):
        """(rank, traceback) of the rank whose error was recorded first."""
        found = []
        for r in range(self.world):
            path = os.path.join(self.tmp, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as fh:
                    stamp, _, tb = fh.read().partition("\n")
                found.append((float(stamp), r, tb))
        return min(found)[1:] if found else (rank, text)

    def join(self) -> list:
        """The ranks' results in rank order; raises RuntimeError naming a
        rank that failed (the others are stopped)."""
        ctx = self.ctx
        try:
            try:
                while not ctx.join(timeout=1.0):
                    if time.monotonic() > self.deadline:
                        late = [i for i, p in enumerate(ctx.processes)
                                if p.is_alive()]
                        raise RuntimeError(f"ranks {late} still running after "
                                           f"{TIMEOUT_S} s")
            except mp.ProcessRaisedException as e:
                rank, text = self._first_error(e.error_index, str(e))
                raise RuntimeError(f"rank {rank} of {self.world} failed "
                                   f"first:\n{text}") from None
            except mp.ProcessExitedException as e:
                raise RuntimeError(f"rank {e.error_index} of {self.world} "
                                   f"died ({e}) before it returned") from None
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                        p.join(10)
            return [torch.load(os.path.join(self.tmp, f"result_{rank}.pt"),
                               map_location="cpu", weights_only=False)
                    for rank in range(self.world)]
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def start(fn, world: int, device: str = "cuda", args=()) -> Ranks:
    """Start fn(device, *args) on `world` ranks of `device`'s type ("cuda"
    or "cpu") over backend_for(device, world) and return at once;
    Ranks.join() returns their results in rank order (tensors in them come
    back on the CPU)."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda."
                           "is_available() is False; pass device='cpu'")
    return Ranks(fn, world, device_type, args)


def run(fn, world: int, device: str = "cuda", args=()) -> list:
    """start(...).join(): run fn(device, *args) on `world` ranks and
    return their results in rank order."""
    return start(fn, world, device, args).join()
