"""Timing and profiling helpers (counterpart of
cfd_julia_tpu/utils/profiling.py): the replacements for the reference's
`@time`/`@btime` wall-clock macros.

`steps_per_second` times a window of steps through the loop layer (on a
CUDA state: replays of its captured graphs) and ends every timed window
with a device synchronisation.  `trace` wraps torch.profiler and writes a
Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(state) -> None:
    """Wait for the device work behind `state` (nothing to wait for on the
    CPU)."""
    leaves = list(state) if isinstance(state, tuple) else [state]
    for device in {t.device for t in leaves if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def steps_per_second(step_fn, state, steps: int = 100, repeats: int = 1):
    """(best steps/s, state) of `repeats` timed windows of `steps` steps
    after one untimed window (the capture, on a CUDA state)."""
    from cfd_julia_torch.stepping import loop

    state = loop.advance(step_fn, state, steps)
    _sync(state)
    best = 0.0
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        state = loop.advance(step_fn, state, steps)
        _sync(state)
        best = max(best, steps / (time.perf_counter() - t0))
    return best, state


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (CPU and, with a GPU, CUDA
    activity); writes logdir/trace.json, viewable in chrome://tracing or
    Perfetto.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timer(label: str = "", sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label} {time.perf_counter() - t0:.4f}s")
