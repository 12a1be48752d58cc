"""Time loops (counterpart of cfd_julia_tpu/stepping/loop.py).

JAX compiled the loop into one `lax.scan`; here it is a Python loop of
eager steps.  Per-step diagnostics stay on the device — no `.item()` or
host copy inside the loop, which would synchronise with the GPU every step.
"""
from __future__ import annotations


def run_steps(step_fn, state, nt: int):
    """Advance `state` (a tuple of tensors) by nt applications of
    step_fn(state) -> state.

    Returns (final_state, history): history[k] is the last entry of the
    state after step k+1 (the cavity's per-step rms), gathered into a
    device tensor preallocated from the initial state's last entry."""
    history = state[-1].new_empty(nt)
    for k in range(nt):
        state = step_fn(state)
        history[k] = state[-1]
    return state, history
