"""Time loops (counterpart of cfd_julia_tpu/stepping/loop.py).

JAX compiled the loop into one `lax.scan`; here it is a Python loop of
eager steps.  Per-step diagnostics and snapshots stay on the device — no
`.item()` or host copy inside the loop, which would synchronise with the
GPU every step.
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


def run_steps_with_snapshots(step_fn, state, nt: int, every: int,
                             observe=None):
    """Advance nt steps of a tensor state, stacking `observe(state)` after
    steps every, 2*every, ...; `observe` defaults to the identity (the
    spectral solvers pass the decoding of their spectrum to a real field).

    Returns (final_state, snapshots): snapshots has a leading axis of
    length nt // every and lies on the state's device, preallocated
    before the loop from the shape and dtype of observe(state); the
    nt % every leftover steps run after the last snapshot."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    obs = observe or (lambda s: s)
    n_chunks = nt // every
    first = obs(state)
    snaps = first.new_empty((n_chunks, *first.shape))
    for c in range(n_chunks):
        for _ in range(every):
            state = step_fn(state)
        snaps[c] = obs(state)
    for _ in range(nt - n_chunks * every):
        state = step_fn(state)
    return state, snaps
