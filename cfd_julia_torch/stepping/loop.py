"""Time loops (counterpart of cfd_julia_tpu/stepping/loop.py).

JAX compiles each loop into one device program (`lax.scan`).  Here a run
of nt steps follows a fixed chunk plan (`_chunk_plan`): the steps between
two boundaries (a snapshot, a checkpoint, the end of the run) are cut into
chunks of at most CHUNK steps, the last one shorter where the interval
does not divide.  On a CUDA state each distinct chunk length is captured
once as a CUDA graph (`torch.cuda.CUDAGraph`) and then replayed, so a
chunk of 50 cavity steps is one graph launch instead of ~5000 eager ones.
On a CPU state, with graph=False, or under utils.debug.nan_guard, the
same plan runs its chunks eagerly.  Either way nothing in the loop reads the device from the host:
per-step diagnostics and snapshots stay on the device.

The chunk length (CHUNK = 50 steps) bounds what a capture costs: it
issues the chunk's steps once on the host, eagerly (50 x 105 launches for
the cavity), and the graph holds that many nodes.  Memory does not grow
with it: the capture frees and reuses each step's temporaries inside the
graph's pool, so a chunk holds about one step's worth.  Chunking never
changes a result: every plan applies the same step in the same order.

A step must be a pure function of its state that does device work only.
A capture records its launches once, so a host synchronisation inside it
(`.item()`, `float(t)`, boolean-mask indexing) raises instead of running
slowly; nothing falls back to eager steps.

A graph replays launches and records no autograd graph, so the graphed
runner refuses a state, or a step's output, that requires grad (a
gradient through the run, or through an Re tensor the step closes over):
it raises a ValueError naming graph=False, never capturing or silently
detaching one.  The state and the tensors the step closes over
(`closed_over`) are checked at every run, the step's output once, at the
warm-up before a step's first capture for a state layout and grad mode.
So a tensor the step reaches otherwise (an object's attribute) that is
set to require grad after that capture goes unseen, and the replays
return a detached state.  The eager runner (graph=False, and every CPU
run) is differentiable: torch.autograd follows its steps as they run.

Graphs are kept per step function (weakly, as `jax.jit` keeps a program
per static step function), so a second run of the same step replays the
graphs of the first.  Each keeps one static state: a replay reads it,
advances it by the chunk and writes it back in place (one copy_ a
replay, inside the graph), and a history buffer of its own, copied out
after the replay.  `ops.cuda_kernels.LAUNCHES` counts the kernels that
ran: `Graph` takes back the counts the wrappers add during a capture
(nothing runs then) and adds them once a replay; `warm_up`'s launches
compute nothing that is kept and are not counted either.
"""
from __future__ import annotations

import functools
import types
import weakref

import torch

from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.utils import checkpoint

CHUNK = 50

# step function -> {state layout: _ChunkGraphs}
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _leaves(state):
    return list(state) if isinstance(state, tuple) else [state]


def _chunk_plan(nt: int, every: int, chunk: int) -> list[list[int]]:
    """The chunk lengths of an nt-step run with a boundary every `every`
    steps: one list per interval, the nt % every leftover steps as a last,
    shorter interval; an interval of m steps runs m // chunk chunks of
    `chunk` steps and one of m % chunk."""
    if every < 1 or chunk < 1:
        raise ValueError(f"every and chunk must be >= 1, got {every}, "
                         f"{chunk}")
    plan = []
    for start in range(0, nt, every):
        m = min(every, nt - start)
        plan.append([chunk] * (m // chunk) + ([m % chunk] if m % chunk
                                              else []))
    return plan


def refuse_grad(tensors, what: str) -> None:
    """Raise if grad mode is on and a tensor of `tensors` (a tensor or a
    tuple) requires grad: a CUDA graph cannot carry it."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in _leaves(tensors)):
        raise ValueError(
            f"{what} requires grad, and a CUDA graph records no autograd "
            "graph: run with graph=False to differentiate through the steps "
            "(or under torch.no_grad() to replay graphs)")


def closed_over(fn) -> tuple:
    """The tensors fn reaches through its closure cells and defaults, and
    through those of the functions and functools.partial objects found
    there, in tuples and lists too (what a step built by a make_step
    function closes over, such as a tensor Re)."""
    found, todo, seen = [], [fn], set()
    while todo:
        v = todo.pop()
        if id(v) in seen:
            continue
        seen.add(id(v))
        if isinstance(v, torch.Tensor):
            found.append(v)
        elif isinstance(v, (tuple, list)):
            todo.extend(v)
        elif isinstance(v, functools.partial):
            todo.extend((v.func, *v.args, *v.keywords.values()))
        elif isinstance(v, types.FunctionType):
            todo.extend(v.__defaults__ or ())
            for cell in v.__closure__ or ():
                try:
                    todo.append(cell.cell_contents)
                except ValueError:    # a cell not yet assigned
                    pass
    return tuple(found)


def warm_up(fn, stream) -> None:
    """Run fn() once on `stream`, its result dropped, before a capture on
    that stream: it builds what a first call builds (the kernel library,
    cuFFT plans, the stream's cuBLAS workspace).  Its kernel launches are
    not counted in cuda_kernels.LAUNCHES."""
    before = dict(cuda_kernels.LAUNCHES)
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    try:
        with torch.cuda.stream(stream):
            fn()
    finally:
        cuda_kernels.LAUNCHES.update(before)
    torch.cuda.current_stream(stream.device).wait_stream(stream)


class Graph:
    """fn() captured once as a CUDA graph on `stream` (in memory pool
    `pool`); `out` is what fn returned, static tensors that every replay
    rewrites.  A failed capture or replay raises; the kernel launches the
    wrappers counted during the capture are taken back and added again by
    every replay()."""

    def __init__(self, fn, stream, pool=None):
        before = dict(cuda_kernels.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = fn()
        finally:
            self.launches = {k: v - before[k]
                             for k, v in cuda_kernels.LAUNCHES.items() if v
                             != before[k]}
            cuda_kernels.LAUNCHES.update(before)

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            cuda_kernels.LAUNCHES[name] += n


class _ChunkGraphs:
    """The graphs of one step function on one state layout, one a chunk
    length; all read and write one static state.  With `history`, a chunk
    also records state[-1] after each of its steps."""

    def __init__(self, state, history: bool):
        self.state = tuple(t.clone() for t in _leaves(state))
        self.tuple = isinstance(state, tuple)
        self.history = history
        device = self.state[0].device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}          # length -> Graph, its out: history or None

    def view(self):
        return self.state if self.tuple else self.state[0]

    def replay(self, step_fn, n: int):
        """Advance the static state by n steps; the chunk's history."""
        if n not in self.graphs:
            if not self.graphs:
                warm_up(lambda: refuse_grad(step_fn(self.view()),
                                            "the step's output"),
                        self.stream)
            self.graphs[n] = Graph(lambda: self._chunk(step_fn, n),
                                   self.stream, self.pool)
        graph = self.graphs[n]
        graph.replay()
        return graph.out

    def _chunk(self, step_fn, n: int):
        s = self.view()
        hist = self.state[-1].new_empty(n) if self.history else None
        for k in range(n):
            s = step_fn(s)
            if hist is not None:
                hist[k] = s[-1]
        for dst, src in zip(self.state, _leaves(s)):
            dst.copy_(src)
        return hist


class _Eager:
    """Runs chunks with eager steps (the CPU, or graph=False)."""

    def __init__(self, step_fn, state):
        self.step_fn, self.state = step_fn, state

    def advance(self, n: int, hist=None) -> None:
        for k in range(n):
            self.state = self.step_fn(self.state)
            if hist is not None:
                hist[k] = self.state[-1]

    def current(self):
        return self.state

    def end(self):
        return self.state


class _Graphed:
    """Runs chunks as replays of the step function's cached graphs."""

    def __init__(self, step_fn, state, history: bool):
        refuse_grad(state, "the state")
        refuse_grad(closed_over(step_fn), "a tensor the step closes over")
        # grad mode is part of the key: a step that closes over an Re
        # tensor which requires grad gives an output that requires grad
        # under grad mode only, so a graph captured under torch.no_grad()
        # is never replayed with grad mode on (the warm-up of the graphs
        # for grad mode refuses that step)
        key = (isinstance(state, tuple), history, torch.is_grad_enabled(),
               tuple((t.shape, t.stride(), t.dtype, t.device)
                     for t in _leaves(state)))
        try:
            cache = _GRAPHS.setdefault(step_fn, {})
        except TypeError:         # not weakly referable: graphs for this run
            cache = {}
        if key not in cache:
            cache[key] = _ChunkGraphs(state, history)
        self.graphs, self.step_fn = cache[key], step_fn
        for dst, src in zip(self.graphs.state, _leaves(state)):
            dst.copy_(src)

    def advance(self, n: int, hist=None) -> None:
        out = self.graphs.replay(self.step_fn, n)
        if hist is not None:
            hist.copy_(out)

    def current(self):
        return self.graphs.view()

    def end(self):
        state = tuple(t.clone() for t in self.graphs.state)
        return state if self.graphs.tuple else state[0]


def _runner(step_fn, state, graph: bool, history: bool = False):
    # under utils.debug.nan_guard every step runs eagerly: its checks sync
    if graph and _leaves(state)[0].device.type == "cuda" \
            and not cuda_kernels.CHECK_NAN:
        return _Graphed(step_fn, state, history)
    return _Eager(step_fn, state)


def advance(step_fn, state, nt: int, graph: bool = True):
    """The state (a tensor or a tuple of tensors) after nt applications of
    step_fn(state) -> state: the JAX package's run_steps."""
    run = _runner(step_fn, state, graph)
    for lengths in _chunk_plan(nt, max(nt, 1), CHUNK):
        for n in lengths:
            run.advance(n)
    return run.end()


def run_steps(step_fn, state, nt: int, graph: bool = True):
    """Advance a tuple state by nt applications of step_fn(state) -> state.

    Returns (final_state, history): history[k] is the last entry of the
    state after step k+1 (the cavity's per-step rms), gathered into a
    device tensor preallocated from the initial state's last entry."""
    history = state[-1].new_empty(nt)
    run = _runner(step_fn, state, graph, history=True)
    done = 0
    for lengths in _chunk_plan(nt, max(nt, 1), CHUNK):
        for n in lengths:
            run.advance(n, history[done:done + n])
            done += n
    return run.end(), history


def run_steps_with_checkpoints(step_fn, state, nt: int, every: int,
                               path: str, start_step: int = 0,
                               graph: bool = True):
    """Advance nt steps, saving a resumable checkpoint of the state to
    `path` (utils.checkpoint.save_state, step = start_step + steps done)
    every `every` steps and at the end: the only host syncs of the run.
    Resume with utils.checkpoint.load_state and this function."""
    run = _runner(step_fn, state, graph)
    done = 0
    for lengths in _chunk_plan(nt, every, CHUNK):
        for n in lengths:
            run.advance(n)
        done += sum(lengths)
        checkpoint.save_state(path, run.current(), step=start_step + done)
    return run.end()


def run_steps_with_snapshots(step_fn, state, nt: int, every: int,
                             observe=None, graph: bool = True):
    """Advance nt steps of a tensor state, stacking `observe(state)` after
    steps every, 2*every, ...; `observe` defaults to the identity (the
    spectral solvers pass the decoding of their spectrum to a real field)
    and runs eagerly after the chunk that ends at its snapshot.

    Returns (final_state, snapshots): snapshots has a leading axis of
    length nt // every and lies on the state's device, preallocated
    before the loop from the shape and dtype of observe(state); the
    nt % every leftover steps run after the last snapshot."""
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    obs = observe or (lambda s: s)
    n_snaps = nt // every
    first = obs(state)
    snaps = first.new_empty((n_snaps, *first.shape))
    run = _runner(step_fn, state, graph)
    for c, lengths in enumerate(_chunk_plan(nt, every, CHUNK)):
        for n in lengths:
            run.advance(n)
        if c < n_snaps:
            snaps[c] = obs(run.current())
    return run.end(), snaps
