"""The port's CUDA kernels on a GPU, against their plain PyTorch twins.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips without one.  The file imports neither JAX nor cfd_julia_tpu, so it
also runs on a GPU machine without JAX, where tests/conftest.py (which
imports JAX) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: fp32 1e-5 of the twin's scale (FMA contraction and operation
order), fp64 1e-12, bf16 8e-3 of the scale (one bf16 ulp: both round an
fp32 result once).  The Euler RHS on random cells in fp32 is held to 1e-5
of the scale or 4x the fp32 twin's own error against the fp64 twin,
whichever is larger: WENO-5 of random cells reconstructs states with
rho < 0 and p < 0, where the flux amplifies roundoff.
"""
import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfd_julia_torch import interop
from cfd_julia_torch.models import (burgers1d, cavity, cavity_fused,
                                    euler1d, heat1d, poisson2d, vortex)
from cfd_julia_torch.ops import _cuda_build, cuda_kernels, fft_plans, spectral
from cfd_julia_torch.poisson import direct, multigrid
from cfd_julia_torch.parallel import launch
from cfd_julia_torch.stepping import loop, ssprk3

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks  # noqa: E402  (JAX-free rank programs)

REL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 8e-3}
# cells a block of the Euler kernel owns: nx = EULER_TILE +- 1 puts an
# interface on a block edge
EULER_TILE = int(re.search(r"constexpr int kCells = (\d+);",
                           (_cuda_build.CSRC / "euler_rhs.cu").read_text())
                 .group(1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _fields(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


def _spacing(shape):
    return 1.0 / (shape[0] - 1), 1.0 / max(shape[1] - 1, 1)


def _assert_rel(got, ref, rel):
    got = got.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1025, 1025), (37, 53), (8, 8), (3, 1),
                                   (3, 2), (65, 33), (1023, 31),
                                   (2048, 2048), (130, 256)])
def test_arakawa_kernel_matches_plain(cuda_device, shape, dtype):
    """The periodic RHS against its twin, and a second call bitwise; the
    ragged shapes end in part-filled blocks on both axes, and with 1 or 2
    columns the periodic neighbours alias; 2048^2 and 130x256 are periodic
    vortex fields, with 16-byte-aligned rows."""
    w, s = _fields(shape, seed=4)
    dx, dy = _spacing(shape)
    wt, st, _ = interop.state_from_numpy(w, s, dtype, cuda_device)
    before = cuda_kernels.LAUNCHES["arakawa_rhs"]
    got = cuda_kernels.arakawa_rhs_fused(wt, st, dx, dy, 100.0)
    again = cuda_kernels.arakawa_rhs_fused(wt, st, dx, dy, 100.0)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["arakawa_rhs"] == before + 2
    assert torch.equal(got, again), "two calls differ"
    _assert_rel(got, cuda_kernels.arakawa_rhs_fused_plain(wt, st, dx, dy,
                                                          100.0), REL[dtype])


@pytest.mark.cuda
def test_cavity_kernel_step_matches_plain_step(cuda_device):
    """5 steps with the CUDA RHS kernel vs the plain RHS on the GPU, fp64;
    the kernel runs three times per step."""
    cfg = cavity.CavityConfig(nx=32, ny=24, dt=1e-3)
    rng = np.random.default_rng(2)
    shape = (cfg.nx + 1, cfg.ny + 1)
    w0, s0 = 0.5 * rng.standard_normal(shape), 0.01 * rng.standard_normal(shape)

    def trajectory(rhs_impl):
        c = dataclasses.replace(cfg, rhs_impl=rhs_impl)
        step = cavity.make_step_fn(c, torch.float64, cuda_device)
        state = interop.state_from_numpy(w0, s0, torch.float64, cuda_device)
        (w, s, _), rms = loop.run_steps(step, state, 5)
        return w, s, rms

    ref = trajectory("torch")
    before = cuda_kernels.LAUNCHES["arakawa_rhs"]
    got = trajectory("kernel")
    assert cuda_kernels.LAUNCHES["arakawa_rhs"] == before + 15
    for g, r in zip(got, ref):
        _assert_rel(g, r, 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(64, 64), (130, 256)])
def test_fdm_kernel_step_matches_twin_step(cuda_device, nx, ny):
    """3 SSP-RK3 steps of the fdm vortex solver with the CUDA RHS kernel on
    the periodic field vs the plain RHS on the GPU, fp64; the kernel runs
    three times a step."""
    cfg = vortex.VortexConfig(nx=nx, ny=ny, solver="fdm", dt=1e-3, re=100.0)
    w0 = interop.field_from_numpy(
        np.random.default_rng(6).standard_normal((nx, ny)), torch.float64,
        cuda_device)

    def run(rhs_impl):
        step = vortex.make_step(dataclasses.replace(cfg, rhs_impl=rhs_impl),
                                torch.float64, cuda_device)
        w = w0
        for _ in range(3):
            w = step(w)
        return w

    ref = run("torch")
    before = cuda_kernels.LAUNCHES["arakawa_rhs"]
    got = run("auto")
    assert cuda_kernels.LAUNCHES["arakawa_rhs"] == before + 9
    _assert_rel(got, ref, 1e-12)


# batched Arakawa shapes: ragged (the last block part-filled on both axes,
# one column), a periodic vortex field, and the ensemble's 2048^2 batch
ARAKAWA_BATCHED = [(2, 3, 1), (3, 17, 33), (4, 130, 256), (8, 2048, 2048)]
ARAKAWA_BACKWARD = [(1025, 1025), (2048, 2048), (3, 1), (3, 2),
                    *ARAKAWA_BATCHED]


def _members_re(batch, dtype, device):
    """batch distinct Reynolds numbers, 600 .. 10000 as the ensemble's."""
    return torch.linspace(600.0, 10000.0, batch, dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", ARAKAWA_BATCHED)
def test_arakawa_batched_kernel_matches_plain(cuda_device, shape, dtype):
    """One launch for a batch with one device Re a member, against the
    batched twin; two calls bitwise equal; each member bitwise the 2-D
    call with its Re as a host float; a batch of one with a 0-d tensor Re
    bitwise the float call; the batch with one float Re (filled into a
    device tensor: the same batched entry).  The tolerance is
    REL of the larger of max|twin| and the Jacobian term's size, gg
    max|w| max|s|: with one column the Jacobian is 0 and both sides carry
    its roundoff, which at Re = 10000 outweighs the viscous term."""
    w, s = _fields(shape, seed=7)
    dx, dy = _spacing(shape[1:])
    wt, st = (interop.field_from_numpy(a, dtype, cuda_device) for a in (w, s))
    re = _members_re(shape[0], dtype, cuda_device)
    before = cuda_kernels.LAUNCHES["arakawa_rhs"]
    got = cuda_kernels.arakawa_rhs_fused(wt, st, dx, dy, re)
    again = cuda_kernels.arakawa_rhs_fused(wt, st, dx, dy, re)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["arakawa_rhs"] == before + 2
    assert torch.equal(got, again)
    jac = float(wt.abs().max() * st.abs().max()) / (4 * dx * dy)

    def check(out, ref):
        err = float((out - ref).abs().max())
        assert err <= REL[dtype] * max(float(ref.abs().max()), jac), err

    check(got, cuda_kernels.arakawa_rhs_fused_plain(wt, st, dx, dy, re))
    for k in (0, shape[0] - 1):
        one = cuda_kernels.arakawa_rhs_fused(wt[k], st[k], dx, dy,
                                             float(re[k]))
        assert torch.equal(got[k], one)
        assert torch.equal(cuda_kernels.arakawa_rhs_fused(
            wt[k], st[k], dx, dy, re[k]), one)
    # one float Re for the whole batch
    host = cuda_kernels.arakawa_rhs_fused(wt, st, dx, dy, float(re[-1]))
    check(host, cuda_kernels.arakawa_rhs_fused_plain(wt, st, dx, dy,
                                                     float(re[-1])))
    assert torch.equal(host[-1], got[-1])


def _backward_scales(w, s, g, dx, dy):
    """The size of each backward output's Jacobian term, gg max|a| max|b|
    (with one column the Jacobian is zero, and both sides roundoff)."""
    gg = 1.0 / (4 * dx * dy)
    amax = [float(t.abs().max()) for t in (w, s, g)]
    return gg * amax[1] * amax[2], gg * amax[2] * amax[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", ARAKAWA_BACKWARD)
def test_arakawa_backward_kernel_matches_plain(cuda_device, shape, dtype):
    """gw, gs within REL of each output's scale (its largest value or its
    Jacobian term's size) of arakawa_rhs_backward_plain; gre (a member's
    -sum g lap(w) / re^2) within 1e-10 relative in fp64 and, in fp32, 1e-5
    of the sum of |g lap(w)| / re^2; two calls bitwise equal (no atomics
    on a value), one counted launch a call with or without the Re
    gradient (its sum is folded into the kernel's last block)."""
    w, s, g = _fields(shape, seed=8, n=3)
    dx, dy = _spacing(shape[-2:])
    wt, st, gt = (interop.field_from_numpy(a, dtype, cuda_device)
                  for a in (w, s, g))
    re = (_members_re(shape[0], dtype, cuda_device) if len(shape) == 3
          else torch.tensor(100.0, dtype=dtype, device=cuda_device))
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.arakawa_rhs_backward(wt, st, gt, dx, dy, re)
    again = cuda_kernels.arakawa_rhs_backward(wt, st, gt, dx, dy, re)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["arakawa_rhs_backward"] == \
        before["arakawa_rhs_backward"] + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = cuda_kernels.arakawa_rhs_backward_plain(wt, st, gt, dx, dy, re)
    for mine, want, jac in zip(got[:2], ref[:2],
                               _backward_scales(wt, st, gt, dx, dy)):
        err = float((mine - want).abs().max())
        assert err <= REL[dtype] * max(float(want.abs().max()), jac), err
    assert got[2].shape == shape[:-2]
    lap = cuda_kernels.arakawa.laplacian(wt.double(), dx, dy)
    mass = (gt.double() * lap).abs().sum((-2, -1)) / re.double() ** 2
    err = (got[2].double() - ref[2].double()).abs()
    if dtype == torch.float64:
        assert bool((err <= 1e-10 * ref[2].abs()).all()), (err, ref[2])
    else:
        assert bool((err <= 1e-5 * mass).all()), (err, mass)
    gw_only = cuda_kernels.arakawa_rhs_backward(wt, st, gt, dx, dy, re,
                                                re_grad=False)
    assert gw_only[2] is None and torch.equal(gw_only[0], got[0])
    assert cuda_kernels.LAUNCHES["arakawa_rhs_backward"] == \
        before["arakawa_rhs_backward"] + 3
    assert not any(k.endswith("_re_grad") for k in cuda_kernels.LAUNCHES)


# the backward's walk constants as its sources state them (the CPU
# emulation, tests/test_torch_rhs_tiling.py, reads the same)
ARAKAWA_BACKWARD_CONSTANTS = [
    int(re.search(rf"constexpr int {key} = (\d+);",
                  (_cuda_build.CSRC / source).read_text()).group(1))
    for source, key in (("arakawa_rhs.cu", "kMinRows"),
                        ("arakawa_rhs.cu", "kMaxRows"),
                        ("arakawa_rhs.cu", "kBackWalkers"),
                        ("arakawa_rhs.cu", "kVecBytes"),
                        ("arakawa_rhs.cu", "kBlockX"),
                        ("arakawa_rhs.cu", "kBackAhead"),
                        ("arakawa.cuh", "kFoldCounters"),
                        ("arakawa_rhs.cu", "kMaxRows64"))]


def _back_rows(nr, nc, batch, cols, capacity, f64):
    """The rows of a backward walker's strip (csrc/arakawa_rhs.cu
    back_rows): the fewest waves of `capacity` walkers that hold the call
    at the most rows a strip, then strips as short as those waves allow."""
    min_rows, max_rows, _, _, lanes = ARAKAWA_BACKWARD_CONSTANTS[:5]
    if f64:
        max_rows = ARAKAWA_BACKWARD_CONSTANTS[7]
    units = -(-nc // (lanes * cols)) * batch
    waves = -(-units * -(-nr // max_rows) // capacity)
    strips = max(1, waves * capacity // units)
    return min(max_rows, max(min_rows, -(-nr // strips)))


@pytest.mark.cuda
def test_arakawa_backward_constants_match_the_emulation(cuda_device):
    """The backward walk the library was built with is the one the CPU
    emulation replays: its constants, its Re partials a member (the most
    blocks of its three grids, 16-byte lanes of 4 fp32 or 2 fp64 columns
    and one-column lanes, at the shortest strips), and the rows of a
    walker's strip it takes on this card at each path's capacity (the
    walkers the card holds at once), as the emulation's formula gives
    them."""
    lib = _cuda_build.load_library()
    assert [lib.arakawa_rhs_backward_constant(k) for k in range(8)] == \
        ARAKAWA_BACKWARD_CONSTANTS
    min_rows, _, walkers, vec_bytes, lanes = ARAKAWA_BACKWARD_CONSTANTS[:5]
    shapes = [(1, 1025, 1025), (1, 2048, 2048), (8, 2048, 2048),
              (1, 517, 517), (2, 3, 1), (3, 37, 136), (1, 1024, 32)]
    for batch, nr, nc in shapes:
        blocks = [-(-nc // (lanes * cols)) * -(-(-(-nr // min_rows))
                                              // walkers)
                  for cols in (vec_bytes // 4, vec_bytes // 8, 1)]
        assert lib.arakawa_rhs_backward_partials(nr, nc) == max(blocks)
        for f64 in (0, 1):
            for vec in (0, 1):
                cap = lib.arakawa_rhs_backward_capacity(f64, vec)
                cols = vec_bytes // (8 if f64 else 4) if vec else 1
                assert cap > 0 and cap % walkers == 0
                assert lib.arakawa_rhs_backward_rows(batch, nr, nc, f64,
                                                     vec) == \
                    _back_rows(nr, nc, batch, cols, cap, f64)


def _offset(t):
    """A copy of t whose storage starts one element past a 16-byte
    boundary: the backward then takes its one-column lanes."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_arakawa_backward_lane_widths_match_plain(cuda_device, dtype):
    """At ragged batches (37 rows; 136 columns: a part-filled last warp
    segment of either lane width, rows a multiple of 16 bytes in both
    dtypes; 138: in fp32 not) the 16-byte lanes (aligned arrays) and the
    one-column lanes (the same inputs one element off a 16-byte boundary,
    and the 138-column rows) against the plain version, as
    test_arakawa_backward_kernel_matches_plain holds it; each path's two
    calls bitwise equal."""
    for shape in [(2, 37, 136), (3, 37, 138)]:
        w, s, g = _fields(shape, seed=18, n=3)
        dx, dy = _spacing(shape[-2:])
        fields = [interop.field_from_numpy(a, dtype, cuda_device)
                  for a in (w, s, g)]
        re = _members_re(shape[0], dtype, cuda_device)
        ref = cuda_kernels.arakawa_rhs_backward_plain(*fields, dx, dy, re)
        lap = cuda_kernels.arakawa.laplacian(fields[0].double(), dx, dy)
        mass = (fields[2].double() * lap).abs().sum((-2, -1)) / \
            re.double() ** 2
        for args in (fields, [_offset(x) for x in fields]):
            got = cuda_kernels.arakawa_rhs_backward(*args, dx, dy, re)
            again = cuda_kernels.arakawa_rhs_backward(*args, dx, dy, re)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            for mine, want, jac in zip(got[:2], ref[:2],
                                       _backward_scales(*fields, dx, dy)):
                err = float((mine - want).abs().max())
                assert err <= REL[dtype] * max(float(want.abs().max()), jac)
            err = (got[2].double() - ref[2].double()).abs()
            if dtype == torch.float64:
                assert bool((err <= 1e-10 * ref[2].abs()).all()), err
            else:
                assert bool((err <= 1e-5 * mass).all()), (err, mass)


@pytest.mark.cuda
def test_arakawa_backward_batch_shares_fold_counters(cuda_device):
    """A batch of more members than the Re fold has counters (members b
    and b + kFoldCounters share one) against the plain version in fp64,
    two calls bitwise equal: every counter returned to 0 after the first."""
    counters = ARAKAWA_BACKWARD_CONSTANTS[6]
    shape = (counters + 3, 9, 40)
    w, s, g = (interop.field_from_numpy(a, torch.float64, cuda_device)
               for a in _fields(shape, seed=19, n=3))
    dx, dy = _spacing(shape[-2:])
    re = _members_re(shape[0], torch.float64, cuda_device)
    got = cuda_kernels.arakawa_rhs_backward(w, s, g, dx, dy, re)
    again = cuda_kernels.arakawa_rhs_backward(w, s, g, dx, dy, re)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = cuda_kernels.arakawa_rhs_backward_plain(w, s, g, dx, dy, re)
    for mine, want, jac in zip(got[:2], ref[:2],
                               _backward_scales(w, s, g, dx, dy)):
        err = float((mine - want).abs().max())
        assert err <= 1e-12 * max(float(want.abs().max()), jac)
    err = (got[2] - ref[2]).abs()
    assert bool((err <= 1e-10 * ref[2].abs()).all()), err


def _captured_backward(call):
    """call() eagerly on the current stream; then once on a side stream
    (its warm-up: the stream's fold counter is made there, outside the
    capture) and captured there in a CUDA graph; the graph replayed 3
    times.  Returns (the eager result, [each replay's result, cloned])."""
    want = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    replays = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([x.clone() for x in _flat_result(out)])
    return _flat_result(want), replays


def _flat_result(r):
    return [x for part in r for x in
            (part if isinstance(part, tuple) else (part,)) if x is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_graph_replays_are_the_eager_call(cuda_device, dtype):
    """One call with d/dRe of each backward kernel captured in a CUDA graph
    and replayed 3 times: every replay's gradients, gre included, bitwise
    the eager call's.  The last block's sum runs only on the ticket that
    ends a grid, so a counter that did not return to 0 after the side
    stream's warm-up call, or after a replay, would leave gre unwritten."""
    w, s, g = (interop.field_from_numpy(a, dtype, cuda_device)
               for a in _fields((3, 130, 256), seed=21, n=3))
    re = _members_re(3, dtype, cuda_device)
    want, replays = _captured_backward(
        lambda: cuda_kernels.arakawa_rhs_backward(w, s, g, 0.02, 0.01, re))
    for got in replays:
        _assert_same(got, want)
    nx, ny = 34, 130
    wt, st, walls, gt, h = _stage_backward_inputs(nx, ny, dtype, cuda_device,
                                                  seed=22)
    want, replays = _captured_backward(
        lambda: cuda_kernels.cavity_fused_stage_backward(
            wt, st, walls, gt, h, 2, 1e-3, 1 / nx, 1 / ny, 100.0, nx - 1,
            ny - 1, 2))
    for got in replays:
        _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("re_kind", ["members", "0-d", "float"])
def test_arakawa_autograd_function_gradcheck(cuda_device, re_kind):
    """torch.autograd.gradcheck of the kernel pair (forward kernel, backward
    kernel) in fp64 at (2, 9, 6) against finite differences of the forward
    kernel, in w, s and a tensor re; each backward call is one counted
    backward launch, and no twin runs."""
    w, s = _fields((2, 9, 6), seed=9)
    wt, st = (torch.tensor(a, dtype=torch.float64, device=cuda_device,
                           requires_grad=True) for a in (w, s))
    re = {"members": torch.tensor([80.0, 120.0], dtype=torch.float64,
                                  device=cuda_device, requires_grad=True),
          "0-d": torch.tensor(90.0, dtype=torch.float64, device=cuda_device,
                              requires_grad=True),
          "float": 90.0}[re_kind]
    inputs = (wt, st) + ((re,) if torch.is_tensor(re) else ())

    def fn(*args):
        r = args[2] if len(args) == 3 else re
        return cuda_kernels.arakawa_rhs_fused(args[0], args[1], 0.4, 0.3, r)

    before = cuda_kernels.LAUNCHES["arakawa_rhs_backward"]
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-8)
    assert cuda_kernels.LAUNCHES["arakawa_rhs_backward"] > before


@pytest.mark.cuda
def test_cavity_grad_kernel_matches_twin(cuda_device):
    """d (1e6 mean psi^2) / d Re through 10 eager fp64 cavity steps (32^2):
    the kernel RHS with its backward kernel against the twin's autograd,
    rel 1e-10, with as many backward launches as forward ones."""
    cfg = cavity.CavityConfig(nx=32, ny=32, dt=1e-3, poisson="matmul")

    def grad(rhs_impl):
        c = dataclasses.replace(cfg, rhs_impl=rhs_impl)
        re = torch.tensor(100.0, dtype=torch.float64, device=cuda_device,
                          requires_grad=True)
        step = cavity.make_step_fn(c, torch.float64, cuda_device, re=re)
        final = loop.advance(step, cavity.initial_state(c, torch.float64,
                                                        cuda_device), 10,
                             graph=False)
        (g,) = torch.autograd.grad(1e6 * torch.mean(final[1] ** 2), re)
        return float(g)

    ref = grad("torch")
    cuda_kernels.reset_launch_counts()
    got = grad("kernel")
    assert cuda_kernels.LAUNCHES["arakawa_rhs"] == 30
    assert cuda_kernels.LAUNCHES["arakawa_rhs_backward"] == 30
    assert not any(k.endswith("_re_grad") for k in cuda_kernels.LAUNCHES)
    assert abs(got - ref) <= 1e-10 * abs(ref), (got, ref)


@pytest.mark.cuda
def test_graphed_loop_refuses_grad_on_cuda(cuda_device):
    """A step that closes over an Re tensor which requires grad: the
    graphed loop raises under grad mode, naming graph=False, before any
    capture; under torch.no_grad() it captures and equals the eager run
    bitwise; back under grad mode it raises again (never a replay of the
    no-grad graph), as it does for an Re set to require grad after its
    step was captured under grad mode."""
    cfg = cavity.CavityConfig(nx=16, ny=16, dt=1e-3)
    re = torch.tensor(100.0, dtype=torch.float64, device=cuda_device,
                      requires_grad=True)
    step = cavity.make_step_fn(cfg, torch.float64, cuda_device, re=re)
    state = cavity.initial_state(cfg, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="graph=False"):
        loop.advance(step, state, 5)
    with torch.no_grad():
        graphed = loop.advance(step, state, 5)
        eager = loop.advance(step, state, 5, graph=False)
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
    with pytest.raises(ValueError, match="graph=False"):
        loop.advance(step, state, 5)
    grad_state = (state[0].clone().requires_grad_(), *state[1:])
    with pytest.raises(ValueError, match="graph=False"):
        loop.advance(cavity.make_step_fn(cfg, torch.float64, cuda_device),
                     grad_state, 5)
    # an Re that comes to require grad after its step's graphs were
    # captured under grad mode: the cached graphs are not replayed
    re2 = torch.tensor(100.0, dtype=torch.float64, device=cuda_device)
    step2 = cavity.make_step_fn(cfg, torch.float64, cuda_device, re=re2)
    loop.advance(step2, state, 5)
    re2.requires_grad_()
    with pytest.raises(ValueError, match="graph=False"):
        loop.advance(step2, state, 5)


@pytest.mark.cuda
def test_ensemble_graphed_equals_eager_and_members(cuda_device):
    """The fdm sweep at 64^2 with 3 members, graphed and eager: bitwise
    equal, 3 batched launches a step; each member within 1e-12 of its
    single fp64 run."""
    from cfd_julia_torch.models import ensemble

    cfg = vortex.VortexConfig(nx=64, ny=64, solver="fdm", dt=1e-3,
                              t_final=0.06)
    res = [600.0, 1000.0, 5000.0]
    cuda_kernels.reset_launch_counts()
    graphed = ensemble.vortex_fdm_re_sweep(cfg, res, torch.float64,
                                           cuda_device)
    n_graph = cuda_kernels.LAUNCHES["arakawa_rhs"]
    eager = ensemble.vortex_fdm_re_sweep(cfg, res, torch.float64,
                                         cuda_device, graph=False)
    assert n_graph == 3 * cfg.nt
    assert cuda_kernels.LAUNCHES["arakawa_rhs"] == 6 * cfg.nt
    assert torch.equal(graphed.w, eager.w)
    for k, r in enumerate(res):
        single = loop.advance(
            vortex.make_step(dataclasses.replace(cfg, re=r), torch.float64,
                             cuda_device),
            vortex.initial_vorticity(cfg, torch.float64, cuda_device),
            cfg.nt)
        _assert_rel(graphed.w[k], single, 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["ps23", "ps32", "hybrid"])
def test_spectral_step_on_gpu_matches_cpu(cuda_device, solver):
    """One half-spectrum step through cuFFT against the same step on the
    CPU, fp64, from a generic field: 1e-11 absolute, the library's
    operation order only."""
    cfg = vortex.VortexConfig(nx=48, ny=40, solver=solver, dt=0.01)
    w0 = np.random.default_rng(7).standard_normal((48, 40))
    out = {}
    for device in ("cpu", cuda_device):
        H = vortex.half_init(interop.field_from_numpy(w0, torch.float64,
                                                      device))
        out[str(device)] = vortex.make_spectral_step_half(
            cfg, torch.float64, device)(H).cpu()
    got, ref = out[str(cuda_device)], out["cpu"]
    assert got.dtype == torch.complex128 and got.shape == (48, 21)
    assert float((got - ref).abs().max()) <= 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("rhs_impl", ["auto", "torch"])
@pytest.mark.parametrize("poisson", ["fst", "fst_half"])
def test_cavity_fst_step_matches_matmul_step(cuda_device, poisson, rhs_impl):
    """5 fp64 cavity steps on the GPU with the rfft DST-I Poisson solves
    against the sine-matmul solve: one solve by three transforms, with the
    kernel RHS and with the plain one."""
    base = cavity.CavityConfig(nx=33, ny=47, dt=5e-4, poisson="matmul",
                               rhs_impl=rhs_impl)
    rng = np.random.default_rng(8)
    shape = (base.nx + 1, base.ny + 1)
    w0 = 0.5 * rng.standard_normal(shape)
    s0 = 0.01 * rng.standard_normal(shape)

    def run(cfg):
        step = cavity.make_step_fn(cfg, torch.float64, cuda_device)
        state = interop.state_from_numpy(w0, s0, torch.float64, cuda_device)
        (w, s, _), _ = loop.run_steps(step, state, 5)
        return s

    _assert_rel(run(dataclasses.replace(base, poisson=poisson)), run(base),
                1e-11)


@pytest.mark.cuda
def test_cavity_fst_half_with_plain_rhs_holds_the_anchor(cuda_device):
    """The half-length DST-I solve with the plain PyTorch RHS at 1024^2 in
    fp32, 100 steps from rest, against the fp64 anchor: the combination
    the JAX package refuses on a TPU for a compiler fault there is sound
    here, so the fault is not the algorithm's."""
    anchor = json.loads((_cuda_build.CSRC.parents[1] / "benchmarks"
                         / "physics_anchors.json").read_text())[
                             "cavity:1024:100"]
    cfg = cavity.CavityConfig(nx=1024, ny=1024, dt=2e-5, re=100.0,
                              poisson="fst_half", rhs_impl="torch")
    step = cavity.make_step_fn(cfg, torch.float32, cuda_device)
    state, _ = loop.run_steps(
        step, cavity.initial_state(cfg, torch.float32, cuda_device), 100)
    psi = state[1].double()
    got = {"psi_min": float(psi.min()),
           "psi_l2": float(torch.sqrt(torch.mean(psi ** 2)))}
    for key, value in got.items():
        assert abs(value - anchor[key]) \
            <= anchor["rel_tol"] * abs(anchor[key]), key


# the level edges at 0, 1, 2 sweeps and at K+2 and 2K+1 (two and three
# passes of K = 3 sweeps, csrc/multigrid.cu kSweepsPerPass)
EDGE_SWEEPS = [0, 1, 2, 5, 7]


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", EDGE_SWEEPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(129, 65), (33, 65), (5, 5), (131, 67),
                                   (301, 261)])
def test_multigrid_kernels_match_plain(cuda_device, shape, dtype, sweeps):
    """Each multigrid kernel against its twin, the residual sum included,
    and against a second call of itself, bitwise (at 3x3 the sweeps solve
    the one interior node and the sum is roundoff, so the smallest shape
    is 5x5; 131x67 and 301x261 end in part-filled tiles on both axes)."""
    assert cuda_kernels.edge_sweeps_per_pass() == 3
    u, f = _fields(shape, seed=17)
    (uc,) = _fields(((shape[0] - 1) // 2 + 1, (shape[1] - 1) // 2 + 1),
                    seed=18, n=1)
    u, f, uc = (interop.field_from_numpy(a, dtype, cuda_device)
                for a in (u, f, uc))
    dx, dy = _spacing(shape)
    calls = [
        ("redblack_sweeps", lambda m: m(u, f, dx, dy, sweeps),
         cuda_kernels.redblack_sweeps_fused,
         cuda_kernels.redblack_sweeps_fused_plain),
        ("smooth_residual_restrict", lambda m: m(u, f, dx, dy, sweeps),
         cuda_kernels.smooth_residual_restrict_fused,
         cuda_kernels.smooth_residual_restrict_fused_plain),
        ("residual_restrict", lambda m: m(u, f, dx, dy),
         cuda_kernels.residual_restrict_fused,
         cuda_kernels.residual_restrict_fused_plain),
        ("prolong_correct_smooth",
         lambda m: m(u, f, uc, dx, dy, sweeps, want_rms=True),
         cuda_kernels.prolong_correct_smooth_fused,
         cuda_kernels.prolong_correct_smooth_fused_plain),
        ("prolong_correct_smooth",
         lambda m: m(u, f, uc, dx, dy, sweeps),
         cuda_kernels.prolong_correct_smooth_fused,
         cuda_kernels.prolong_correct_smooth_fused_plain),
    ]
    for name, call, kernel, plain in calls:
        before = cuda_kernels.LAUNCHES[name]
        got = call(kernel)
        again = call(kernel)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES[name] == before + 2, name
        ref = call(plain)
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert len(got) == len(ref), name
        for g, a, r in zip(got, again, ref):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            assert torch.equal(g, a), f"{name}: two calls differ"
            _assert_rel(g, r, REL[dtype])


# the residual sum's blocks (csrc/multigrid.cu): kResidCols columns by
# kResidRows rows, one partial each
RESID_BLOCK = tuple(
    int(re.search(rf"constexpr int {name} = (\d+);",
                  (_cuda_build.CSRC / "multigrid.cu").read_text()).group(1))
    for name in ("kResidCols", "kResidRows"))


@pytest.mark.cuda
@pytest.mark.parametrize("want_r", [False, True], ids=["ssq", "ssq_r"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(129, 65), (33, 65), (5, 5), (131, 67),
                                   (301, 261), (3, 3), (4, 6)])
def test_residual_ssq_kernel_matches_plain(cuda_device, shape, dtype,
                                           want_r):
    """The residual sum (and r) against its twin: the sum rel 1e-5 (fp32
    sums of fp32 and bf16 fields) or 1e-12 (fp64), r 1e-5 / 1e-12 of its
    scale, one bf16 ulp in bf16; two calls bitwise equal; one count a
    call."""
    u, f = (interop.field_from_numpy(a, dtype, cuda_device)
            for a in _fields(shape, seed=20))
    dx, dy = _spacing(shape)
    before = cuda_kernels.LAUNCHES["residual_ssq"]
    got = cuda_kernels.residual_ssq(u, f, dx, dy, want_r=want_r)
    again = cuda_kernels.residual_ssq(u, f, dx, dy, want_r=want_r)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["residual_ssq"] == before + 2
    ref = cuda_kernels.residual_ssq_plain(u, f, dx, dy, want_r=want_r)
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    assert got[0].dtype == cdt and got[0].dim() == 0
    assert torch.equal(got[0], again[0]), "two sums differ"
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    assert abs(float(got[0]) - float(ref[0])) <= rel * abs(float(ref[0]))
    if not want_r:
        assert got[1] is None
        return
    assert got[1].dtype == dtype and got[1].shape == u.shape
    assert torch.equal(got[1], again[1]), "two residuals differ"
    _assert_rel(got[1], ref[1], REL[dtype])


@pytest.mark.cuda
def test_residual_ssq_partials_match_the_grid(cuda_device):
    """One partial a kResidCols x kResidRows block of the level."""
    lib = _cuda_build.load_library()
    cols, rows = RESID_BLOCK
    for nr, nc in [(4097, 4097), (3, 3), (131, 67), (rows, cols),
                   (rows + 1, cols + 1)]:
        assert lib.mg_residual_ssq_partials(nr, nc) == \
            -(-nr // rows) * -(-nc // cols)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("sweeps", [2, 5])
def test_prolong_out_is_the_fresh_output(cuda_device, sweeps, dtype):
    """The ascend edge into a caller's out= (a captured cycle's static u):
    the fresh call's output and residual sum bit for bit, out itself
    returned, and a refusal of an out that is u."""
    shape = (131, 67)
    u, f = (interop.field_from_numpy(a, dtype, cuda_device)
            for a in _fields(shape, seed=21))
    (uc,) = _fields(((shape[0] - 1) // 2 + 1, (shape[1] - 1) // 2 + 1),
                    seed=22, n=1)
    uc = interop.field_from_numpy(uc, dtype, cuda_device)
    dx, dy = _spacing(shape)
    out = torch.full_like(u, float("nan"))
    got, ssq = cuda_kernels.prolong_correct_smooth_fused(
        u, f, uc, dx, dy, sweeps, want_rms=True, out=out)
    ref, ref_ssq = cuda_kernels.prolong_correct_smooth_fused(
        u, f, uc, dx, dy, sweeps, want_rms=True)
    torch.cuda.synchronize()
    assert got is out
    assert torch.equal(out, ref) and torch.equal(ssq, ref_ssq)
    with pytest.raises(ValueError):
        cuda_kernels.prolong_correct_smooth_fused(u, f, uc, dx, dy, sweeps,
                                                  out=u)


# the smoother takes a level of up to 65^2 nodes whole into one block,
# else tiles: even sides, and shapes on both sides of that limit (65x65
# and 33x128 on it, 65x66 and 33x129 past it)
SMOOTHER_SHAPES = [(3, 3), (4, 6), (33, 64), (65, 65), (33, 128), (65, 66),
                   (33, 129), (129, 129), (257, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", EDGE_SWEEPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", SMOOTHER_SHAPES)
def test_smoother_kernel_matches_plain(cuda_device, shape, dtype, sweeps):
    """The smoother against its twin and a second call of itself, bitwise,
    on both of its paths."""
    u, f = (interop.field_from_numpy(a, dtype, cuda_device)
            for a in _fields(shape, seed=19))
    dx, dy = _spacing(shape)
    before = cuda_kernels.LAUNCHES["redblack_sweeps"]
    got = cuda_kernels.redblack_sweeps_fused(u, f, dx, dy, sweeps)
    again = cuda_kernels.redblack_sweeps_fused(u, f, dx, dy, sweeps)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["redblack_sweeps"] == before + 2
    ref = cuda_kernels.redblack_sweeps_fused_plain(u, f, dx, dy, sweeps)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, again), "two calls differ"
    _assert_rel(got, ref, REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(), dict(fmg=True),
                                  dict(cycle_dtype="mixed"),
                                  dict(fused="off")],
                         ids=["fused", "fmg", "mixed", "off"])
def test_multigrid_solve_matches_twin_solve(cuda_device, opts):
    """The kernel solve vs the twin solve on the GPU, fp32, 128^2: cycle
    counts within one, errors against ue within 1.5x, and the kernels
    that the path implies actually launched."""
    results = {}
    for impl in ("torch", "kernel"):
        mgc = multigrid.MGConfig(tol=1e-5, max_cycles=20, impl=impl, **opts)
        cfg = poisson2d.PoissonConfig(nx=128, ny=128, solver="multigrid",
                                      problem="poly", mg=mgc)
        cuda_kernels.reset_launch_counts()
        results[impl] = poisson2d.solve(cfg, torch.float32, cuda_device)
        launches = dict(cuda_kernels.LAUNCHES)
        if impl == "torch":
            assert all(v == 0 for v in launches.values())
    got, ref = results["kernel"], results["torch"]
    assert float(got.rms / got.rms0) <= 1e-5
    assert abs(got.iterations - ref.iterations) <= 1
    assert float(got.linf_error) <= 1.5 * float(ref.linf_error) + 1e-6
    key = "redblack_sweeps" if opts.get("fused") == "off" \
        else "smooth_residual_restrict"
    assert launches[key] > 0
    if opts.get("fmg"):
        assert launches["residual_restrict"] == 6   # 7 levels at 128^2


def _euler_random(nx, seed, gamma=1.4):
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.1, 2.0, nx)
    u = rng.uniform(-1.5, 1.5, nx)
    p = rng.uniform(0.1, 2.0, nx)
    return np.stack([rho, rho * u, p / (gamma - 1) + 0.5 * rho * u**2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx", [8192, 257, 5, 3, 4, EULER_TILE - 1,
                                EULER_TILE, EULER_TILE + 1])
@pytest.mark.parametrize("solver,wavespeed", [
    ("roe", "roe"), ("hllc", "roe"), ("rusanov", "roe"),
    ("rusanov", "spectral")])
def test_euler_rhs_kernel_matches_plain(cuda_device, solver, wavespeed, nx,
                                        dtype):
    q64 = interop.field_from_numpy(_euler_random(nx, seed=nx),
                                   torch.float64, cuda_device)
    q = q64.to(dtype).contiguous()
    args = (1.4, 1.0 / nx, solver, wavespeed)
    before = cuda_kernels.LAUNCHES["euler_rhs"]
    got = cuda_kernels.euler_rhs_fused(q, *args)
    again = cuda_kernels.euler_rhs_fused(q, *args)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["euler_rhs"] == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again), "two calls differ"
    ref = cuda_kernels.euler_rhs_fused_plain(q, *args).double()
    err = float((got.double() - ref).abs().max())
    scale = float(ref.abs().max())
    if dtype == torch.float64:
        assert err <= REL[dtype] * scale, (err, scale)
    else:
        e32 = float((ref - cuda_kernels.euler_rhs_fused_plain(q64, *args))
                    .abs().max())
        assert err <= max(REL[dtype] * scale, 4 * e32), (err, scale, e32)


@pytest.mark.cuda
def test_euler_kernel_solve_matches_twin_solve(cuda_device):
    """hllc at nx=1024, fp32, 800 steps with snapshots: the kernel solve
    vs the twin solve on the GPU, three kernel launches a step."""
    cfg = euler1d.EulerConfig(nx=1024, solver="hllc", dt=2.5e-5,
                              t_final=0.02, ns=4)
    results = {}
    for impl in ("torch", "kernel"):
        cuda_kernels.reset_launch_counts()
        results[impl] = euler1d.solve(dataclasses.replace(cfg, rhs_impl=impl),
                                      torch.float32, cuda_device)
        torch.cuda.synchronize()
        launches = dict(cuda_kernels.LAUNCHES)
        want = 3 * cfg.nt if impl == "kernel" else 0
        assert launches["euler_rhs"] == want
        assert sum(launches.values()) == want
    got, ref = results["kernel"], results["torch"]
    assert got.q.dtype == torch.float32
    assert bool(torch.isfinite(got.snapshots).all())
    # fp32 drifts from fp64 by < 3.3e-5 over 2000 such steps (CPU runs)
    assert float((got.q - ref.q).abs().max()) <= 2e-4
    assert float((got.snapshots - ref.snapshots).abs().max()) <= 2e-4


# ----------------------------------------------- CUDA graphs of the loops

def _graph_vs_eager(run):
    """run(graph) twice, eager first; (eager, graphed, launches of each)."""
    out = {}
    for graph in (False, True):
        cuda_kernels.reset_launch_counts()
        out[graph] = (run(graph), dict(cuda_kernels.LAUNCHES))
        torch.cuda.synchronize()
    return out[False], out[True]


def _assert_same(a, b):
    """Bitwise equal tensors; NaN equals NaN (a solve's history pads its
    unused rows with NaN)."""
    a = list(a) if isinstance(a, (tuple, list)) else [a]
    b = list(b) if isinstance(b, (tuple, list)) else [b]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(64, 64), (130, 256)])
@pytest.mark.parametrize("poisson", ["matmul", "fst", "fst_half"])
def test_graphed_cavity_equals_eager(cuda_device, poisson, nx, ny):
    """60 fp32 steps (a 50-step chunk and a 10-step remainder), twice on
    one step function (the second run replays the cached graphs): the
    graphed state and rms history are the eager ones bit for bit, with
    the same kernel launches (3 a step); dt keeps 130x256 stable."""
    cfg = cavity.CavityConfig(nx=nx, ny=ny, dt=2e-4, poisson=poisson)
    step = cavity.make_step_fn(cfg, torch.float32, cuda_device)
    state = cavity.initial_state(cfg, torch.float32, cuda_device)

    def run(graph):
        s, h1 = loop.run_steps(step, state, 60, graph=graph)
        s, h2 = loop.run_steps(step, s, 60, graph=graph)
        return (*s, h1, h2)

    (eager, n_eager), (graphed, n_graph) = _graph_vs_eager(run)
    assert all(bool(torch.isfinite(t).all()) for t in eager)
    _assert_same(graphed, eager)
    assert n_graph == n_eager and n_graph["arakawa_rhs"] == 3 * 120


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [8192, 5])
@pytest.mark.parametrize("solver", ["hllc", "roe", "rusanov"])
def test_graphed_euler_equals_eager(cuda_device, solver, nx):
    """130 fp32 SSP-RK3 steps, snapshots every 60 (chunks 50, 10 and a
    10-step leftover): graphed state and snapshots bitwise the eager ones,
    the same 3 kernel launches a step."""
    cfg = euler1d.EulerConfig(nx=nx, solver=solver, dt=1e-4 * 256 / max(
        nx, 256))
    rhs = euler1d.make_rhs(cfg, cuda_device)
    _, q0 = euler1d.sod_initial_state(cfg, torch.float32, cuda_device)

    def step(q):
        return ssprk3.ssprk3_step(rhs, q, cfg.dt)

    (eager, n_eager), (graphed, n_graph) = _graph_vs_eager(
        lambda graph: loop.run_steps_with_snapshots(step, q0, 130, 60,
                                                    graph=graph))
    _assert_same(graphed, eager)
    assert n_graph == n_eager and n_graph["euler_rhs"] == 3 * 130


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["fdm", "ps23", "ps32", "hybrid"])
def test_graphed_vortex_equals_eager(cuda_device, solver):
    """The 64^2 fp32 vortex merger, 70 steps with a decoded snapshot every
    35: graphed state and snapshots bitwise the eager ones; fdm with the
    same 3 Arakawa launches a step."""
    cfg = vortex.VortexConfig(nx=64, ny=64, solver=solver, dt=1e-3)
    step = vortex.make_step(cfg, torch.float32, cuda_device)
    w0 = vortex.initial_vorticity(cfg, torch.float32, cuda_device)
    state0, observe = w0, None
    if solver != "fdm":
        state0 = vortex.half_init(w0)
        observe = lambda H: vortex.half_decode(H, cfg.nx, cfg.ny)  # noqa

    (eager, n_eager), (graphed, n_graph) = _graph_vs_eager(
        lambda graph: loop.run_steps_with_snapshots(
            step, state0, 70, 35, observe=observe, graph=graph))
    _assert_same(graphed, eager)
    assert n_graph == n_eager
    assert n_graph["arakawa_rhs"] == (3 * 70 if solver == "fdm" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(), dict(fmg=True),
                                  dict(cycle_dtype="mixed"),
                                  dict(fused="off"),
                                  dict(smoother="cheb", transfers="conv")],
                         ids=["fused", "fmg", "mixed", "off", "cheb"])
def test_graphed_multigrid_equals_eager(cuda_device, opts):
    """The 256^2 poly solve, fp32: the captured V-cycle gives the eager
    solve's u, cycle count, history and records bit for bit, with the
    same kernel launches (a fused cycle writing the graph's static u
    through the ascend edge's out=, an unfused one copying it); a second
    solve replays the cached graph.  The residual sum runs once a solve
    (rms0, and fmg's right-hand side) and once an unfused cycle."""
    cfg = poisson2d.PoissonConfig(nx=256, ny=256, solver="multigrid",
                                  problem="poly")
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, torch.float32,
                                                cuda_device)
    u0 = poisson2d._dirichlet_init(ue)
    mgc = multigrid.MGConfig(tol=1e-5, max_cycles=20, **opts)

    def run(graph):
        res = [multigrid.solve(f, u0, cfg.dx, cfg.dy, mgc, graph=graph)
               for _ in range(2)]
        for r in res[1:]:
            assert r.iterations == res[0].iterations
            _assert_same((r.u, r.history), (res[0].u, res[0].history))
        r = res[0]
        return r.u, r.rms, r.rms0, r.history, r.iterations, r.n_records

    (eager, n_eager), (graphed, n_graph) = _graph_vs_eager(run)
    _assert_same(graphed[:4], eager[:4])
    assert graphed[4:] == eager[4:] and eager[4] > 1
    assert n_graph == n_eager
    fused = opts.get("fused") != "off" and opts.get("smoother") != "cheb"
    assert n_graph["residual_ssq"] == 2 * (1 + (0 if fused else eager[4]))


@pytest.mark.cuda
def test_host_sync_inside_a_graphed_chunk_raises(cuda_device):
    """A step that reads a value on the host cannot be captured: the
    loop raises instead of running it eagerly, and the device stays
    usable."""
    q = torch.ones(8, device=cuda_device)

    def step(q):
        return q * (1.0 + 1e-3 * q.sum().item())

    with pytest.raises(RuntimeError):
        loop.advance(step, q, 10)
    good = loop.advance(lambda q: 2.0 * q, q, 3)
    assert torch.equal(good, 8.0 * q)


@pytest.mark.cuda
def test_resume_is_bitwise_on_the_gpu(cuda_device, tmp_path):
    """The 64^2 fp32 cavity, checkpointed every 40 steps and stopped at
    80, resumes to 150 bit for bit the uninterrupted graphed run, rms
    history included; so does ps23 at 64^2 (30 + 30 steps)."""
    ck = str(tmp_path / "c.npz")
    cfg = cavity.CavityConfig(nx=64, ny=64, dt=1e-3, t_final=0.08)
    cavity.solve(cfg, torch.float32, cuda_device, checkpoint_every=40,
                 checkpoint_path=ck)
    cfg = dataclasses.replace(cfg, t_final=0.15)
    got = cavity.solve(cfg, torch.float32, cuda_device, checkpoint_path=ck,
                       resume=True)
    want = cavity.solve(cfg, torch.float32, cuda_device)
    _assert_same((got.w, got.s, got.rms_history),
                 (want.w, want.s, want.rms_history))
    vk = str(tmp_path / "v.npz")
    vcfg = vortex.VortexConfig(nx=64, ny=64, solver="ps23", dt=1e-3,
                               t_final=0.03, ns=1)
    vortex.solve(vcfg, torch.float32, cuda_device, checkpoint_every=30,
                 checkpoint_path=vk)
    vcfg = dataclasses.replace(vcfg, t_final=0.06, ns=2)
    got = vortex.solve(vcfg, torch.float32, cuda_device, checkpoint_path=vk,
                       resume=True)
    want = vortex.solve(vcfg, torch.float32, cuda_device)
    _assert_same((got.w, got.snapshots), (want.w, want.snapshots))


# ------------------------------------------------ the packed cavity stage

# (nx, ny) of the packed cavity: 1024^2 (a 1024^2 buffer), 16^2 (16 x 128),
# 24 x 16, 33 x 47 (P = m = 32: no padded row), 34 x 130 (40 x 256), 9 x 129
# (P = m = 8, n = Q = 128), 1025^2 (m = n = P = Q = 1024), 3 x 3 (m = n = 2)
STAGE_SHAPES = [(1024, 1024), (16, 16), (24, 16), (33, 47), (34, 130),
                (9, 129), (1025, 1025), (3, 3)]
# the stage kernel's walk constants as its source states them (the CPU
# emulation, tests/test_torch_stage_tiling.py, reads the same)
STAGE_CONSTANTS = {
    name: int(re.search(rf"constexpr int {key} = (\d+);",
                        (_cuda_build.CSRC / "cavity_stage.cu").read_text())
              .group(1))
    for name, key in (("rows", "kRows"), ("walkers", "kWalkers"),
                      ("vec_bytes", "kVecBytes"), ("lanes", "kWarp"))}


def _stage_inputs(nx, ny, dtype, device, seed):
    """Random interior fields of scale 1 with zero padding, and random wall
    vectors zero past the logical interior."""
    rng = np.random.default_rng(seed)
    m, n = nx - 1, ny - 1
    P, Q = cavity_fused.padded_extents(nx, ny)
    fields = []
    for _ in range(3):
        a = np.zeros((P, Q))
        a[:m, :n] = rng.standard_normal((m, n))
        fields.append(torch.as_tensor(a, dtype=dtype, device=device))
    walls = []
    for size, L in ((Q, n), (Q, n), (P, m), (P, m)):
        v = np.zeros(size)
        v[:L] = rng.standard_normal(L)
        walls.append(torch.as_tensor(v, dtype=dtype, device=device))
    return (*fields, tuple(walls))


@pytest.mark.cuda
@pytest.mark.parametrize("bc_order", [1, 2])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,ny", STAGE_SHAPES)
def test_cavity_stage_kernel_matches_plain(cuda_device, nx, ny, dtype, stage,
                                           bc_order):
    """The stage kernel against its twin (the new interior and the four
    wall vectors), a second call bitwise, one launch a call, padding 0."""
    w, wt, s, walls = _stage_inputs(nx, ny, dtype, cuda_device,
                                    seed=nx + 7 * stage + bc_order)
    if stage == 1:
        wt = w
    args = (w, wt, s, walls, stage, 1e-3, 1.0 / nx, 1.0 / ny, 100.0, nx - 1,
            ny - 1, bc_order)
    before = cuda_kernels.LAUNCHES["cavity_fused_stage"]
    got = cuda_kernels.cavity_fused_stage(*args)
    again = cuda_kernels.cavity_fused_stage(*args)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["cavity_fused_stage"] == before + 2
    ref = cuda_kernels.cavity_fused_stage_plain(*args)
    _assert_rel(got[0], ref[0], REL[dtype])
    for g, r in zip(got[1], ref[1]):
        _assert_rel(g, r, REL[dtype])
    _assert_same((got[0], *got[1]), (again[0], *again[1]))
    assert not got[0][nx - 1:].any() and not got[0][:, ny - 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,Q,m,n", [(13, 128, 11, 100), (13, 128, 13, 128),
                                     (5, 264, 2, 2), (21, 72, 20, 70)])
def test_cavity_stage_kernel_on_raw_buffers(cuda_device, P, Q, m, n, dtype):
    """Buffers the packed layout does not make but the kernel takes (the
    CPU emulation's raw shapes): a last walker past the buffer's end, m = P
    with n = Q, m = n = 2, Q not a multiple of a warp's columns; every
    stage against the twin, a second call bitwise, padding 0."""
    rng = np.random.default_rng(P * Q + m)
    for stage in (1, 2, 3):
        fields = []
        for _ in range(3):
            a = np.zeros((P, Q))
            a[:m, :n] = rng.standard_normal((m, n))
            fields.append(torch.as_tensor(a, dtype=dtype, device=cuda_device))
        walls = []
        for size, L in ((Q, n), (Q, n), (P, m), (P, m)):
            v = np.zeros(size)
            v[:L] = rng.standard_normal(L)
            walls.append(torch.as_tensor(v, dtype=dtype, device=cuda_device))
        w, wt, s = fields
        if stage == 1:
            wt = w
        args = (w, wt, s, tuple(walls), stage, 1e-3, 1.0 / (m + 1),
                1.0 / (n + 1), 100.0, m, n, 2)
        got = cuda_kernels.cavity_fused_stage(*args)
        again = cuda_kernels.cavity_fused_stage(*args)
        ref = cuda_kernels.cavity_fused_stage_plain(*args)
        for g, r in zip((got[0], *got[1]), (ref[0], *ref[1])):
            _assert_rel(g, r, REL[dtype])
        _assert_same((got[0], *got[1]), (again[0], *again[1]))
        assert not got[0][m:].any() and not got[0][:, n:].any()


@pytest.mark.cuda
def test_cavity_stage_constants_match_the_emulation(cuda_device):
    """The walk the library was built with is the one the CPU emulation
    replays."""
    assert cuda_kernels.cavity_stage_geometry() == STAGE_CONSTANTS


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_cavity_stage_graph_capture(cuda_device, stage):
    """The stage kernel captured in a CUDA graph (the loop layer's chunks
    hold 3 a step) replays bitwise the eager call on new inputs, one
    launch a replay."""
    nx, ny = 34, 130
    w, wt, s, walls = _stage_inputs(nx, ny, torch.float32, cuda_device, 5)
    if stage == 1:
        wt = w
    args = (w, wt, s, walls, stage, 1e-3, 1 / nx, 1 / ny, 100.0, nx - 1,
            ny - 1, 2)
    cuda_kernels.cavity_fused_stage(*args)   # build and warm up
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = cuda_kernels.cavity_fused_stage(*args)
    for seed in (1, 2):
        fresh = _stage_inputs(nx, ny, torch.float32, cuda_device, seed)
        for dst, src in zip((w, wt, s, *walls),
                            (fresh[0], fresh[1], fresh[2], *fresh[3])):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = cuda_kernels.cavity_fused_stage(*args)
        _assert_same((out[0], *out[1]), (want[0], *want[1]))


@pytest.mark.cuda
def test_cavity_stage_refuses_misaligned_rows(cuda_device):
    """The kernel reads rows as 16-byte vectors: a field whose storage
    starts off a 16-byte boundary is refused with a launch error, never
    read."""
    w, wt, s, walls = _stage_inputs(16, 16, torch.float32, cuda_device, 0)
    shifted = torch.zeros(w.numel() + 1, device=cuda_device)[1:].view(
        w.shape)
    shifted.copy_(w)
    before = cuda_kernels.LAUNCHES["cavity_fused_stage"]
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_kernels.cavity_fused_stage(shifted, wt, s, walls, 2, 1e-3,
                                        1 / 16, 1 / 16, 100.0, 15, 15, 2)
    assert cuda_kernels.LAUNCHES["cavity_fused_stage"] == before


@pytest.mark.cuda
def test_cavity_stage_wrapper_raises_on_cuda_misuse(cuda_device):
    """On CUDA tensors the wrapper launches or raises: a non-contiguous
    field, tensors on two devices and a bf16 field are refused, never
    handed to the twin."""
    w, wt, s, walls = _stage_inputs(16, 16, torch.float32, cuda_device, 0)
    rest = (1, 1e-3, 1 / 16, 1 / 16, 100.0, 15, 15, 2)
    before = cuda_kernels.LAUNCHES["cavity_fused_stage"]
    wide = torch.zeros(16, 256, device=cuda_device)[:, :128]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.cavity_fused_stage(wide, wide, s, walls, *rest)
    with pytest.raises(ValueError, match="different devices"):
        cuda_kernels.cavity_fused_stage(w, wt, s.cpu(), walls, *rest)
    with pytest.raises(TypeError):
        cuda_kernels.cavity_fused_stage(w.bfloat16(), wt.bfloat16(),
                                        s.bfloat16(),
                                        tuple(v.bfloat16() for v in walls),
                                        *rest)
    assert cuda_kernels.LAUNCHES["cavity_fused_stage"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(64, 64), (33, 47)])
def test_fused_cavity_kernel_matches_twin_and_matmul(cuda_device, nx, ny):
    """fp64, 30 steps from rest through cavity.solve: the packed step on
    the kernel against the packed step on the twin and the full-grid
    matmul step, 3 stage launches a step and no Arakawa launch."""
    base = cavity.CavityConfig(nx=nx, ny=ny, dt=1e-3, t_final=0.03,
                               poisson="fused")
    cuda_kernels.reset_launch_counts()
    got = cavity.solve(base, torch.float64, cuda_device)
    launches = dict(cuda_kernels.LAUNCHES)
    assert launches["cavity_fused_stage"] == 90
    assert launches["arakawa_rhs"] == 0
    twin = cavity.solve(dataclasses.replace(base, rhs_impl="torch"),
                        torch.float64, cuda_device)
    ref = cavity.solve(dataclasses.replace(base, poisson="matmul"),
                       torch.float64, cuda_device)
    for other in (twin, ref):
        _assert_rel(got.s, other.s, 1e-11)
        _assert_rel(got.w, other.w, 1e-11)
        _assert_rel(got.rms_history, other.rms_history, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(64, 64), (34, 130)])
def test_graphed_fused_cavity_equals_eager(cuda_device, nx, ny):
    """60 fp32 packed steps, twice on one step function: the graphed state
    and rms history are the eager ones bit for bit, 3 stage launches a
    step either way."""
    cfg = cavity.CavityConfig(nx=nx, ny=ny, dt=2e-4)
    step = cavity_fused.make_fused_step_fn(cfg, torch.float32, cuda_device)
    state = cavity_fused.init_state(cfg, torch.float32, cuda_device)

    def run(graph):
        s, h1 = loop.run_steps(step, state, 60, graph=graph)
        s, h2 = loop.run_steps(step, s, 60, graph=graph)
        return (*s, h1, h2)

    (eager, n_eager), (graphed, n_graph) = _graph_vs_eager(run)
    assert all(bool(torch.isfinite(t).all()) for t in eager)
    _assert_same(graphed, eager)
    assert n_graph == n_eager and n_graph["cavity_fused_stage"] == 3 * 120


@pytest.mark.cuda
def test_fused_resume_is_bitwise_on_the_gpu(cuda_device, tmp_path):
    """The 64^2 fp32 packed cavity, checkpointed every 40 steps and stopped
    at 80, resumes to 150 bit for bit the uninterrupted graphed run."""
    ck = str(tmp_path / "f.npz")
    cfg = cavity.CavityConfig(nx=64, ny=64, dt=1e-3, t_final=0.08,
                              poisson="fused")
    cavity.solve(cfg, torch.float32, cuda_device, checkpoint_every=40,
                 checkpoint_path=ck)
    cfg = dataclasses.replace(cfg, t_final=0.15)
    got = cavity.solve(cfg, torch.float32, cuda_device, checkpoint_path=ck,
                       resume=True)
    want = cavity.solve(cfg, torch.float32, cuda_device)
    _assert_same((got.w, got.s, got.rms_history),
                 (want.w, want.s, want.rms_history))


# ------------------------------------------------ the stage's backward

# the backward kernel's shapes: the 1024^2 buffer, padding on both axes,
# none (P = m = 8, n = Q = 128), the smallest interior, a part-filled
# last block on both axes
STAGE_BACKWARD_SHAPES = [(1024, 1024), (24, 16), (9, 129), (3, 3),
                         (34, 130)]


def _stage_backward_inputs(nx, ny, dtype, device, seed):
    """Random fields and wall vectors on the whole buffer (the padding
    too), cotangents g and h of the stage's outputs."""
    rng = np.random.default_rng(seed)
    P, Q = cavity_fused.padded_extents(nx, ny)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    wt, s, g = (t(rng.standard_normal((P, Q))) for _ in range(3))
    walls, h = (tuple(t(rng.standard_normal(k)) for k in (Q, Q, P, P))
                for _ in range(2))
    return wt, s, walls, g, h


def _flat_backward(r):
    gw, gwt, gs, gwalls, gre = r
    return [x for x in (gw, gwt, gs, *gwalls, gre) if x is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("re_grad", [True, False], ids=["re", "no_re"])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,ny", STAGE_BACKWARD_SHAPES)
def test_cavity_stage_backward_kernel_matches_plain(cuda_device, nx, ny,
                                                    dtype, stage, re_grad):
    """The stage's backward kernel against its plain version for both
    wall-BC orders: every field and wall-vector gradient within REL of its
    scale, d/dre within 1e-10 (fp64) or 1e-5 of c sum|q lap W|/re^2
    (fp32); a second call bitwise; one backward launch a call, with or
    without the Re gradient (its sum is folded into the last block)."""
    m, n = nx - 1, ny - 1
    dt, dx, dy, re = 1e-3, 1.0 / nx, 1.0 / ny, 100.0
    for bc_order in (1, 2):
        wt, s, walls, g, h = _stage_backward_inputs(
            nx, ny, dtype, cuda_device, seed=nx + 7 * stage + bc_order)
        args = (stage, dt, dx, dy, re, m, n, bc_order)
        before = dict(cuda_kernels.LAUNCHES)
        got = cuda_kernels.cavity_fused_stage_backward(
            wt, s, walls, g, h, *args, re_grad=re_grad)
        again = cuda_kernels.cavity_fused_stage_backward(
            wt, s, walls, g, h, *args, re_grad=re_grad)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES["cavity_stage_backward"] == \
            before["cavity_stage_backward"] + 2
        assert not any(k.endswith("_re_grad") for k in cuda_kernels.LAUNCHES)
        ref = cuda_kernels.cavity_fused_stage_backward_plain(
            wt, s, walls, g, h, *args)
        assert (got[0] is None) == (stage == 1)
        assert (got[4] is None) != re_grad
        for mine, want in zip(_flat_backward(got)[:-1] if re_grad else
                              _flat_backward(got),
                              _flat_backward(ref)[:-1]):
            _assert_rel(mine, want, REL[dtype])
        _assert_same(_flat_backward(got), _flat_backward(again))
        if re_grad:
            err = abs(float(got[4]) - float(ref[4]))
            if dtype == torch.float64:
                assert err <= 1e-10 * abs(float(ref[4]))
            else:
                c = {1: 1.0, 2: 0.25, 3: 2 / 3}[stage] * dt
                lap = cuda_kernels.arakawa.laplacian(
                    F.pad(cuda_kernels._extended_w(
                        wt.double(), tuple(v.double() for v in walls), m, n,
                        cuda_kernels._lid(dy, bc_order)), (1, 1, 1, 1)),
                    dx, dy)[2:-2, 2:-2]
                q = g.double()[:m, :n]
                scale = c * float((q * lap[:m, :n]).abs().sum()) / re**2
                assert err <= 1e-5 * scale


# the backward kernel's walk constants as its source states them (the CPU
# emulation, tests/test_torch_stage_backward_tiling.py, reads the same)
STAGE_BACKWARD_CONSTANTS = {
    name: int(re.search(rf"constexpr int {key} = (\d+);",
                        (_cuda_build.CSRC / "cavity_stage.cu").read_text())
              .group(1))
    for name, key in (("rows", "kBackRows"), ("walkers", "kBackWalkers"))}


@pytest.mark.cuda
def test_cavity_stage_backward_constants_match_the_emulation(cuda_device):
    """The backward walk the library was built with is the one the CPU
    emulation replays, and its Re partials' count is the emulation's: the
    blocks of the fp64 grid (a walker spans 16 bytes a lane of 32 lanes),
    at least those of the fp32 grid."""
    assert cuda_kernels.cavity_stage_backward_geometry() == \
        STAGE_BACKWARD_CONSTANTS
    rows, walkers = (STAGE_BACKWARD_CONSTANTS[k] for k in ("rows", "walkers"))
    lib = _cuda_build.load_library()
    for nx, ny in STAGE_SHAPES:
        P, Q = cavity_fused.padded_extents(nx, ny)
        by = -(-(-(-P // rows)) // walkers)      # walker groups
        blocks = [-(-Q // (32 * 16 // size)) * by for size in (4, 8)]
        assert lib.cavity_stage_backward_partials(P, Q) == max(blocks)


@pytest.mark.cuda
def test_cavity_stage_backward_refuses_misaligned_rows(cuda_device):
    """The backward kernel reads the rows of g, wt and s as 16-byte
    vectors: a cotangent whose storage starts off a 16-byte boundary is
    refused with a launch error, never read; through autograd the
    Function hands the kernel an aligned copy."""
    wt, s, walls, g, h = _stage_backward_inputs(16, 16, torch.float32,
                                                cuda_device, 0)
    shifted = torch.zeros(g.numel() + 1, device=cuda_device)[1:].view(
        g.shape)
    shifted.copy_(g)
    args = (2, 1e-3, 1 / 16, 1 / 16, 100.0, 15, 15, 2)
    before = cuda_kernels.LAUNCHES["cavity_stage_backward"]
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_kernels.cavity_fused_stage_backward(wt, s, walls, shifted, h,
                                                 *args)
    assert cuda_kernels.LAUNCHES["cavity_stage_backward"] == before
    w = wt.clone().requires_grad_(True)
    out, walls_out = cuda_kernels.cavity_fused_stage(
        w, wt, s, walls, 2, 1e-3, 1 / 16, 1 / 16, 100.0, 15, 15, 2)
    (gw,) = torch.autograd.grad((out, *walls_out), w, (shifted, *h))
    want = cuda_kernels.cavity_fused_stage_backward(wt, s, walls, g, h,
                                                    *args)[0]
    _assert_same((gw,), (want,))


@pytest.mark.cuda
def test_cavity_stage_autograd_function_gradcheck(cuda_device):
    """torch.autograd.gradcheck of the kernel pair (forward kernel,
    backward kernel) in fp64 on raw (8, 8) buffers (m = 5, n = 6: padding
    on both axes) at each stage, in w, wt, s and the four wall vectors,
    against finite differences of the forward kernel; and the Re gradient
    (re_t's value is not read: the kernel takes the float re) against a
    central difference of the forward kernel in that float, rel 1e-6; no
    twin runs."""
    rng = np.random.default_rng(12)
    P, Q, m, n = 8, 8, 5, 6
    t = lambda shape, grad=True: torch.tensor(
        rng.standard_normal(shape), dtype=torch.float64, device=cuda_device,
        requires_grad=grad)
    for stage in (1, 2, 3):
        fields = [t((P, Q)) for _ in range(3)]
        walls = [t(k) for k in (Q, Q, P, P)]

        def fn(w, wt, s, rl, rh, cl, ch, re=90.0, re_t=None):
            wt = w if stage == 1 else wt
            out, walls_out = cuda_kernels.cavity_fused_stage(
                w, wt, s, (rl, rh, cl, ch), stage, 0.01, 0.2, 0.15, re, m, n,
                2, re_t=re_t)
            return (out, *walls_out)

        before = cuda_kernels.LAUNCHES["cavity_stage_backward"]
        assert torch.autograd.gradcheck(fn, (*fields, *walls), eps=1e-6,
                                        atol=1e-7)
        assert cuda_kernels.LAUNCHES["cavity_stage_backward"] > before
        cot = [t(tuple(o.shape), grad=False) for o in fn(*fields, *walls)]
        re_t = torch.tensor(90.0, dtype=torch.float64, device=cuda_device,
                            requires_grad=True)
        outs = fn(*fields, *walls, re_t=re_t)
        (g,) = torch.autograd.grad(outs, re_t, cot)
        with torch.no_grad():
            loss = lambda re: sum(float(torch.sum(o * c)) for o, c in zip(
                fn(*fields, *walls, re=re), cot))
            fd = (loss(90.0 + 1e-3) - loss(90.0 - 1e-3)) / 2e-3
        assert abs(float(g) - fd) <= 1e-6 * abs(fd), (float(g), fd)


@pytest.mark.cuda
def test_fused_grad_kernel_matches_twin(cuda_device):
    """d (1e6 mean psi^2) / d Re and the gradient w.r.t. the initial
    packed w through 10 eager fp64 packed steps (32^2, from a developed
    state): the stage kernel with its backward kernel against the twin's
    autograd (rel 1e-10; 1e-10 of the state gradient's scale), with as
    many backward launches as forward ones, and no gradient in w's
    padding."""
    cfg = cavity.CavityConfig(nx=32, ny=32, dt=1e-3, poisson="fused")
    start = tuple(t.clone() for t in loop.advance(
        cavity_fused.make_fused_step_fn(cfg, torch.float64, cuda_device),
        cavity_fused.init_state(cfg, torch.float64, cuda_device), 20))

    def grads(rhs_impl):
        c = dataclasses.replace(cfg, rhs_impl=rhs_impl)
        re = torch.tensor(100.0, dtype=torch.float64, device=cuda_device,
                          requires_grad=True)
        w0 = start[0].clone().requires_grad_()
        step = cavity_fused.make_fused_step_fn(c, torch.float64, cuda_device,
                                               re=re)
        final = loop.advance(step, (w0, *start[1:]), 10, graph=False)
        psi = cavity_fused.decode_state(c, final)[1]
        return torch.autograd.grad(1e6 * torch.mean(psi ** 2), (re, w0))

    ref = grads("torch")
    cuda_kernels.reset_launch_counts()
    got = grads("kernel")
    assert cuda_kernels.LAUNCHES["cavity_fused_stage"] == 30
    assert cuda_kernels.LAUNCHES["cavity_stage_backward"] == 30
    assert not any(k.endswith("_re_grad") for k in cuda_kernels.LAUNCHES)
    assert abs(float(got[0]) - float(ref[0])) <= 1e-10 * abs(float(ref[0]))
    _assert_rel(got[1], ref[1], 1e-10)
    assert not got[1][31:].any() and not got[1][:, 31:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
def test_tier_backward_is_the_product_of_the_cotangent(cuda_device, passes):
    """On the card the tier Functions' backward is kernel 8 on the
    cotangent, bit for bit: through a plan of the 1024^2 zero-extended
    sine matrix (symmetric: the plan itself) on either side, through a
    plan of a general constant (its transposed plan), and through
    tier_matmul (g @ b^T, a^T @ g); one split and one GEMM launch a
    plan's backward."""
    n = 1024
    k = torch.arange(n, device=cuda_device)
    inside = (k[:, None] < n - 1) & (k[None, :] < n - 1)
    sine = torch.where(inside, direct._sine_entries(
        k[:, None] + 1, k[None, :] + 1, n, torch.float32), 0.0)
    rng = np.random.default_rng(passes)
    rand = lambda shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=torch.float32,
                                         device=cuda_device)
    general = rand((n, n))
    for const, symmetric in ((sine, True), (general, False)):
        for side in ("left", "right"):
            plan = cuda_kernels.TierPlan(const, passes, side, (n, n))
            assert plan.symmetric == symmetric
            x = rand((n, n)).requires_grad_()
            g = rand((n, n))
            out = plan(x)
            cuda_kernels.reset_launch_counts()
            (got,) = torch.autograd.grad(out, x, g)
            assert cuda_kernels.LAUNCHES["tier_gemm"] == 1
            assert cuda_kernels.LAUNCHES["tier_split"] == \
                (1 if symmetric else 2)
            want = cuda_kernels.TierPlan(const.T.contiguous(), passes, side,
                                         (n, n))(g)
            _assert_same(got, want)
    a, b, g = rand((200, 130)), rand((130, 70)), rand((200, 70))
    a.requires_grad_()
    b.requires_grad_()
    ga, gb = torch.autograd.grad(cuda_kernels.tier_matmul(a, b, passes),
                                 (a, b), g)
    with torch.no_grad():
        _assert_same(ga, cuda_kernels.tier_matmul(g, b.T.contiguous(),
                                                  passes))
        _assert_same(gb, cuda_kernels.tier_matmul(a.T.contiguous(), g,
                                                  passes))


@pytest.mark.cuda
def test_graphed_fused_tier_with_reynolds_tensor_is_unchanged(cuda_device):
    """A graphed no-grad fused_bf16x3 run is the eager run of a step built
    with an Re tensor that requires no grad, bit for bit, with the same
    launches (3 stage, 12 tier GEMM and 3 split a step) and no backward
    launch; the
    graphed loop refuses a step built with an Re tensor (its value is read
    once on the host, which a replay would keep) and a packed state that
    requires grad, each naming graph=False."""
    cfg = cavity.CavityConfig(nx=64, ny=64, dt=1e-3, poisson="fused_bf16x3")
    state = cavity_fused.init_state(cfg, torch.float32, cuda_device)
    float_step = cavity_fused.make_fused_step_fn(cfg, torch.float32,
                                                 cuda_device)
    re_step = cavity_fused.make_fused_step_fn(
        cfg, torch.float32, cuda_device,
        re=torch.tensor(cfg.re, device=cuda_device))
    runs = []
    for step, graph in ((float_step, True), (re_step, False)):
        cuda_kernels.reset_launch_counts()
        out = loop.run_steps(step, state, 60, graph=graph)
        torch.cuda.synchronize()
        runs.append(((*out[0], out[1]), dict(cuda_kernels.LAUNCHES)))
    (a, na), (b, nb) = runs
    _assert_same(a, b)
    assert na == nb
    assert na["cavity_fused_stage"] == 180
    # a solve: one split (its input) and four GEMMs writing the next
    # product's planes themselves
    assert na["tier_gemm"] == 720 and na["tier_split"] == 180
    assert na["cavity_stage_backward"] == 0
    with pytest.raises(ValueError, match="graph=False"):
        loop.run_steps(re_step, state, 5)
    grad_state = (state[0].clone().requires_grad_(), *state[1:])
    with pytest.raises(ValueError, match="graph=False"):
        loop.run_steps(float_step, grad_state, 5)


# ------------------------------------------------ the 1D heat / Burgers family

@pytest.mark.cuda
@pytest.mark.parametrize("solver,bc", [("crweno", "periodic"),
                                       ("crweno", "dirichlet"),
                                       ("weno", "dirichlet"),
                                       ("flux_split", "periodic")])
def test_burgers_on_gpu_matches_cpu_and_graphs(cuda_device, solver, bc):
    """fp64, 60 steps with 3 snapshots: the card's run against the CPU's
    within 1e-12 of the scale, and graphed bitwise equal to eager."""
    cfg = burgers1d.BurgersConfig(nx=200, solver=solver, bc=bc, dt=1e-4,
                                  t_final=0.006, ns=3)
    step = burgers1d.make_step_fn(cfg)
    _, u0 = burgers1d.initial_condition(cfg, torch.float64, cuda_device)
    (eager, _), (graphed, _) = _graph_vs_eager(
        lambda graph: loop.run_steps_with_snapshots(step, u0, cfg.nt, 20,
                                                    graph=graph))
    _assert_same(graphed, eager)
    cpu = burgers1d.solve(cfg, torch.float64, "cpu")
    _assert_rel(graphed[0], cpu.u, 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["ftcs", "rk3", "cn", "icp"])
def test_heat_on_gpu_matches_cpu(cuda_device, scheme):
    cfg = heat1d.HeatConfig(scheme=scheme, t_final=0.1)
    got = heat1d.solve(cfg, torch.float64, cuda_device, keep_history=True)
    cpu = heat1d.solve(cfg, torch.float64, "cpu", keep_history=True)
    _assert_rel(got.history, cpu.history, 1e-12)


# ------------------------------------------------ the bf16 precision tiers

# (M, N, K): the path's 1024^3 (fused) and 1023^3 (matmul, the scalar-load
# path) and tiny / ragged shapes
TIER_SHAPES = [(1024, 1024, 1024), (1023, 1023, 1023), (1, 1, 1),
               (15, 17, 13), (33, 47, 129), (130, 131, 129), (136, 68, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("shape", TIER_SHAPES)
def test_tier_gemm_matches_plain(cuda_device, shape, passes):
    """The split-bf16 kernel against its twin within 1e-5 of max|C| (the
    same split; the kernel accumulates every pass in fp32, the twin takes
    each pass in fp64), a second call bitwise, one launch a call."""
    m, n, k = shape
    a_np, b_np = _fields((m, k), seed=m + n)[0], _fields((k, n), seed=k)[0]
    a = torch.as_tensor(a_np, dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(b_np, dtype=torch.float32, device=cuda_device)
    before = cuda_kernels.LAUNCHES["tier_gemm"]
    got = cuda_kernels.tier_matmul(a, b, passes)
    again = cuda_kernels.tier_matmul(a, b, passes)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["tier_gemm"] == before + 2
    _assert_rel(got, cuda_kernels.tier_matmul_plain(a, b, passes), 1e-5)
    _assert_same(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("n", [1024, 1023])
def test_tier_gemm_on_sine_matrices(cuda_device, n, passes):
    """The path's operands: the sine matrix of a 1024^2 cavity (the packed
    step's zero-extended one at 1024, the interior one at 1023) times a
    field and times itself."""
    k = torch.arange(1, n + 1, dtype=torch.int32, device=cuda_device)
    s = torch.where((k[:, None] < 1024) & (k[None, :] < 1024),
                    direct._sine_entries(k[:, None], k[None, :], 1024,
                                         torch.float32), 0.0)
    g = torch.as_tensor(_fields((n, n), seed=9)[0], dtype=torch.float32,
                        device=cuda_device)
    for a, b in ((s, g), (g, s), (s, s)):
        _assert_rel(cuda_kernels.tier_matmul(a, b, passes),
                    cuda_kernels.tier_matmul_plain(a, b, passes), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape", [(1024, 1024), (1023, 1023), (1, 1),
                                   (15, 17), (33, 129), (130, 131)])
def test_tier_split_matches_plain(cuda_device, shape, transpose, passes):
    """The split pass bitwise equal to its twin (which is _bf16_split,
    zero-padded): pad zeros written, B transposed, and an operand read in
    place through its row stride (the interior of a larger field, rows
    not 16-byte aligned) as well as a contiguous one."""
    rows, cols = shape
    full = torch.as_tensor(_fields((rows + 2, cols + 2), seed=rows + cols)[0],
                           dtype=torch.float32, device=cuda_device)
    need = (cols, rows) if transpose else (rows, cols)
    out_rows = -(-need[0] // 128) * 128
    kp = -(-need[1] // 64) * 64
    for x in (full[1:-1, 1:-1], full[1:-1, 1:-1].contiguous()):
        before = cuda_kernels.LAUNCHES["tier_split"]
        got = cuda_kernels.tier_split(x, transpose, out_rows, kp, passes)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES["tier_split"] == before + 1
        ref = cuda_kernels.tier_split_plain(x, transpose, out_rows, kp,
                                            passes)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
        hi, lo = cuda_kernels._bf16_split(x.t() if transpose else x)
        assert torch.equal(got[0, :need[0], :need[1]].float(), hi)
        if passes == 3:
            assert torch.equal(got[1, :need[0], :need[1]].float(), lo)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("shape", TIER_SHAPES)
def test_tier_plan_matches_twin(cuda_device, shape, side, passes):
    """A TierPlan (the constant split once) against the twin within 1e-5
    of max|C|, a field read through its row stride, two calls bitwise,
    one tier_split and one tier_gemm launch a call."""
    m, n, k = shape
    const_shape, field_shape = (((m, k), (k, n)) if side == "left"
                                else ((k, n), (m, k)))
    const = torch.as_tensor(_fields(const_shape, seed=m + 2 * n)[0],
                            dtype=torch.float32, device=cuda_device)
    full = torch.as_tensor(
        _fields((field_shape[0] + 1, field_shape[1] + 1), seed=k)[0],
        dtype=torch.float32, device=cuda_device)
    field = full[1:, 1:]
    plan = cuda_kernels.TierPlan(const, passes, side, field_shape)
    before = dict(cuda_kernels.LAUNCHES)
    got = plan(field)
    again = plan(field)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["tier_split"] == before["tier_split"] + 2
    assert cuda_kernels.LAUNCHES["tier_gemm"] == before["tier_gemm"] + 2
    a, b = (const, field) if side == "left" else (field, const)
    _assert_rel(got, cuda_kernels.tier_matmul_plain(a, b, passes), 1e-5)
    _assert_same(got, again)


@pytest.mark.cuda
def test_tier_gemm_graph_capture(cuda_device):
    """tier_matmul captured into a CUDA graph (stepping/loop.py's chunks
    hold 12 a step): replays bitwise the eager call on new inputs."""
    a = torch.randn(300, 260, device=cuda_device)
    b = torch.randn(260, 200, device=cuda_device)
    cuda_kernels.tier_matmul(a, b, 3)   # build and warm up
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = cuda_kernels.tier_matmul(a, b, 3)
    for seed in (1, 2):
        torch.manual_seed(seed)
        a.copy_(torch.randn_like(a))
        b.copy_(torch.randn_like(b))
        graph.replay()
        torch.cuda.synchronize()
        _assert_same(out, cuda_kernels.tier_matmul(a, b, 3))


@pytest.mark.cuda
def test_tier_gemm_wrapper_raises_on_cuda_misuse(cuda_device):
    """On CUDA tensors the wrappers launch or raise: a non-contiguous
    operand, operands on two devices and fp64 are refused, never handed to
    the twin; the split pass refuses columns that are not contiguous, and
    a plan a field of another shape or device."""
    a = torch.zeros(64, 64, device=cuda_device)
    before = dict(cuda_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.tier_matmul(a.t(), a, 3)
    with pytest.raises(ValueError, match="different devices"):
        cuda_kernels.tier_matmul(a, a.cpu(), 3)
    with pytest.raises(TypeError):
        cuda_kernels.tier_matmul(a.double(), a.double(), 1)
    with pytest.raises(ValueError, match="row stride"):
        cuda_kernels.tier_split(a.t(), False, 128, 64, 3)
    with pytest.raises(TypeError):
        cuda_kernels.tier_split(a.double(), False, 128, 64, 3)
    assert cuda_kernels.LAUNCHES == before
    plan = cuda_kernels.TierPlan(a, 3, "left", (64, 64))
    with pytest.raises(ValueError):
        plan(torch.zeros(64, 32, device=cuda_device))
    with pytest.raises(ValueError):
        plan(a.cpu())


def _bits(t):
    """A tensor to compare bitwise: bf16 planes as their int16 bits."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("role", ["A", "B", "C"])
@pytest.mark.parametrize("shape", TIER_SHAPES)
def test_tier_gemm_planes_is_split_of_op(cuda_device, shape, role, passes):
    """The GEMM's planes epilogue (TierPlan.gemm_into) bitwise tier_split of
    op(the plain GEMM's C), op torch's / and * by a table or a scale,
    through a plan on either side: the next product's A operand, its B
    operand transposed (every element of the padded planes, the pad's
    zeros too), or fp32 op(C) (op cuda_kernels._tier_op: / table,
    * scale, or none); one tier_gemm launch a
    call, two calls bitwise, a buffer passed in written in full."""
    m, n, k = shape
    rng = np.random.default_rng(m + 3 * n + k + passes)
    rand = lambda sh: torch.as_tensor(rng.standard_normal(sh),
                                      dtype=torch.float32,
                                      device=cuda_device)
    table = (rand((m, n)).abs() + 0.5) * torch.where(
        rand((m, n)) > 0, 1.0, -1.0)
    scale = 4.0 / (m * n + 17)
    for side, (const, field) in (("left", (rand((m, k)), rand((k, n)))),
                                 ("right", (rand((k, n)), rand((m, k))))):
        plan = cuda_kernels.TierPlan(const, passes, side, tuple(field.shape))
        plan.split(field)
        c = plan.gemm()
        for kw in ({}, {"table": table}, {"scale": scale}):
            want = cuda_kernels._tier_op(c, **kw)
            if role != "C":
                want = cuda_kernels.tier_split(
                    want, role == "B",
                    *cuda_kernels.tier_plane_extents(role, m, n), passes)
            before = cuda_kernels.LAUNCHES["tier_gemm"]
            got = plan.gemm_into(role, **kw)
            out = torch.full_like(got, float("nan"))
            again = plan.gemm_into(role, out, **kw)
            torch.cuda.synchronize()
            assert cuda_kernels.LAUNCHES["tier_gemm"] == before + 2
            assert again is out
            _assert_same(_bits(got), _bits(want))
            _assert_same(_bits(again), _bits(got))


def _solve_on_card(form, passes, device):
    """A tier solve of the 1024^2 cavity's shapes: the packed step's
    (1024^2 buffers, fused) or the interior one (1023^2, matmul)."""
    tier = {3: "bf16x3", 1: "bf16x1"}[passes]
    if form == "fused":
        cfg = cavity.CavityConfig(nx=1024, ny=1024, poisson=f"fused_{tier}")
        return cavity_fused.make_solve_neg(cfg, torch.float32, device)
    return direct.make_fst_matmul_interior(
        1024, 1024, 1 / 1024, 1 / 1024, torch.float32, device, tier).interior


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("form", ["fused", "matmul"])
def test_tier_solve_is_the_per_product_solve(cuda_device, form, passes):
    """A chained tier solve on the card (one split, four GEMMs writing each
    other's planes, / den and * scale folded in) bitwise the plans'
    products with torch's / and * between them, in 5 launches where those
    take 8 and 2 elementwise ones; a strided field read in place; a CUDA
    graph's replay bitwise the eager call; under autograd the same psi."""
    solve = _solve_on_card(form, passes, cuda_device)
    shape = solve.shape
    rng = np.random.default_rng(passes)
    full = torch.as_tensor(rng.standard_normal((shape[0] + 2, shape[1] + 2)),
                           dtype=torch.float32, device=cuda_device)
    for f in (full[1:-1, 1:-1], full[1:-1, 1:-1].contiguous()):
        want = solve.products(f)
        cuda_kernels.reset_launch_counts()
        got = solve(f)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES["tier_split"] == 1
        assert cuda_kernels.LAUNCHES["tier_gemm"] == 4
        _assert_same(got, want)
    x = f.clone().requires_grad_()
    _assert_same(solve(x).detach(), want)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = solve(f)
    f.copy_(torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    _assert_same(out, solve.products(f))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["matmul_bf16x3", "matmul_bf16x1",
                                  "fused_bf16x3", "fused_bf16x1"])
def test_chained_tier_gradient_is_the_per_product_one(cuda_device, tier,
                                                      monkeypatch):
    """d loss/dRe and d loss/d(w0) through 5 fp32 steps at 64^2 on the card,
    the chained solve's backward (one split, four GEMMs) bitwise the
    per-product solve's (a _TierPlanProduct a product, torch's / and *),
    as many tier launches backward as forward."""
    cfg = cavity.CavityConfig(nx=64, ny=64, dt=1e-3, poisson=tier)

    def grads():
        re_t = torch.tensor(100.0, device=cuda_device, requires_grad=True)
        if tier.startswith("fused"):
            step = cavity_fused.make_fused_step_fn(cfg, torch.float32,
                                                   cuda_device, re=re_t)
            state = cavity_fused.init_state(cfg, torch.float32, cuda_device)
        else:
            step = cavity.make_step_fn(cfg, torch.float32, cuda_device,
                                       re=re_t)
            state = cavity.initial_state(cfg, torch.float32, cuda_device)
        rng = np.random.default_rng(4)
        w0 = torch.as_tensor(0.1 * rng.standard_normal(
            tuple(state[0].shape)), dtype=torch.float32,
            device=cuda_device).requires_grad_()
        cuda_kernels.reset_launch_counts()
        final = loop.advance(step, (w0, *state[1:]), 5, graph=False)
        loss = 1e6 * torch.mean(final[1] ** 2)
        fwd = dict(cuda_kernels.LAUNCHES)
        cuda_kernels.reset_launch_counts()
        got = torch.autograd.grad(loss, (re_t, w0))
        torch.cuda.synchronize()
        return (loss.detach(), *got), fwd, dict(cuda_kernels.LAUNCHES)

    chained, fwd, bwd = grads()
    assert fwd["tier_gemm"] == bwd["tier_gemm"] == 12 * 5
    assert fwd["tier_split"] == bwd["tier_split"] == 3 * 5
    monkeypatch.setattr(cuda_kernels.TierSolve, "__call__",
                        lambda self, f: self.products(f))
    per_product, fwd_p, _ = grads()
    assert fwd_p["tier_split"] == 12 * 5
    _assert_same(chained, per_product)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["matmul_bf16x3", "matmul_bf16x1",
                                  "fused_bf16x3", "fused_bf16x1"])
def test_graphed_tier_cavity_equals_eager(cuda_device, tier):
    """60 fp32 steps of a tier at 64^2, twice on one step function: the
    graphed state and rms history are the eager ones bit for bit, with 12
    tier_gemm and 3 tier_split launches a step either way (a solve splits
    its input once; each GEMM writes the next product's planes)."""
    cfg = cavity.CavityConfig(nx=64, ny=64, dt=1e-3, poisson=tier)
    if tier.startswith("fused"):
        step = cavity_fused.make_fused_step_fn(cfg, torch.float32,
                                               cuda_device)
        state = cavity_fused.init_state(cfg, torch.float32, cuda_device)
    else:
        step = cavity.make_step_fn(cfg, torch.float32, cuda_device)
        state = cavity.initial_state(cfg, torch.float32, cuda_device)

    def run(graph):
        s, h1 = loop.run_steps(step, state, 60, graph=graph)
        s, h2 = loop.run_steps(step, s, 60, graph=graph)
        return (*s, h1, h2)

    (eager, n_eager), (graphed, n_graph) = _graph_vs_eager(run)
    assert all(bool(torch.isfinite(t).all()) for t in eager)
    _assert_same(graphed, eager)
    assert n_graph == n_eager
    assert n_graph["tier_gemm"] == 12 * 120
    assert n_graph["tier_split"] == 3 * 120


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["matmul_bf16x3", "fused_bf16x3"])
def test_tier_cavity_on_gpu_matches_cpu_twin(cuda_device, tier):
    """100 fp32 steps of bf16x3 at 64^2 through cavity.solve on the kernel
    and on the CPU (the twin): within 1e-4 of max|psi|, the bound the smoke
    run holds bf16x3 to against fp32."""
    cfg = cavity.CavityConfig(nx=64, ny=64, dt=1e-3, t_final=0.1,
                              poisson=tier)
    got = cavity.solve(cfg, torch.float32, cuda_device)
    cpu = cavity.solve(cfg, torch.float32, "cpu")
    _assert_rel(got.s, cpu.s, 1e-4)
    _assert_rel(got.w, cpu.w, 1e-4)


# ------------------------------------------------ the user surface

def _nan_inputs(kernel, device):
    """(call) of a kernel wrapper on inputs holding one NaN."""
    if kernel == "euler_rhs":
        cfg = euler1d.EulerConfig(nx=1024)
        q = euler1d.sod_initial_state(cfg, torch.float32, device)[1]
        q = q.contiguous()
        q[1, 500] = float("nan")
        return lambda: cuda_kernels.euler_rhs_fused(q, cfg.gamma, cfg.dx,
                                                    "hllc")
    w, s = (torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in _fields((65, 65), seed=8))
    w[3, 4] = float("nan")
    return lambda: cuda_kernels.arakawa_rhs_fused(w, s, 1 / 64, 1 / 64,
                                                  100.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["euler_rhs", "arakawa_rhs"])
def test_nan_guard_names_the_kernel(cuda_device, kernel):
    """Under utils.debug.nan_guard a NaN fed to kernel 6 or kernel 1 raises
    FloatingPointError naming the kernel; outside it the same call returns
    its NaN."""
    from cfd_julia_torch.utils import debug

    call = _nan_inputs(kernel, cuda_device)
    assert bool(torch.isnan(call()).any())
    with debug.nan_guard():
        with pytest.raises(FloatingPointError,
                           match=f"NaN in the output of the {kernel} kernel"):
            call()
    assert not cuda_kernels.CHECK_NAN


@pytest.mark.cuda
def test_nan_guard_costs_nothing_when_off(cuda_device):
    """A graphed cavity run, the same run under the guard (eager, every
    launch checked) and the graphed run again after it (replays of the
    cached graphs): bitwise equal, with equal launch counts."""
    from cfd_julia_torch.utils import debug

    cfg = cavity.CavityConfig(nx=64, ny=64, dt=1e-3)
    step = cavity.make_step_fn(cfg, torch.float32, cuda_device)
    state = cavity.initial_state(cfg, torch.float32, cuda_device)

    def run():
        cuda_kernels.reset_launch_counts()
        out = loop.run_steps(step, state, 60)
        torch.cuda.synchronize()
        return (*out[0], out[1]), dict(cuda_kernels.LAUNCHES)

    first, n_first = run()
    with debug.nan_guard():
        guarded, n_guarded = run()
    again, n_again = run()
    _assert_same(guarded, first)
    _assert_same(again, first)
    assert n_first == n_guarded == n_again
    assert n_first["arakawa_rhs"] == 3 * 60


@pytest.mark.cuda
def test_order_heat_icp_on_gpu_matches_cpu(cuda_device, tmp_path, capsys):
    """`order heat --scheme icp` in fp64 on the card and on the CPU: errors
    within 1e-9 relative, or 1e-12 absolute where that is larger (the
    errors are differences of O(1) fields)."""
    from cfd_julia_torch import cli

    errs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        assert cli.main(["order", "heat", "--scheme", "icp", "--grids",
                         "20,40,80", "--outdir", str(out), "--device",
                         dev]) == 0
        errs[dev] = [float(line.split()[1]) for line in
                     (out / "order.txt").read_text().splitlines()
                     if not line.startswith("#")]
    capsys.readouterr()
    assert len(errs["cuda"]) == 3
    for g, c in zip(errs["cuda"], errs["cpu"]):
        assert abs(g - c) <= max(1e-9 * abs(c), 1e-12), (errs,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("split", [(513, 512), (512, 513), (343, 341, 341)])
def test_arakawa_kernel_on_halo_blocks(cuda_device, split, dtype):
    """Kernel 1 on a rank's 1-halo framed block of a 1025^2 field, ragged
    rank extents (1025 rows as 513 + 512, ...; columns as 517 + 508):
    against its twin on the block, and its interior against the kernel on
    the whole periodic field."""
    n = 1025
    w, s = _fields((n, n), seed=11)
    dx, dy = _spacing((n, n))
    wt, st, _ = interop.state_from_numpy(w, s, dtype, cuda_device)
    whole = cuda_kernels.arakawa_rhs_fused(wt, st, dx, dy, 100.0)
    framed = [F.pad(t[None], (1, 1, 1, 1), mode="circular")[0]
              for t in (wt, st)]
    r0 = 0
    for rows in split:
        c0 = 0
        for cols in (517, 508):
            wb, sb = (t[r0:r0 + rows + 2, c0:c0 + cols + 2].contiguous()
                      for t in framed)
            got = cuda_kernels.arakawa_rhs_fused(wb, sb, dx, dy, 100.0)
            _assert_rel(got, cuda_kernels.arakawa_rhs_fused_plain(
                wb, sb, dx, dy, 100.0), REL[dtype])
            _assert_rel(got[1:-1, 1:-1], whole[r0:r0 + rows, c0:c0 + cols],
                        REL[dtype])
            c0 += cols
        r0 += rows


@pytest.mark.cuda
def test_host_staged_exchange_is_bitwise_a_cpu_exchange(cuda_device):
    """Four ranks on the card over gloo: the host-staged halo exchanges
    (widths 1 and 2) and axis gathers of CUDA blocks equal the same calls
    on CPU blocks, and the periodic pad of the global field, bitwise."""
    results = launch.run(torch_parallel_ranks.staged_exchange, 4, "cuda",
                         args=((66, 68), 3))
    for rank, r in enumerate(results):
        assert r == {"staged": True, "halo1": True, "halo2": True,
                     "gather_x": True, "gather_y": True}, (rank, r)


# --------------------------------------- the vortex step's stage passes

# (nx, ny, band, rows of a slab or None, nb, scale, H stored column by
# column) of the derivative pass: ps23's band as its step runs it (H in
# torch.fft.rfft2's column-by-column order on the GPU, the inverse's
# 1/(nx ny) in the scale) and row by row, ps32's full width and scale,
# non-square both ways, a mesh rank's row slab (the band in the masks, all
# columns), an odd output plane (one value a thread) and the 2048^2 band
VORTEX_DERIVS = [(64, 64, True, None, 21, 1 / 4096, True),
                 (64, 64, True, None, 21, 1 / 4096, False),
                 (64, 64, False, None, 33, 2.25, True),
                 (48, 40, True, None, 13, 1 / 1920, True),
                 (48, 40, False, None, 21, 1.0, False),
                 (32, 48, True, (8, 16), 25, 1.0, False),
                 (3, 4, False, None, 3, 1.0, True),
                 (2048, 2048, True, None, 682, 2.0**-22, True)]


# launches a single-device step: the passes and, for ps23 and ps32, the
# inverse's cuFFT executions (ops/fft_plans.HalfInverse: ps23's kx
# transform one a field) and ps32's truncation
_PASSES = dict.fromkeys(("vortex_derivs_half", "vortex_product",
                         "vortex_cn_combine"), 3)
VORTEX_PLANNED = {"ps23": {**_PASSES, "fft_c2c": 12, "fft_c2r": 3},
                  "ps32": {**_PASSES, "fft_c2c": 3, "fft_c2r": 3,
                           "vortex_truncate_32": 3},
                  "hybrid": {"vortex_cn_combine": 3}}


def _complex_field(shape, dtype, seed, device):
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape), device=device)
    return z.to(torch.complex128 if dtype == torch.float64
                else torch.complex64)


def _kx_major(t):
    """t stored column by column, as torch.fft.rfft2 returns it here."""
    return t.mT.contiguous().mT


def _derivs_args(case, dtype, device):
    nx, ny, band, rows, nb, scale, kx = case
    cfg = vortex.VortexConfig(nx=nx, ny=ny, solver="ps23", dt=1e-3)
    rowk, colk = vortex._deriv_tables(cfg, dtype, device, band=band)
    H = _complex_field((nx, ny // 2 + 1), dtype, nx + ny, device)
    if rows is not None:
        H, rowk = H[slice(*rows)], rowk[slice(*rows)]
    return _kx_major(H) if kx else H, rowk, colk, nb, scale


def _assert_rel_any(got, ref, rel):
    """max|got - ref| <= rel max|ref|, real or complex."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


def _bitwise_pass(name, call, plain):
    """Two kernel calls and the twin, bitwise equal; two launches."""
    before = cuda_kernels.LAUNCHES[name]
    got, again = call(), call()
    assert cuda_kernels.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    _assert_same(got, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", VORTEX_DERIVS,
                         ids=[f"{c[0]}x{c[1]}-nb{c[4]}" +
                              ("-slab" if c[3] else "") +
                              ("-kx" if c[6] else "") for c in VORTEX_DERIVS])
def test_vortex_derivs_kernel_matches_plain(cuda_device, case, dtype):
    """Bitwise the twin; the spectra in H's memory order."""
    args = _derivs_args(case, dtype, cuda_device)
    _bitwise_pass("vortex_derivs_half",
                  lambda: cuda_kernels.vortex_derivs_half(*args),
                  lambda: cuda_kernels.vortex_derivs_half_plain(*args))
    assert cuda_kernels.vortex_derivs_half(*args).mT.is_contiguous() == \
        case[6]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2048, 2048), (3072, 3072), (48, 40),
                                   (3, 5), (1, 1)])
def test_vortex_product_kernel_matches_plain(cuda_device, shape, dtype):
    phys = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(
        (4, *shape)), dtype=dtype, device=cuda_device)
    _bitwise_pass("vortex_product", lambda: cuda_kernels.vortex_product(phys),
                  lambda: cuda_kernels.vortex_product_plain(phys))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("shape,rows,kx", [
    ((2048, 1025), None, True), ((2048, 1025), None, False),
    ((48, 21), None, True), ((3, 5), None, False), ((64, 33), (1, 17), False)],
    ids=["2048-kx", "2048", "48x21-kx", "3x5", "slab"])
def test_vortex_cn_combine_kernel_matches_plain(cuda_device, shape, rows, kx,
                                                stage, dtype):
    """Every operand row by row or every one column by column (kx); the
    slab's tables and spectra start one row in: off every 16-byte boundary
    (the one-value-a-thread path)."""
    rng = np.random.default_rng(shape[0] + stage)
    sl = slice(*rows) if rows else slice(None)
    order = _kx_major if kx else (lambda t: t)
    a, r, b = (order(torch.as_tensor(rng.uniform(0.5, 1.0, shape),
                                     dtype=dtype, device=cuda_device)[sl])
               for _ in range(3))
    h, j0, j1 = (order(_complex_field(shape, dtype, 5 + k, cuda_device)[sl])
                 for k in range(3))
    args = (a, h, r, j0, b, j1) if stage == 2 else (a, h, None, None, b, j1)
    _bitwise_pass("vortex_cn_combine",
                  lambda: cuda_kernels.vortex_cn_combine(*args),
                  lambda: cuda_kernels.vortex_cn_combine_plain(*args))
    assert cuda_kernels.vortex_cn_combine(*args).stride() == h.stride()


@pytest.mark.cuda
def test_vortex_passes_refuse_non_contiguous_constants(cuda_device):
    H, rowk, colk, nb, _ = _derivs_args(VORTEX_DERIVS[4], torch.float32,
                                        cuda_device)
    a = torch.ones((21, 48), device=cuda_device).t()
    before = dict(cuda_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.vortex_derivs_half(H, rowk.t().contiguous().t(), colk,
                                        nb)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.vortex_derivs_half(H, rowk, colk[::2], 10)
    with pytest.raises(ValueError, match="memory order"):
        cuda_kernels.vortex_cn_combine(a, H, None, None, a, H)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.vortex_product(torch.ones((4, 8, 8), device=cuda_device
                                               ).mT)
    with pytest.raises(ValueError, match="no gradient"):
        cuda_kernels.vortex_derivs_half(H, rowk.clone().requires_grad_(),
                                        colk, nb)
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.cuda
def test_vortex_pass_functions_match_twin_autograd(cuda_device):
    """Under grad the three passes are autograd Functions (their backward
    the *_backward_plain adjoints): the gradients of a loss through each
    against autograd of its twin, fp64, rel 1e-12."""
    f64 = torch.float64
    H, rowk, colk, nb, _ = _derivs_args(VORTEX_DERIVS[0], f64, cuda_device)
    phys = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (4, 64, 64)), dtype=f64, device=cuda_device)
    tables = [torch.rand(H.shape, dtype=f64, device=cuda_device)
              for _ in range(3)]
    j0, j1 = (_complex_field(H.shape, f64, 9 + k, cuda_device)
              for k in range(2))
    G = _complex_field((4, 64, nb), f64, 3, cuda_device)
    Gh = _complex_field(H.shape, f64, 4, cuda_device)
    Gp = torch.rand((64, 64), dtype=f64, device=cuda_device)
    for kernel, plain, inputs, cot in [
            (lambda x: cuda_kernels.vortex_derivs_half(x, rowk, colk, nb),
             lambda x: cuda_kernels.vortex_derivs_half_plain(x, rowk, colk,
                                                             nb), (H,), G),
            (cuda_kernels.vortex_product, cuda_kernels.vortex_product_plain,
             (phys,), Gp),
            (lambda h, x, y: cuda_kernels.vortex_cn_combine(
                tables[0], h, tables[1], x, tables[2], y),
             lambda h, x, y: cuda_kernels.vortex_cn_combine_plain(
                tables[0], h, tables[1], x, tables[2], y),
             (H.contiguous(), j0, j1), Gh)]:
        got, want = [], []
        for fn, out in ((kernel, got), (plain, want)):
            xs = [t.clone().requires_grad_() for t in inputs]
            out.extend(torch.autograd.grad(fn(*xs), xs, cot))
        for g, w in zip(got, want):
            _assert_rel_any(g, w, 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,ny", [(64, 64), (48, 40)])
@pytest.mark.parametrize("solver", ["ps23", "ps32", "hybrid"])
def test_spectral_kernel_step_matches_twin_step(cuda_device, solver, nx, ny,
                                                dtype):
    """Three half steps on the stage kernels against three on their twins
    (rhs_impl="torch"), which launch none; the kernels 3 launches a step
    of each pass and of each of the inverse's cuFFT plans (ps32 also the
    truncation; hybrid: the combine alone)."""
    cfg = vortex.VortexConfig(nx=nx, ny=ny, solver=solver, dt=1e-3)
    w0 = vortex.initial_vorticity(cfg, dtype, cuda_device)
    out = {}
    for impl in ("kernel", "torch"):
        step = vortex.make_spectral_step_half(
            dataclasses.replace(cfg, rhs_impl=impl), dtype, cuda_device)
        cuda_kernels.reset_launch_counts()
        H = vortex.half_init(w0)
        for _ in range(3):
            H = step(H)
        out[impl] = (H, {k: v for k, v in cuda_kernels.LAUNCHES.items()
                         if v})
    assert out["kernel"][1] == {k: 3 * n for k, n in
                                VORTEX_PLANNED[solver].items()}
    assert out["torch"][1] == {}
    _assert_rel_any(out["kernel"][0], out["torch"][0], REL[dtype])


# ------------------------- the half-spectrum inverse on the port's cuFFT plans

# (nx, ny, solver, H stored column by column) of the planned inverse: the
# north-star 2048^2 grids, small ones, an odd buffer row count (ps23 at
# 33 rows: one value a thread) and H row by row
VORTEX_PLANNED_CASES = [(2048, 2048, "ps23", True), (2048, 2048, "ps32", True),
                        (64, 64, "ps23", True), (64, 64, "ps32", False),
                        (33, 48, "ps23", False), (48, 40, "ps32", True)]
_PLANNED_IDS = [f"{c[2]}-{c[0]}x{c[1]}" + ("-kx" if c[3] else "")
                for c in VORTEX_PLANNED_CASES]


def _planned_inputs(case, dtype, device, seed=0):
    """(H, the derivative pass's buffer-mode arguments, the inverse): the
    step's own nb, scale, cols, pad rows and HalfInverse.  H is the half
    spectrum of a real field, as the step's are (the inverse's c2r reads
    its input as Hermitian: a random ky = 0 column would make the two
    libraries' c2r results differ by its imaginary part)."""
    nx, ny, solver, kx = case
    cfg = vortex.VortexConfig(nx=nx, ny=ny, solver=solver, dt=1e-3)
    hy = ny // 2 + 1
    H = torch.fft.rfft2(torch.as_tensor(
        np.random.default_rng(nx + ny + seed).standard_normal((nx, ny)),
        dtype=dtype, device=device))
    H = _kx_major(H) if kx else H.contiguous()
    rowk, colk = vortex._deriv_tables(cfg, dtype, device,
                                      band=solver == "ps23")
    if solver == "ps23":
        nb = ((2 * ny) // 3) // 2
        inv = fft_plans.HalfInverse(4, nx, ny, nb, dtype, device,
                                    ky_fastest=True)
        # the aligned row pitch: the pass writes it whole
        kw = dict(nb=nb, scale=1.0 / (nx * ny), cols=inv.buffer.shape[-1],
                  pad_rows=0, ky_fastest=True)
    else:
        nxe, nye = 3 * nx // 2, 3 * ny // 2
        kw = dict(nb=ny // 2, scale=2.25 / (nxe * nye), cols=nye // 2 + 1,
                  pad_rows=nxe - nx)
        inv = fft_plans.HalfInverse(4, nxe, nye, ny // 2, dtype, device)
    return H, (rowk, colk), kw, inv


@pytest.mark.cuda
def test_one_cufft_is_mapped(cuda_device):
    """The kernel library's cuFFT is the one PyTorch loaded: the process
    maps one libcufft file."""
    _cuda_build.load_library()
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f
                 if re.search(r"/libcufft\.so", line)}
    assert len(paths) == 1, paths
    assert fft_plans.version() > 0


@pytest.mark.cuda
def test_cufft_errors_raise_with_their_code(cuda_device):
    """A plan made and destroyed; a second destruction, and a layout
    cuFFT refuses, raise with cuFFT's code."""
    layout = fft_plans.Layout(fft_plans.C2R, 16, 3, 1, 9, 1, 16)
    p = fft_plans.Plan(layout, torch.float32, cuda_device)
    assert p.work.device.type == "cuda"
    p.destroy()
    with pytest.raises(RuntimeError, match="cuFFT plan destruction failed"):
        p.destroy()
    with pytest.raises(RuntimeError, match="cuFFT plan creation"):
        fft_plans.Plan(dataclasses.replace(layout, istride=0), torch.float32,
                       cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", VORTEX_PLANNED_CASES, ids=_PLANNED_IDS)
def test_vortex_derivs_buffer_mode_matches_plain(cuda_device, case, dtype):
    """The buffer mode bitwise its twin, into a new buffer and into a
    caller's buffer full of NaN (every element written)."""
    H, (rowk, colk), kw, inv = _planned_inputs(case, dtype, cuda_device)
    _bitwise_pass("vortex_derivs_half",
                  lambda: cuda_kernels.vortex_derivs_half(H, rowk, colk,
                                                          **kw),
                  lambda: cuda_kernels.vortex_derivs_half_plain(H, rowk,
                                                                colk, **kw))
    inv.buffer.fill_(float("nan"))
    got = cuda_kernels.vortex_derivs_half(H, rowk, colk, **kw,
                                          out=inv.buffer)
    assert got is inv.buffer
    _assert_same(got, cuda_kernels.vortex_derivs_half_plain(H, rowk, colk,
                                                            **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", VORTEX_PLANNED_CASES, ids=_PLANNED_IDS)
def test_half_inverse_plans_match_plain(cuda_device, case, dtype):
    """Each plan of the inverse against its plain version on the same
    buffer (1e-5 of max in fp32, 1e-13 in fp64), the inverse against the
    twin route's transform (irfft2_band, irfft2 of pad_32_half), two
    executions bitwise equal, and a launch counted per execution."""
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    H, (rowk, colk), kw, inv = _planned_inputs(case, dtype, cuda_device)
    spec = cuda_kernels.vortex_derivs_half(H, rowk, colk, **kw)
    x, want = spec.clone(), spec.clone()
    before = dict(cuda_kernels.LAUNCHES)
    parts = range(4) if inv.ky_fastest else [slice(None)]
    for k in parts:
        fft_plans.execute(inv.c2c, x[k], x[k])
        fft_plans.execute_plain(inv.c2c, want[k], want[k])
    _assert_rel_any(x, want, tol)
    out = torch.empty_like(inv.out)
    fft_plans.execute(inv.c2r, x.clone(), out)
    _assert_rel_any(out, fft_plans.execute_plain(inv.c2r, x, inv.out.clone()),
                    tol)
    assert cuda_kernels.LAUNCHES["fft_c2c"] == before["fft_c2c"] + len(parts)
    assert cuda_kernels.LAUNCHES["fft_c2r"] == before["fft_c2r"] + 1
    first = inv(spec.clone()).clone()
    assert torch.equal(inv(spec.clone()), first)
    nx, ny, solver, _ = case
    planes = cuda_kernels._from_buffer(spec, nx, kw["nb"], kw["pad_rows"],
                                       inv.ky_fastest)
    if solver == "ps23":
        ref = spectral.irfft2_band(planes, nx, ny, norm="forward")
    else:
        nxe, nye = 3 * nx // 2, 3 * ny // 2
        ref = spectral.irfft2(spectral.pad_32_half(
            torch.cat([planes, planes.new_zeros((4, nx, 1))], -1), ny, nxe,
            nye), nxe, nye, norm="forward")
    _assert_rel_any(first, ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["ps23", "ps32"])
def test_half_inverse_two_stages_on_one_buffer(cuda_device, solver):
    """Two stages back to back on the inverse's own buffers (the c2r may
    overwrite its input; the pass rewrites all of it) against the same
    second stage on new buffers: bitwise."""
    case = (64, 64, solver, True)
    H0, (rowk, colk), kw, inv = _planned_inputs(case, torch.float32,
                                                cuda_device)
    H1 = _planned_inputs(case, torch.float32, cuda_device, seed=1)[0]
    for H in (H0, H1):
        got = inv(cuda_kernels.vortex_derivs_half(H, rowk, colk, **kw,
                                                  out=inv.buffer)).clone()
    fresh = _planned_inputs(case, torch.float32, cuda_device)[3]
    want = fresh(cuda_kernels.vortex_derivs_half(H1, rowk, colk, **kw,
                                                 out=fresh.buffer))
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["ps23", "ps32"])
def test_half_inverse_graph_replay_equals_eager(cuda_device, solver):
    """The pass and both plans captured in a CUDA graph: each replay on
    new spectra bitwise the eager call."""
    case = (64, 64, solver, True)
    H, (rowk, colk), kw, inv = _planned_inputs(case, torch.float32,
                                               cuda_device)

    def run():
        return inv(cuda_kernels.vortex_derivs_half(H, rowk, colk, **kw,
                                                   out=inv.buffer))

    run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = run()
    for seed in (2, 3):
        H.copy_(_planned_inputs(case, torch.float32, cuda_device, seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        captured = out.clone()
        _assert_same(captured, run())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,ny", [(2048, 2048), (64, 64), (48, 40)])
def test_vortex_truncate_kernel_matches_plain(cuda_device, nx, ny, dtype):
    """Kernel 12 bitwise its twin: rfft2's 3/2-grid output column by
    column and row by row, the table (and so the result) either way."""
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    jf = torch.fft.rfft2(torch.as_tensor(np.random.default_rng(nx).
                                         standard_normal((nxe, nye)),
                                         dtype=dtype, device=cuda_device))
    cfg = vortex.VortexConfig(nx=nx, ny=ny, solver="ps32", dt=1e-3)
    table = vortex._half_consts(cfg, dtype, cuda_device)[3] / 2.25
    for j in (jf, jf.contiguous(), _kx_major(jf)):
        for t in (table, _kx_major(table)):
            _bitwise_pass("vortex_truncate_32",
                          lambda: cuda_kernels.vortex_truncate_32(j, t),
                          lambda: cuda_kernels.vortex_truncate_32_plain(j, t))
            assert cuda_kernels.vortex_truncate_32(j, t).stride() == \
                t.stride()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(48, 40, "ps32", True),
                                  (64, 64, "ps23", True)],
                         ids=["ps32", "ps23"])
def test_planned_functions_match_twin_autograd(cuda_device, case):
    """Under grad the buffer mode, the inverse and the truncation are
    autograd Functions: their gradients against autograd of the twins,
    fp64, rel 1e-12."""
    f64 = torch.float64
    nx, ny = case[:2]
    H, (rowk, colk), kw, inv = _planned_inputs(case, f64, cuda_device)
    jf = _complex_field((3 * nx // 2, 3 * ny // 4 + 1), f64, 7, cuda_device)
    table = torch.rand((nx, ny // 2 + 1), dtype=f64, device=cuda_device)
    G = torch.rand(inv.out.shape, dtype=f64, device=cuda_device)
    Gt = _complex_field(table.shape, f64, 8, cuda_device)
    for kernel, plain, x, cot in [
            (lambda h: inv(cuda_kernels.vortex_derivs_half(h, rowk, colk,
                                                           **kw)),
             lambda h: fft_plans.half_inverse_plain(
                 cuda_kernels.vortex_derivs_half_plain(h, rowk, colk, **kw),
                 inv.n, inv.nb, inv.ky_fastest),
             H, G),
            (lambda j: cuda_kernels.vortex_truncate_32(j, table),
             lambda j: cuda_kernels.vortex_truncate_32_plain(j, table),
             jf, Gt)]:
        grads = []
        for fn in (kernel, plain):
            xs = x.clone().requires_grad_()
            grads.extend(torch.autograd.grad(fn(xs), xs, cot))
        _assert_rel_any(grads[0], grads[1], 1e-12)
