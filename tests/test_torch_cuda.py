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
import re

import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.models import cavity, euler1d, poisson2d
from cfd_julia_torch.ops import _cuda_build, cuda_kernels
from cfd_julia_torch.poisson import multigrid
from cfd_julia_torch.stepping import loop

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
                                   (3, 2), (65, 33), (1023, 31)])
def test_arakawa_kernel_matches_plain(cuda_device, shape, dtype):
    """The periodic RHS against its twin, and a second call bitwise; the
    ragged shapes end in part-filled blocks on both axes, and with 1 or 2
    columns the periodic neighbours alias."""
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
