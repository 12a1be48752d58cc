"""The port's utils/debug.py against cfd_julia_tpu/utils/debug.py on the
CPU: check_finite's exception and path text as JAX's on the same trees;
nan_guard raising at a NaN-making torch call and naming it, keeping views
and allocations unchecked, restoring its flag, making the loop layer run
eagerly, and leaving runs that make no NaN unchanged bit for bit.  The
kernels' own check under the guard needs the GPU (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch.models import cavity, euler1d, heat1d, poisson2d
from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.stepping import loop
from cfd_julia_torch.utils import debug
from cfd_julia_tpu.utils import debug as jdebug

torch.set_num_threads(1)

NAN, INF = float("nan"), float("inf")


def _trees(lib):
    """The same nested trees of arrays in both packages."""
    a = lambda *v: lib(np.array(v, dtype=np.float32))
    return [
        {"w": a(1.0, NAN)},
        (a(1.0), a(INF)),
        {"s": a(0.0), "a": (a(1.0), [a(2.0), a(-INF)])},
        [a(1.0), {"z": 1.0, "q": NAN}],
        {"b": a(NAN), "a": a(NAN)},          # sorted keys: 'a' first
        ((a(1.0),), {"k": [a(0.0), a(1.0, 2.0, NAN)]}),
    ]


@pytest.mark.parametrize("k", range(6))
def test_check_finite_names_the_leaf_as_jax(k):
    jtree = _trees(jnp.asarray)[k]
    ttree = _trees(torch.as_tensor)[k]
    with pytest.raises(FloatingPointError) as je:
        jdebug.check_finite(jtree, "state")
    with pytest.raises(FloatingPointError) as te:
        debug.check_finite(ttree, "state")
    assert str(te.value) == str(je.value)


def test_check_finite_passes_finite_trees():
    tree = {"w": torch.ones(3), "n": (torch.arange(4), 2, None),
            "c": torch.ones(2, dtype=torch.complex64)}
    assert debug.check_finite(tree) is tree
    jtree = {"w": jnp.ones(3), "n": (jnp.arange(4), 2, None)}
    assert jdebug.check_finite(jtree) is jtree


def test_nan_guard_raises_at_the_nan_making_call():
    x = torch.tensor([0.0, 1.0])
    z = torch.tensor([NAN, 0.0], dtype=torch.complex64)
    with debug.nan_guard():
        assert cuda_kernels.CHECK_NAN
        y = x * 2.0                          # finite: no raise
        with pytest.raises(FloatingPointError, match="torch.Tensor.div"):
            x / x
        with pytest.raises(FloatingPointError, match="torch.log"):
            torch.log(x - 1.0)
        with pytest.raises(FloatingPointError, match="torch.fft.ifft"):
            torch.fft.ifft(z)
    assert not cuda_kernels.CHECK_NAN
    assert torch.equal(y, torch.tensor([0.0, 2.0]))
    # outside the guard the same call returns its NaN
    assert torch.isnan(x / x).any()


def test_nan_guard_leaves_views_and_allocations_alone():
    """A view holds values another call made, and an allocation or a NaN
    fill (the iterative solves' history sentinel) computes nothing."""
    v = torch.tensor([NAN, 1.0])
    with debug.nan_guard():
        v.reshape(2, 1)
        v[:1]
        torch.full((3,), NAN)
        torch.empty(4)
        with pytest.raises(FloatingPointError, match="torch.Tensor.add"):
            v + 1.0                       # arithmetic on a NaN input


def test_nan_guard_restores_its_flag_and_nests():
    with pytest.raises(FloatingPointError):
        with debug.nan_guard():
            torch.tensor([0.0]) / 0.0
    assert not cuda_kernels.CHECK_NAN
    with debug.nan_guard():
        with debug.nan_guard(False):
            assert cuda_kernels.CHECK_NAN   # off does not lift an outer on
            torch.tensor([0.0]) * 0.0
        assert cuda_kernels.CHECK_NAN
    assert not cuda_kernels.CHECK_NAN


class _CudaLike:
    """Stands for a CUDA tensor in the loop's runner choice: on the CPU
    the runner is eager whatever `graph` says."""
    device = torch.device("cuda")


def test_nan_guard_makes_the_loop_eager():
    state = _CudaLike()
    with debug.nan_guard():
        assert isinstance(loop._runner(lambda s: s, state, graph=True),
                          loop._Eager)
    with pytest.raises(AttributeError):     # outside it: the graphed runner
        loop._runner(lambda s: s, state, graph=True)


def test_runs_under_the_guard_are_unchanged():
    """Whole solves that make no NaN (the multigrid solve's NaN-filled
    history included) run under the guard bit for bit as outside it."""
    runs = [
        lambda: poisson2d.solve(poisson2d.PoissonConfig(
            nx=32, ny=32, solver="multigrid", problem="poly"),
            device="cpu").u,
        lambda: cavity.solve(cavity.CavityConfig(nx=16, ny=16, t_final=0.02),
                             device="cpu").s,
        lambda: euler1d.solve(euler1d.EulerConfig(nx=64, t_final=0.02),
                              device="cpu").q,
    ]
    for run in runs:
        ref = run()
        with debug.nan_guard():
            got = run()
        assert torch.equal(got, ref)


def test_nan_guard_stops_a_run_that_makes_a_nan():
    """An FTCS heat run far past its stability limit (beta ~ 650) grows to
    inf within a few steps and then makes NaN (inf - inf): the guard stops
    it at that call, which the unguarded run carries into its result."""
    cfg = heat1d.HeatConfig(scheme="ftcs", dt=1.0, t_final=40.0)
    step = heat1d.make_step_fn(cfg, device="cpu")
    u0 = heat1d.initial_condition(cfg, torch.float32, "cpu")[1]
    assert torch.isnan(loop.advance(step, u0, cfg.nt)).any()
    with debug.nan_guard():
        with pytest.raises(FloatingPointError, match="NaN in the output of"):
            loop.advance(step, u0, cfg.nt)
