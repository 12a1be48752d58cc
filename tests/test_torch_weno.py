"""cfd_julia_torch WENO-5 reconstruction vs cfd_julia_tpu, in fp64.

The same seeded numpy lines go through both packages; the only admissible
difference is the order of floating-point operations (rtol 1e-13).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.ops import weno
from cfd_julia_tpu.ops import weno as jax_weno

torch.set_num_threads(1)

RTOL = 1e-13
BCS = ["periodic", "extrapolate", "mirror"]
SHAPES = [(5,), (16,), (33,), (3, 5), (3, 16), (3, 33)]


def _line(shape, seed):
    return np.random.default_rng(seed).uniform(0.1, 2.0, shape)


def _close(got, ref):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(ref),
                               rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("n", [5, 16, 33])
def test_weno5_pointwise_matches_jax(side, n):
    vs = [_line((n,), seed) for seed in range(5)]
    mine = getattr(weno, f"weno5_{side}")(*(torch.tensor(v) for v in vs))
    ref = getattr(jax_weno, f"weno5_{side}")(*(jnp.asarray(v) for v in vs))
    _close(mine, ref)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("side", ["left", "right"])
def test_reconstruct_matches_jax(side, bc, shape):
    u = _line(shape, seed=len(shape) * 100 + shape[-1])
    mine = getattr(weno, f"reconstruct_{side}")(torch.tensor(u), bc)
    ref = getattr(jax_weno, f"reconstruct_{side}")(jnp.asarray(u), bc)
    assert tuple(mine.shape) == ref.shape
    _close(mine, ref)


@pytest.mark.parametrize("bc,n_out", [("periodic", 0), ("extrapolate", -1),
                                      ("mirror", 1)])
def test_output_lengths(bc, n_out):
    u = torch.tensor(_line((3, 16), seed=7))
    for fn in (weno.reconstruct_left, weno.reconstruct_right):
        assert fn(u, bc).shape == (3, 16 + n_out)


def test_mirror_ghosts_are_the_index_map():
    """The mirror pads are the map i < 0 -> -i-1, i >= n -> 2n-1-i: the L
    line holds cells -3..n+1 and the R line cells -2..n+2."""
    n = 7
    u = torch.arange(n, dtype=torch.float64)

    def mirror(i):
        return -i - 1 if i < 0 else (2 * n - 1 - i if i >= n else i)

    gl, _ = weno._PADS[("mirror", "L")](u)
    gr, _ = weno._PADS[("mirror", "R")](u)
    assert gl.tolist() == [float(mirror(i)) for i in range(-3, n + 2)]
    assert gr.tolist() == [float(mirror(i)) for i in range(-2, n + 3)]


def test_constant_line_is_exact():
    """WENO-5 reproduces a constant exactly in every closure."""
    u = torch.full((3, 12), 0.75, dtype=torch.float64)
    for bc in BCS:
        for fn in (weno.reconstruct_left, weno.reconstruct_right):
            assert torch.allclose(fn(u, bc), torch.full_like(fn(u, bc), 0.75),
                                  rtol=0, atol=1e-15)
