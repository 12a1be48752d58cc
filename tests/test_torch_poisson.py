"""cfd_julia_torch direct Poisson solves (dense sine-matmul, rfft DST-I,
periodic FFT) vs cfd_julia_tpu, on the same seeded numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.ops import arakawa
from cfd_julia_torch.poisson import direct
from cfd_julia_tpu.poisson import direct as jax_direct

torch.set_num_threads(1)

_DTYPES = {"fp32": (torch.float32, jnp.float32, 3e-7),
           "fp64": (torch.float64, jnp.float64, 1e-15)}


def _assert_rel(got, ref, rel):
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
@pytest.mark.parametrize("n", [64, 1024])
def test_sine_entries_match_jax(n, dtype):
    """Interior DST-I entries; fp32 atol covers an ulp of sin's own
    rounding in the two libraries (the arguments are bit-identical)."""
    tdt, jdt, atol = _DTYPES[dtype]
    k = np.arange(1, n, dtype=np.int32)
    ref = np.asarray(jax_direct._sine_entries(
        jnp.asarray(k)[:, None], jnp.asarray(k)[None, :], n, jdt))
    kt = torch.as_tensor(k)
    got = direct._sine_entries(kt[:, None], kt[None, :], n, tdt).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
@pytest.mark.parametrize("n", [64, 1024])
def test_sine_matrix_matches_jax(n, dtype):
    tdt, jdt, atol = _DTYPES[dtype]
    ref = np.asarray(jax_direct.sine_matrix(n, n + 3, jdt))
    got = direct.sine_matrix(n, n + 3, tdt).numpy()
    assert got.shape == ref.shape == (n + 3, n + 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert not got[n:].any() and not got[:, n:].any()


def test_sine_entries_fp32_period_reduced():
    """The int period reduction keeps fp32 entries within ~3e-7 of the
    exact values at n=1024 (an unreduced fp32 argument is off by ~3e-4)."""
    n = 1024
    k = torch.arange(1, n, dtype=torch.int32)
    got = direct._sine_entries(k[:, None], k[None, :], n, torch.float32)
    kk = np.arange(1, n, dtype=np.float64)
    exact = np.sin(np.pi * np.outer(kk, kk) / n)
    assert np.abs(got.double().numpy() - exact).max() < 1e-6


@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 16)])
def test_solve_matches_jax_matmul(nx, ny):
    f = np.random.default_rng(0).standard_normal((nx + 1, ny + 1))
    dx, dy = 1.0 / nx, 1.0 / ny
    ref = np.asarray(jax_direct.solve_fst_matmul_interior(
        jnp.asarray(f), nx, ny, dx, dy))
    ft, _, _ = interop.state_from_numpy(f, f, torch.float64, "cpu")
    got = interop.to_numpy(
        direct.solve_fst_matmul_interior(ft, nx, ny, dx, dy))
    _assert_rel(got, ref, 1e-12)


@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 16)])
def test_solve_matches_jax_rfft_dst(nx, ny):
    """Against the JAX package's rfft DST-I solve: the same eigenvalues
    and normalisation by another transform."""
    f = np.random.default_rng(1).standard_normal((nx + 1, ny + 1))
    dx, dy = 1.0 / nx, 1.0 / ny
    ref = np.asarray(jax_direct.solve_fst(jnp.asarray(f), dx, dy))
    ft, _, _ = interop.state_from_numpy(f, f, torch.float64, "cpu")
    got = interop.to_numpy(
        direct.solve_fst_matmul_interior(ft, nx, ny, dx, dy))
    _assert_rel(got, ref, 1e-11)


@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 16)])
def test_solve_satisfies_discrete_poisson(nx, ny):
    """The factory's solve: lap(u) = f on the interior, u = 0 on the
    walls, and repeated solves reuse the same matrices."""
    dx, dy = 1.0 / nx, 1.0 / ny
    solve = direct.make_fst_matmul_interior(nx, ny, dx, dy, torch.float64)
    rng = np.random.default_rng(2)
    for _ in range(2):
        f = torch.as_tensor(rng.standard_normal((nx + 1, ny + 1)))
        u = solve(f)
        assert u.shape == f.shape
        assert not u[0].any() and not u[-1].any()
        assert not u[:, 0].any() and not u[:, -1].any()
        lap = arakawa.laplacian(u, dx, dy)[1:-1, 1:-1]
        _assert_rel(lap.numpy(), f[1:-1, 1:-1].numpy(), 1e-11)


@pytest.mark.parametrize("impl", ["rfft", "half"])
@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 16), (33, 47)])
def test_solve_fst_matches_jax(nx, ny, impl):
    """The DST-I solve through rfft (both transform lengths) against the
    JAX package's with the same impl; 1e-12 of the scale.  The boundary
    ring is exactly zero, and the factory's solve is the same."""
    f = np.random.default_rng(3).standard_normal((nx + 1, ny + 1))
    dx, dy = 1.0 / nx, 1.0 / ny
    ref = np.asarray(jax_direct.solve_fst(jnp.asarray(f), dx, dy, impl=impl))
    ft = interop.field_from_numpy(f, torch.float64, "cpu")
    got = direct.solve_fst(ft, dx, dy, impl=impl)
    _assert_rel(interop.to_numpy(got), ref, 1e-12)
    assert not got[0].any() and not got[-1].any()
    assert not got[:, 0].any() and not got[:, -1].any()
    again = direct.make_fst(nx, ny, dx, dy, torch.float64, impl=impl)(ft)
    assert torch.equal(again, got)
    lap = arakawa.laplacian(got, dx, dy)[1:-1, 1:-1]
    _assert_rel(lap.numpy(), f[1:-1, 1:-1], 1e-10)


@pytest.mark.parametrize("eigen", ["fdm", "spectral"])
@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 16), (33, 47)])
def test_solve_fft_matches_jax(nx, ny, eigen):
    """The periodic solve on the (nx+1, ny+1) node grid with wrapped
    edges; 1e-12 of the scale."""
    f = np.random.default_rng(4).standard_normal((nx + 1, ny + 1))
    f[-1, :] = f[0, :]
    f[:, -1] = f[:, 0]
    dx, dy = 1.0 / nx, 1.0 / ny
    ref = np.asarray(jax_direct.solve_fft(jnp.asarray(f), dx, dy,
                                          eigen=eigen))
    ft = interop.field_from_numpy(f, torch.float64, "cpu")
    got = direct.solve_fft(ft, dx, dy, eigen=eigen)
    assert got.shape == ft.shape
    _assert_rel(interop.to_numpy(got), ref, 1e-12)
    assert torch.equal(got[-1], got[0]) and torch.equal(got[:, -1], got[:, 0])
    again = direct.make_fft(nx, ny, dx, dy, torch.float64, eigen=eigen)(ft)
    assert torch.equal(again, got)


def test_solve_fst_unknown_impl_raises():
    with pytest.raises(ValueError, match="DST impl"):
        direct.solve_fst(torch.zeros(9, 9), 0.1, 0.1, impl="matmul")
    with pytest.raises(ValueError, match="eigenvalue mode"):
        direct.solve_fft(torch.zeros(9, 9), 0.1, 0.1, eigen="fem")
