"""cfd_julia_torch dense sine-matmul Dirichlet Poisson solve vs
cfd_julia_tpu, on the same seeded numpy inputs."""
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
