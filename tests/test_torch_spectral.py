"""cfd_julia_torch spectral primitives vs cfd_julia_tpu.

The same seeded numpy fields (generic, non-symmetric, at even and odd
sizes) go through each function of cfd_julia_tpu/ops/spectral.py and its
namesake in the port, in fp64, where the only admissible difference is
the FFT library's operation order: 1e-12 of the result's scale.  DST-I is
also held against scipy.fft.dst(type=1), and the half-spectrum dealiasing
moves against the full-spectrum ones on the Hermitian mirror.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import spectral
from cfd_julia_tpu.core import precision as jax_precision
from cfd_julia_tpu.ops import spectral as jax_spectral

torch.set_num_threads(1)

SHAPES = [(48, 40), (33, 47), (16, 16)]
REL = 1e-12


def _field(shape, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if complex_ else a


def _t(a):
    return interop.field_from_numpy(a, torch.float64, "cpu")


def _assert_rel(got, ref, rel=REL):
    got = interop.to_numpy(got) if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, ref.shape, got.dtype, ref.dtype)
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-300), \
        (err, np.abs(ref).max())


# ------------------------------------------------------------ transforms

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["fft2", "ifft2", "rfft2"])
def test_transforms_match_jax(name, shape):
    a = _field(shape, 1, complex_=name != "rfft2")
    _assert_rel(getattr(spectral, name)(_t(a)),
                getattr(jax_spectral, name)(jnp.asarray(a)))


@pytest.mark.parametrize("shape", SHAPES)
def test_irfft2_inverts_rfft2_and_matches_jax_pair(shape):
    """irfft2 of two half spectra against the JAX package's one complex
    inverse of the packed Hermitian pair."""
    a, b = _field(shape, 2), _field(shape, 3)
    nx, ny = shape
    H = spectral.rfft2(_t(np.stack([a, b])))
    got = spectral.irfft2(H, nx, ny)
    _assert_rel(got, np.stack([a, b]))
    ra, rb = jax_spectral.ifft2_pair(jnp.fft.fft2(jnp.asarray(a)),
                                     jnp.fft.fft2(jnp.asarray(b)))
    _assert_rel(got, np.stack([ra, rb]))


def test_complex_for():
    assert spectral.complex_for(torch.float64) == torch.complex128
    assert spectral.complex_for(torch.float32) == torch.complex64
    assert interop.field_from_numpy(_field((3, 3), 0, True), torch.float32
                                    ).dtype == torch.complex64


def test_complex_dtype_matches_jax():
    """core.precision.complex_dtype, the JAX package's complex_dtype: the
    complex type of a real one, of the default (fp32) for None."""
    for real, jreal in [(torch.float32, jnp.float32),
                        (torch.float64, jnp.float64)]:
        got = precision.complex_dtype(real)
        want = np.dtype(jax_precision.complex_dtype(jreal))
        assert torch.empty(0, dtype=got).numpy().dtype == want
        assert spectral.complex_for(real) == got
    assert precision.complex_dtype() == torch.complex64
    assert np.dtype(jax_precision.complex_dtype(jnp.float32)) == np.complex64


@pytest.mark.parametrize("shape", SHAPES)
def test_zero_mean_mode_matches_jax(shape):
    e = _field((2, *shape), 4, complex_=True)
    te = _t(e)
    got = spectral.zero_mean_mode(te)
    _assert_rel(got, jax_spectral.zero_mean_mode(jnp.asarray(e)), 0.0)
    assert got[0, 0, 0] == 0 and te[0, 0, 0] != 0      # a copy


@pytest.mark.parametrize("n,dx", [(48, 0.1), (33, 2 * np.pi / 33),
                                  (2048, 2 * np.pi / 2048)])
@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
def test_wavenumbers_are_jax_bits(n, dx, dtype):
    """Built in fp64 with numpy and cast: the same bits as the JAX
    package's constants, fp32 included."""
    tdt, ndt = {"fp32": (torch.float32, np.float32),
                "fp64": (torch.float64, np.float64)}[dtype]
    for got, ref in [
        (spectral.fft_wavenumber_index(n, dx, tdt),
         jax_spectral.fft_wavenumber_index(n, dx, ndt)),
        (spectral.rfft_wavenumber_index(n, dx, tdt),
         jax_spectral.rfft_wavenumber_index(n, dx, ndt)),
    ]:
        assert got.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(got.numpy(), ref)
    if n < 100:
        got = spectral.wavespace(n, n - 1, dx, 0.7 * dx, tdt).numpy()
        ref = jax_spectral.wavespace(n, n - 1, dx, 0.7 * dx, ndt)
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------- periodic Poisson

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eigen", ["fdm", "spectral"])
def test_fft_poisson_periodic_matches_jax(eigen, shape):
    f = _field(shape, 5)
    dx, dy = 1.0 / shape[0], 1.3 / shape[1]
    ref = jax_spectral.fft_poisson_periodic(jnp.asarray(f), dx, dy, eigen)
    _assert_rel(spectral.fft_poisson_periodic(_t(f), dx, dy, eigen), ref)
    # the factory's solve, reused on a second field
    solve = spectral.make_fft_poisson_periodic(*shape, dx, dy, torch.float64,
                                               eigen=eigen)
    _assert_rel(solve(_t(f)), ref)
    g = _field(shape, 6)
    _assert_rel(solve(_t(g)), jax_spectral.fft_poisson_periodic(
        jnp.asarray(g), dx, dy, eigen))


@pytest.mark.parametrize("eigen", ["fdm", "spectral"])
def test_fft_poisson_periodic_fp32_mean_mode_guard(eigen):
    """cos(1e-6) == 1 in fp32, so den[0,0] = 0 without the guard: the
    solve must stay finite, with a zero mean, close to the fp64 one."""
    f = _field((32, 32), 7)
    got = spectral.fft_poisson_periodic(
        torch.as_tensor(f, dtype=torch.float32), 0.1, 0.1, eigen)
    ref = spectral.fft_poisson_periodic(_t(f), 0.1, 0.1, eigen)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert abs(float(got.mean())) < 1e-6 * float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) \
        < 1e-5 * float(ref.abs().max())


def test_fft_poisson_unknown_eigen_and_shape_raise():
    with pytest.raises(ValueError, match="eigenvalue mode"):
        spectral.fft_poisson_periodic(torch.zeros(8, 8), 1.0, 1.0, "fem")
    solve = spectral.make_fft_poisson_periodic(8, 8, 1.0, 1.0, torch.float64)
    with pytest.raises(ValueError, match="built for"):
        solve(torch.zeros(8, 6, dtype=torch.float64))


# ----------------------------------------------------------------- DST-I

@pytest.mark.parametrize("impl", ["rfft", "half"])
@pytest.mark.parametrize("m", [1, 2, 7, 16, 47, 63])
def test_dst1_matches_scipy_and_jax(m, impl):
    v = _field((5, m), 8)
    got = spectral.dst1(_t(v), impl=impl)
    _assert_rel(got, scipy.fft.dst(v, type=1, axis=-1), 1e-13 * m)
    _assert_rel(got, jax_spectral.dst1(jnp.asarray(v), impl=impl))


@pytest.mark.parametrize("impl", ["rfft", "half"])
@pytest.mark.parametrize("shape", [(47, 39), (32, 46)])
def test_dst1_axes_and_2d_match_jax(shape, impl):
    v = _field(shape, 9)
    jv, tv = jnp.asarray(v), _t(v)
    _assert_rel(spectral.dst1(tv, axis=-2, impl=impl),
                jax_spectral.dst1(jv, axis=-2, impl=impl))
    _assert_rel(spectral.dst1(tv, axis=0, impl=impl),
                scipy.fft.dst(v, type=1, axis=0))
    _assert_rel(spectral.dst1_2d(tv, impl),
                jax_spectral.dst1_2d(jv, impl=impl))
    nx, ny = shape[0] + 1, shape[1] + 1
    _assert_rel(spectral.idst1_2d(tv, nx, ny, impl),
                jax_spectral.idst1_2d(jv, nx, ny, impl=impl))
    # DST-I is its own inverse up to 2(m+1) an axis
    back = spectral.idst1_2d(spectral.dst1_2d(tv, impl), nx, ny, impl)
    _assert_rel(back, v)


@pytest.mark.parametrize("impl", ["matmul", "half_mxu", "rfftt", ""])
def test_dst1_unknown_impl_raises(impl):
    with pytest.raises(ValueError, match="DST impl"):
        spectral.dst1(torch.zeros(4, 4), impl=impl)
    with pytest.raises(ValueError, match="DST impl"):
        spectral.make_fst_poisson_dirichlet(4, 4, 0.1, 0.1, torch.float64,
                                            impl=impl)


@pytest.mark.parametrize("impl", ["rfft", "half"])
@pytest.mark.parametrize("shape", [(47, 39), (32, 46), (15, 15)])
def test_fst_poisson_dirichlet_matches_jax(shape, impl):
    f = _field(shape, 10)
    dx, dy = 1.0 / (shape[0] + 1), 1.0 / (shape[1] + 1)
    ref = jax_spectral.fst_poisson_dirichlet(jnp.asarray(f), dx, dy,
                                             impl=impl)
    _assert_rel(spectral.fst_poisson_dirichlet(_t(f), dx, dy, impl), ref)
    solve = spectral.make_fst_poisson_dirichlet(*shape, dx, dy,
                                                torch.float64, impl=impl)
    _assert_rel(solve(_t(f)), ref)
    with pytest.raises(ValueError, match="built for"):
        solve(torch.zeros(3, 3, dtype=torch.float64))


# ------------------------------------------------------------ dealiasing

@pytest.mark.parametrize("shape", SHAPES + [(64, 64), (9, 12)])
def test_dealias_mask_23_matches_jax(shape):
    got = spectral.dealias_mask_23(*shape)
    ref = np.asarray(jax_spectral.dealias_mask_23(*shape))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(48, 40), (16, 16), (6, 10)])
def test_pad_truncate_32_match_jax_and_round_trip(shape):
    nx, ny = shape
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    f = _field((2, nx, ny), 11, complex_=True)
    padded = spectral.pad_32(_t(f), nxe, nye)
    _assert_rel(padded, jax_spectral.pad_32(jnp.asarray(f), nxe, nye), 0.0)
    _assert_rel(spectral.truncate_32(padded, nx, ny), f, 0.0)
    fe = _field((nxe, nye), 12, complex_=True)
    _assert_rel(spectral.truncate_32(_t(fe), nx, ny),
                jax_spectral.truncate_32(jnp.asarray(fe), nx, ny), 0.0)


@pytest.mark.parametrize("shape", [(48, 40), (16, 16), (6, 10)])
def test_truncate_32_half_is_truncate_32_of_the_mirror(shape):
    """On the half spectrum of a generic real fine-grid field:
    truncate_32_half equals the half of truncate_32 of the full spectrum,
    the Nyquist column (the conjugate of the mirrored row) included, and
    the JAX function."""
    nx, ny = shape
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    w = _field((2, nxe, nye), 13)
    h_e = spectral.rfft2(_t(w))
    got = spectral.truncate_32_half(h_e, nx, ny)
    full = spectral.truncate_32(spectral.fft2(_t(w)), nx, ny)
    _assert_rel(got, interop.to_numpy(full)[..., : ny // 2 + 1])
    _assert_rel(got, jax_spectral.truncate_32_half(
        jnp.fft.rfft2(jnp.asarray(w)), nx, ny))


@pytest.mark.parametrize("shape", [(48, 40), (16, 16), (6, 10)])
def test_pad_32_half_is_pad_32_of_the_mirror(shape):
    """With the coarse Nyquist row and column zeroed (as the vortex step's
    mask leaves them): pad_32_half equals the half of pad_32 of the
    Hermitian mirror, and the padded field is the Fourier interpolant."""
    nx, ny = shape
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    h = np.fft.rfft2(_field(shape, 14))
    h[nx // 2, :] = 0.0
    h[:, ny // 2] = 0.0
    got = spectral.pad_32_half(_t(h), ny, nxe, nye)
    full = jax_spectral.pad_32(
        jax_spectral.hermitian_full(jnp.asarray(h), ny), nxe, nye)
    _assert_rel(got, np.asarray(full)[:, : nye // 2 + 1], 0.0)
    scale = (nxe * nye) / (nx * ny)
    fine = spectral.irfft2(got * scale, nxe, nye)
    coarse = spectral.irfft2(_t(h), nx, ny)
    # 3/2 grid nodes 0, 3, 6, ... coincide with coarse nodes 0, 2, 4, ...
    _assert_rel(fine[::3, ::3], interop.to_numpy(coarse[::2, ::2]), 1e-12)


@pytest.mark.parametrize("shape", [(7, 8), (8, 7)])
def test_32_rule_rejects_odd_sizes(shape):
    nx, ny = shape
    z = torch.zeros(shape, dtype=torch.complex128)
    with pytest.raises(ValueError, match="even grid sizes"):
        spectral.pad_32(z, 12, 12)
    with pytest.raises(ValueError, match="even grid sizes"):
        spectral.truncate_32(torch.zeros(12, 12), nx, ny)
    with pytest.raises(ValueError, match="even grid sizes"):
        spectral.truncate_32_half(torch.zeros(12, 7), nx, ny)
    with pytest.raises(ValueError, match="even grid sizes"):
        spectral.pad_32_half(torch.zeros(nx, ny // 2 + 1), ny, 12, 12)
    with pytest.raises(ValueError, match="even grid sizes"):
        jax_spectral.pad_32(jnp.zeros(shape), 12, 12)
