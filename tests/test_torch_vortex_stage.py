"""The half-spectrum vortex step's stage passes (ops/cuda_kernels.py
vortex_derivs_half, vortex_product, vortex_cn_combine; csrc/vortex_stage.cu
on a GPU) and the band-limited inverse (ops/spectral.irfft2_band) against
the JAX package, on the CPU in fp64.

Each twin is held to the expression it replaces, built from the JAX step's
own constants (`_packed_jacobian_consts_traced`, `_cn_consts_traced`,
`_band_mask_23_half_traced`), within 1e-14 of the scale (one rounding of a
constant); irfft2_band to irfft2 of the zero-padded spectrum within 1e-13
of the scale (the transforms' operation order); each *_backward_plain to
autograd of its twin at rel 1e-12; and the ps23 / ps32 / hybrid half step
through the twins (rhs_impl "torch", and "auto", which is the twins on the
CPU) to JAX's make_spectral_step_half within 1e-11, as
tests/test_torch_vortex.py holds it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.models import vortex
from cfd_julia_torch.ops import cuda_kernels as ck
from cfd_julia_torch.ops import spectral
from cfd_julia_tpu.models import vortex as jax_vortex

torch.set_num_threads(1)

F64 = torch.float64
# square and non-square grids, both at most 48^2
GRIDS = [(48, 48), (32, 48), (24, 36)]


def _configs(nx, ny, solver="ps23", **kw):
    jcfg = jax_vortex.VortexConfig(nx=nx, ny=ny, solver=solver, dt=0.01,
                                   re=1000.0, rhs_impl="xla", fft_impl="xla",
                                   **kw)
    return jcfg, interop.vortex_config_from_jax(jcfg)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _t(a):
    return torch.as_tensor(a)


def _assert_scaled(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale, \
        (np.abs(got - ref).max(), scale)


def _jax_spectra(jcfg, H, band):
    """psi_x, w_y, psi_y, w_x of H from the JAX step's packed pairs: h1 =
    (i gx - ky0) m, t1 = (i gx + ky0) m, h2 = (i gy - kx0) m, t2 = (i gy +
    kx0) m, so g = Im h1, Re t1, Im h2, Re t2."""
    mask = jax_vortex._band_mask_23_half_traced(jcfg) if band else None
    h1, t1, h2, t2 = (np.asarray(c) for c in
                      jax_vortex._packed_jacobian_consts_traced(
                          jcfg, jnp.float64, mask))
    g = np.stack([h1.imag, t1.real, h2.imag, t2.real])
    return g * (1j * H)


# ------------------------------------------------------ the derivative pass

@pytest.mark.parametrize("nx,ny", GRIDS)
@pytest.mark.parametrize("form", ["band", "full", "ps32"])
def test_derivs_twin_matches_jax_constants(nx, ny, form):
    """The four spectra from the tables of _deriv_tables against g (i H)
    from JAX's packed constants: ps23's band (nb = nye//2 columns, and the
    JAX spectra zero past them), the full width with the band in the masks
    (the mesh form), and ps32's full width with its scale folded in."""
    jcfg, cfg = _configs(nx, ny)
    hy = ny // 2 + 1
    H = _complex((nx, hy), nx + ny)
    band = form != "ps32"
    ref = _jax_spectra(jcfg, H, band)
    rowk, colk = vortex._deriv_tables(cfg, F64, "cpu", band=band)
    nb, scale = hy, 1.0
    if form == "band":
        nb = ((2 * ny) // 3) // 2
        assert not ref[..., nb:].any()
        ref = ref[..., :nb]
    if form == "ps32":
        scale = 2.25
        ref = ref * scale
    got = ck.vortex_derivs_half_plain(_t(H), rowk, colk, nb, scale)
    assert got.shape == (4, nx, nb) and got.dtype == torch.complex128
    _assert_scaled(got.numpy(), ref, 1e-14)
    # the wrapper takes the twin on the CPU and launches nothing
    before = dict(ck.LAUNCHES)
    assert torch.equal(ck.vortex_derivs_half(_t(H), rowk, colk, nb, scale),
                       got)
    assert ck.LAUNCHES == before


@pytest.mark.parametrize("world,rank", [(2, 1), (4, 2)])
def test_derivs_on_a_row_slab(world, rank):
    """A rank's row slab of H with the row table sliced to its rows (the
    mesh form) is the same rows of the single-device spectra, bitwise."""
    nx, ny = 32, 48
    _, cfg = _configs(nx, ny)
    H = _t(_complex((nx, ny // 2 + 1), 3))
    rowk, colk = vortex._deriv_tables(cfg, F64, "cpu", band=True)
    whole = ck.vortex_derivs_half_plain(H, rowk, colk, ny // 2 + 1)
    rows = slice(rank * nx // world, (rank + 1) * nx // world)
    slab = ck.vortex_derivs_half_plain(H[rows].contiguous(), rowk[rows],
                                       colk, ny // 2 + 1)
    assert rowk[rows].is_contiguous()
    assert torch.equal(slab, whole[:, rows])


def test_deriv_tables_match_the_half_constants():
    """rowk, colk hold _half_consts's wavenumbers bit for bit and the
    Nyquist and band masks of _nyquist_mask and _band_mask_23_half."""
    for nx, ny in [(24, 36), (15, 16), (16, 15)]:
        _, cfg = _configs(nx, ny)
        kx0, ky0, k2h, nyq = vortex._half_consts(cfg, F64, "cpu")
        for band in (False, True):
            rowk, colk = vortex._deriv_tables(cfg, F64, "cpu", band=band)
            kx, kx0_t, rm = rowk.unbind(1)
            ky, kyg, cm = colk.unbind(1)
            assert torch.equal(kx0_t, kx0[:, 0])
            assert torch.equal(ky, ky0[0])
            assert torch.equal(kx[:, None] * kx[:, None]
                               + kyg[None] * kyg[None], k2h)
            m = nyq if not band else \
                nyq * vortex._band_mask_23_half(cfg).to(F64)
            assert torch.equal(rm[:, None] * cm[None], m)


@pytest.mark.parametrize("args,err", [
    (dict(h=torch.zeros(8, 5)), TypeError),
    (dict(rowk=torch.zeros(8, 3, dtype=torch.float32)), TypeError),
    (dict(nb=6), ValueError),
    (dict(nb=0), ValueError),
    (dict(rowk=torch.zeros(7, 3, dtype=F64)), ValueError),
    (dict(colk=torch.zeros(3, 3, dtype=F64)), ValueError),
    (dict(h=torch.zeros(2, 8, 5, dtype=torch.complex128)), ValueError),
])
def test_derivs_wrapper_refuses_bad_arguments(args, err):
    call = dict(h=torch.zeros(8, 5, dtype=torch.complex128),
                rowk=torch.zeros(8, 3, dtype=F64),
                colk=torch.zeros(5, 3, dtype=F64), nb=4)
    call.update(args)
    with pytest.raises(err):
        ck.vortex_derivs_half(**call)


# ------------------------------------------------ product and the combine

@pytest.mark.parametrize("shape", [(48, 48), (32, 48), (3, 5)])
def test_product_twin_matches_the_jacobian(shape):
    """p = a b - c d, the JAX step's z0.re z0.im - z1.re z1.im, exactly."""
    phys = np.random.default_rng(sum(shape)).standard_normal((4, *shape))
    ref = phys[0] * phys[1] - phys[2] * phys[3]
    got = ck.vortex_product_plain(_t(phys))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(ck.vortex_product(_t(phys)), got)


@pytest.mark.parametrize("nx,ny", GRIDS)
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_cn_combine_twin_matches_jax_constants(nx, ny, stage):
    """a H + r j0 + b j1 with the port's _cn_consts tables against the JAX
    step's update with _cn_consts_traced's (stage 1 without r j0)."""
    jcfg, cfg = _configs(nx, ny)
    hy = ny // 2 + 1
    _, _, k2j, _ = jax_vortex._half_consts_traced(jcfg, jnp.float64)
    aj, bj, rj = (np.asarray(c) for c in
                  jax_vortex._cn_consts_traced(jcfg, k2j,
                                               jnp.float64)[stage - 1])
    H, j0, j1 = (_complex((nx, hy), 10 * stage + k) for k in range(3))
    ref = aj * H + bj * j1 if stage == 1 else aj * H + rj * j0 + bj * j1
    _, _, k2h, _ = vortex._half_consts(cfg, F64, "cpu")
    a, b, r = vortex._cn_consts(cfg, k2h)[stage - 1]
    if stage == 1:
        r, j0 = None, None
    got = ck.vortex_cn_combine_plain(a, _t(H), r, None if j0 is None
                                     else _t(j0), b, _t(j1))
    _assert_scaled(got.numpy(), ref, 1e-14)
    assert torch.equal(ck.vortex_cn_combine(a, _t(H), r, None if j0 is None
                                            else _t(j0), b, _t(j1)), got)


def test_combine_and_product_refuse_bad_arguments():
    a = torch.zeros(4, 3, dtype=F64)
    h = torch.zeros(4, 3, dtype=torch.complex128)
    with pytest.raises(ValueError, match="together"):
        ck.vortex_cn_combine(a, h, a, None, a, h)
    with pytest.raises(TypeError):
        ck.vortex_cn_combine(a.float(), h, None, None, a, h)
    with pytest.raises(ValueError, match="one non-empty shape"):
        ck.vortex_cn_combine(a, h, None, None, a[:3], h)
    with pytest.raises(TypeError):
        ck.vortex_product(h)
    with pytest.raises(ValueError, match="four stacked"):
        ck.vortex_product(torch.zeros(3, 4, 4, dtype=F64))


# --------------------------------------------------- the band-limited inverse

@pytest.mark.parametrize("nx,ny", [(48, 48), (32, 48), (24, 36), (9, 9),
                                   (16, 15)])
def test_irfft2_band_matches_the_padded_irfft2(nx, ny):
    """irfft2_band of the first nb columns equals irfft2 of the whole half
    spectrum with its columns past nb zeroed, for a batch of four."""
    hy, nb = ny // 2 + 1, ((2 * ny) // 3) // 2
    full = np.zeros((4, nx, hy), complex)
    full[..., :nb] = _complex((4, nx, nb), nx * ny)
    ref = spectral.irfft2(_t(full), nx, ny)
    got = spectral.irfft2_band(_t(full[..., :nb]).contiguous(), nx, ny)
    assert got.shape == (4, nx, ny) and got.dtype == F64
    _assert_scaled(got.numpy(), ref.numpy(), 1e-13)
    np.testing.assert_allclose(
        got.numpy(), np.fft.irfft2(full, s=(nx, ny)), rtol=0,
        atol=1e-13 * np.abs(ref.numpy()).max())


# ------------------------------------------------------- the adjoints

def _cotangent(shape, seed, complex_=True):
    return _t(_complex(shape, seed) if complex_ else
              np.random.default_rng(seed).standard_normal(shape))


def _assert_rel(got, ref, rel=1e-12):
    err = float((got - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), err


@pytest.mark.parametrize("form", ["band", "ps32"])
def test_derivs_backward_plain_matches_autograd(form):
    nx, ny = 24, 36
    _, cfg = _configs(nx, ny)
    hy = ny // 2 + 1
    band = form == "band"
    nb, scale = (((2 * ny) // 3) // 2, 1.0) if band else (hy, 2.25)
    rowk, colk = vortex._deriv_tables(cfg, F64, "cpu", band=band)
    H = _t(_complex((nx, hy), 1)).requires_grad_()
    G = _cotangent((4, nx, nb), 2)
    (ref,) = torch.autograd.grad(
        ck.vortex_derivs_half_plain(H, rowk, colk, nb, scale), H, G)
    got = ck.vortex_derivs_half_backward_plain(G, rowk, colk, hy, scale)
    assert got.shape == (nx, hy) and not got[:, nb:].any()
    _assert_rel(got, ref)


def test_product_backward_plain_matches_autograd():
    phys = _cotangent((4, 24, 36), 3, complex_=False).requires_grad_()
    G = _cotangent((24, 36), 4, complex_=False)
    (ref,) = torch.autograd.grad(ck.vortex_product_plain(phys), phys, G)
    _assert_rel(ck.vortex_product_backward_plain(phys.detach(), G), ref)


@pytest.mark.parametrize("stage", [1, 2])
def test_cn_combine_backward_plain_matches_autograd(stage):
    nx, ny = 24, 36
    _, cfg = _configs(nx, ny)
    _, _, k2h, _ = vortex._half_consts(cfg, F64, "cpu")
    a, b, r = vortex._cn_consts(cfg, k2h)[stage - 1]
    shape = (nx, ny // 2 + 1)
    H, j0, j1 = (_cotangent(shape, 5 + k).requires_grad_() for k in range(3))
    if stage == 1:
        r = j0 = None
    G = _cotangent(shape, 9)
    wrt = [t for t in (H, j0, j1) if t is not None]
    ref = torch.autograd.grad(ck.vortex_cn_combine_plain(a, H, r, j0, b, j1),
                              wrt, G)
    got = [t for t in ck.vortex_cn_combine_backward_plain(a, r, b, G)
           if t is not None]
    assert len(got) == len(ref)
    for g, want in zip(got, ref):
        _assert_rel(g, want)


# ---------------------------------------------------- the half step

@functools.lru_cache(maxsize=None)
def _jax_half_steps(solver, nx, ny, n):
    jcfg, _ = _configs(nx, ny, solver)
    w0 = np.random.default_rng(nx + ny).standard_normal((nx, ny))
    step = jax.jit(jax_vortex.make_spectral_step_half(jcfg, jnp.float64))
    state = jax_vortex.half_init(jnp.asarray(w0))
    for _ in range(n):
        state = step(state)
    return w0, np.asarray(state)


@pytest.mark.parametrize("rhs_impl", ["torch", "auto"])
@pytest.mark.parametrize("nx,ny", [(48, 48), (32, 48)])
@pytest.mark.parametrize("solver", ["ps23", "ps32", "hybrid"])
def test_half_step_through_the_passes_matches_jax(solver, nx, ny, rhs_impl):
    """Three steps of the port's half step, its stage math through the
    passes' twins, against the JAX package's."""
    w0, ref = _jax_half_steps(solver, nx, ny, 3)
    _, cfg = _configs(nx, ny, solver)
    cfg = dataclasses.replace(cfg, rhs_impl=rhs_impl)
    step = vortex.make_spectral_step_half(cfg, F64, "cpu")
    H = vortex.half_init(interop.field_from_numpy(w0, F64, "cpu"))
    for _ in range(3):
        H = step(H)
    np.testing.assert_allclose(interop.to_numpy(H), ref, rtol=0, atol=1e-11)


def test_kernel_impl_needs_a_cuda_device():
    _, cfg = _configs(16, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        vortex.make_spectral_step_half(
            dataclasses.replace(cfg, rhs_impl="kernel"), F64, "cpu")


# ------------------------------------------------------ memory orders

@pytest.mark.parametrize("solver", ["ps23", "ps32", "hybrid"])
def test_step_takes_either_memory_order(solver):
    """A state stored column by column (torch.fft.rfft2's order on the
    GPU) steps bitwise as the same state stored row by row."""
    _, cfg = _configs(32, 48, solver)
    step = vortex.make_spectral_step_half(cfg, F64, "cpu")
    w0 = np.random.default_rng(2).standard_normal((32, 48))
    H = vortex.half_init(interop.field_from_numpy(w0, F64, "cpu"))
    assert H.is_contiguous()
    assert torch.equal(step(H.mT.contiguous().mT), step(H))


def test_memory_order_helpers():
    t = torch.zeros((4, 6), dtype=torch.complex128)
    kx = t.mT.contiguous().mT
    assert not vortex._is_kx_major(t) and vortex._is_kx_major(kx)
    assert vortex._in_order(kx, True) is kx
    assert vortex._in_order(t, True).mT.is_contiguous()
    assert vortex._in_order(kx, False).is_contiguous()
    assert ck._kx_major("pass", t, t) is False
    assert ck._kx_major("pass", kx, kx) is True
    for bad in [(t, kx), (t[:, ::2],)]:
        with pytest.raises(ValueError, match="memory order"):
            ck._kx_major("pass", *bad)
