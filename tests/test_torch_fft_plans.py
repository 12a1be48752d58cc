"""The half-spectrum vortex step's inverse on the port's own cuFFT layouts
(ops/fft_plans.py, csrc/fft_plans.cu on a GPU), the derivative pass's
buffer mode and the ps32 truncation pass (ops/cuda_kernels.py
vortex_derivs_half(cols=...), vortex_truncate_32; csrc/vortex_stage.cu on a
GPU), on the CPU in fp64 through their plain versions.

Each layout's plain version (torch.as_strided and torch.fft) is held to
torch.fft's own calls on the same data within 1e-13 of the scale (their
operation order), the buffer-layout inverse to spectral.irfft2_band and to
irfft2 of pad_32_half within 1e-13 and to JAX's irfft2 of the padded
spectrum within 1e-12; the twins of the new modes bitwise to the old twin
followed by cat / pad_32_half, the truncation twin bitwise to
truncate_32_half(jf) * table and within 1e-12 of JAX's; three ps23 / ps32
half steps on the plan layouts (the kernel route, swapped in here by a
monkeypatch of the rhs_impl resolution) within 1e-11 of JAX's
make_spectral_step_half; each *_backward_plain against autograd of its twin
in complex128 at rel 1e-12, and the gradient of the planned step against
the twin route's.
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
from cfd_julia_torch.ops import fft_plans, spectral
from cfd_julia_tpu.models import vortex as jax_vortex
from cfd_julia_tpu.ops import spectral as jax_spectral

torch.set_num_threads(1)

F64, C128 = torch.float64, torch.complex128
# ps23 grids (any size) and ps32's (even sizes)
GRIDS_23 = [(32, 32), (33, 48), (48, 32)]
GRIDS_32 = [(32, 32), (48, 32)]


def _configs(nx, ny, solver="ps23"):
    jcfg = jax_vortex.VortexConfig(nx=nx, ny=ny, solver=solver, dt=0.01,
                                   re=1000.0, rhs_impl="xla", fft_impl="xla")
    return jcfg, interop.vortex_config_from_jax(jcfg)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape))


def _assert_scaled(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (err, scale)


def _assert_rel(got, ref, rel=1e-12):
    err = float((got - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), err


def _band(ny):
    return ((2 * ny) // 3) // 2


# ------------------------------------------------------------ layouts

def test_layout_plain_versions_match_torch_fft():
    """The in-place C2C over the first columns of a (cols, 4, rows)
    buffer, and the C2R along its columns, against torch.fft on the same
    data; the spans the layouts need."""
    cols, rows, n, nb = 9, 6, 16, 5
    buf = _complex((cols, 4, rows), 1)
    c2c = fft_plans.Layout(fft_plans.C2C, rows, 4 * nb, 1, rows, 1, rows)
    c2r = fft_plans.Layout(fft_plans.C2R, n, 4 * rows, 4 * rows, 1, 1, n)
    assert c2c.span("in") == 4 * nb * rows and c2r.span("in") == buf.numel()
    assert c2r.n_in == cols and c2r.span("out") == 4 * rows * n
    x = buf.clone()
    assert fft_plans.execute(c2c, x, x) is x
    want = buf.clone()
    want[:nb] = torch.fft.ifft(buf[:nb], dim=-1, norm="forward")
    _assert_scaled(x, want, 1e-13)
    out = torch.empty((4, rows, n), dtype=F64)
    fft_plans.execute(c2r, x, out)
    ref = torch.fft.irfft(want.permute(1, 2, 0), n=n, dim=-1, norm="forward")
    _assert_scaled(out, ref, 1e-13)
    # no launch is counted on the CPU
    before = dict(ck.LAUNCHES)
    fft_plans.execute(c2c, buf.clone(), buf.clone())
    assert ck.LAUNCHES == before


def test_execute_refuses_bad_operands():
    c2r = fft_plans.Layout(fft_plans.C2R, 8, 3, 1, 5, 1, 8)
    x = torch.zeros(15, dtype=C128)
    with pytest.raises(TypeError):
        fft_plans.execute(c2r, x, torch.zeros(24, dtype=C128))
    with pytest.raises(TypeError):
        fft_plans.execute(c2r, x, torch.zeros(24, dtype=torch.float32))
    with pytest.raises(ValueError, match="spanning"):
        fft_plans.execute(c2r, x[:14], torch.zeros(24, dtype=F64))
    with pytest.raises(ValueError, match="spanning"):
        fft_plans.execute(c2r, torch.zeros((5, 3), dtype=C128).mT,
                          torch.zeros(24, dtype=F64))


@pytest.mark.parametrize("ky_fastest", [True, False], ids=["ky", "kx"])
@pytest.mark.parametrize("nx,ny", GRIDS_23)
def test_band_inverse_on_the_plan_layout(nx, ny, ky_fastest):
    """ps23's HalfInverse on the CPU (the layouts' plain versions), in
    either buffer layout, against spectral.irfft2_band of the spectra,
    stored either way, against its torch-op twin, and against JAX's irfft2
    of the zero-padded spectrum."""
    nb = _band(ny)
    spectra = _complex((4, nx, nb), nx + ny)
    inv = fft_plans.HalfInverse(4, nx, ny, nb, F64, "cpu", ky_fastest)
    # ky fastest: rows padded to a pitch of 16 values
    pitch = -(-(ny // 2 + 1) // 16) * 16 if ky_fastest else ny // 2 + 1
    buf = ck._to_buffer(spectra, pitch, 0, ky_fastest)
    assert inv.buffer.shape == buf.shape and inv.out.shape == (4, nx, ny)
    twin = fft_plans.half_inverse_plain(buf, ny, nb, ky_fastest)
    got = inv(buf.clone())
    assert got is inv.out
    for h in (spectra, spectra.mT.contiguous().mT):
        _assert_scaled(got, spectral.irfft2_band(h, nx, ny, norm="forward"),
                       1e-13)
    _assert_scaled(got, twin, 1e-13)
    padded = np.zeros((4, nx, ny // 2 + 1), complex)
    padded[..., :nb] = spectra.numpy()
    ref = np.asarray(jnp.fft.irfft2(jnp.asarray(padded), s=(nx, ny),
                                    norm="forward"))
    _assert_scaled(got, ref, 1e-12)


@pytest.mark.parametrize("ky_fastest", [False, True], ids=["kx", "ky"])
@pytest.mark.parametrize("nx,ny", GRIDS_32)
def test_padded_inverse_on_the_plan_layout(nx, ny, ky_fastest):
    """ps32's HalfInverse on the 3/2 grid's buffer, in either layout,
    against irfft2 of pad_32_half and against JAX's irfft2 of the padded
    spectrum."""
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    spectra = _complex((4, nx, ny // 2 + 1), nx * ny)
    spectra[..., ny // 2] = 0
    inv = fft_plans.HalfInverse(4, nxe, nye, ny // 2, F64, "cpu",
                                ky_fastest)
    cols = inv.buffer.shape[-1] if ky_fastest else nye // 2 + 1
    buf = ck._to_buffer(spectra[..., :ny // 2], cols, nxe - nx, ky_fastest)
    pads = spectral.pad_32_half(spectra, ny, nxe, nye)
    assert torch.equal(buf[..., :nye // 2 + 1] if ky_fastest else buf,
                       pads if ky_fastest else pads.permute(2, 0, 1))
    got = inv(buf.clone())
    _assert_scaled(got, spectral.irfft2(pads, nxe, nye, norm="forward"),
                   1e-13)
    ref = np.asarray(jnp.fft.irfft2(jnp.asarray(pads.numpy()), s=(nxe, nye),
                                    norm="forward"))
    _assert_scaled(got, ref, 1e-12)


# ---------------------------------------------- the derivative buffer mode

@pytest.mark.parametrize("nx,ny", GRIDS_23)
def test_derivs_buffer_twin_is_the_old_twin_and_cat(nx, ny):
    """ps23's buffer mode, bitwise the (4, nx, nb) twin with its columns
    catted to ny//2+1 (ky fastest), and that moved to (cols, 4, rows) (kx
    fastest); the wrapper writes a caller's buffer, every element, and
    counts nothing on the CPU."""
    _, cfg = _configs(nx, ny)
    hy, nb = ny // 2 + 1, _band(ny)
    rowk, colk = vortex._deriv_tables(cfg, F64, "cpu", band=True)
    H = _complex((nx, hy), 5)
    scale = 1.0 / (nx * ny)
    old = ck.vortex_derivs_half_plain(H, rowk, colk, nb, scale)
    want = torch.cat([old, old.new_zeros((4, nx, hy - nb))], -1)
    for ky, layout in [(True, want), (False, want.permute(2, 0, 1))]:
        got = ck.vortex_derivs_half_plain(H, rowk, colk, nb, scale, cols=hy,
                                          ky_fastest=ky)
        assert torch.equal(got, layout) and got.is_contiguous()
        out = torch.full(got.shape, complex(np.nan, np.nan), dtype=C128)
        before = dict(ck.LAUNCHES)
        res = ck.vortex_derivs_half(H.mT.contiguous().mT, rowk, colk, nb,
                                    scale, cols=hy, ky_fastest=ky, out=out)
        assert res is out and torch.equal(out, got)
        assert ck.LAUNCHES == before
        assert torch.equal(ck._from_buffer(got, nx, nb, 0, ky), old)


@pytest.mark.parametrize("nx,ny", GRIDS_32)
def test_derivs_buffer_twin_is_the_old_twin_and_pad_32_half(nx, ny):
    """ps32's buffer mode (nb = ny/2, the 3/2 grid's rows and columns),
    bitwise pad_32_half of the full-width twin."""
    _, cfg = _configs(nx, ny, "ps32")
    hy = ny // 2 + 1
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    rowk, colk = vortex._deriv_tables(cfg, F64, "cpu")
    H = _complex((nx, hy), 6)
    scale = 2.25 / (nxe * nye)
    old = ck.vortex_derivs_half_plain(H, rowk, colk, hy, scale)
    want = spectral.pad_32_half(old, ny, nxe, nye).permute(2, 0, 1)
    got = ck.vortex_derivs_half_plain(H, rowk, colk, ny // 2, scale,
                                      cols=nye // 2 + 1, pad_rows=nxe - nx)
    assert torch.equal(got, want)
    got_w = ck.vortex_derivs_half(H, rowk, colk, ny // 2, scale,
                                  cols=nye // 2 + 1, pad_rows=nxe - nx)
    assert torch.equal(got_w, want)
    got_ky = ck.vortex_derivs_half(H, rowk, colk, ny // 2, scale,
                                   cols=nye // 2 + 1, pad_rows=nxe - nx,
                                   ky_fastest=True)
    assert torch.equal(got_ky, want.permute(1, 2, 0))


@pytest.mark.parametrize("args,err", [
    (dict(cols=3), ValueError),
    (dict(pad_rows=-1), ValueError),
    (dict(cols=None, pad_rows=2), ValueError),
    (dict(cols=None, ky_fastest=True), ValueError),
    (dict(ky_fastest=True, out=torch.zeros((5, 4, 8), dtype=C128)),
     ValueError),
    (dict(cols=None, out=torch.zeros((5, 4, 8), dtype=C128)), ValueError),
    (dict(out=torch.zeros((5, 4, 9), dtype=C128)), ValueError),
    (dict(out=torch.zeros((5, 4, 8), dtype=torch.complex64)), ValueError),
    (dict(out=torch.zeros((4, 5, 8), dtype=C128).transpose(0, 1)),
     ValueError),
])
def test_derivs_buffer_mode_refuses_bad_arguments(args, err):
    call = dict(h=torch.zeros(8, 5, dtype=C128),
                rowk=torch.zeros(8, 3, dtype=F64),
                colk=torch.zeros(5, 3, dtype=F64), nb=4, cols=5)
    call.update(args)
    with pytest.raises(err):
        ck.vortex_derivs_half(**call)


def test_derivs_buffer_out_is_refused_under_grad():
    h = torch.zeros(8, 5, dtype=C128, requires_grad=True)
    with pytest.raises(ValueError, match="outside grad"):
        ck.vortex_derivs_half(h, torch.zeros(8, 3, dtype=F64),
                              torch.zeros(5, 3, dtype=F64), 4, cols=5,
                              out=torch.zeros((5, 4, 8), dtype=C128))


# ------------------------------------------------------- the truncation

def _fine(nx, ny, seed):
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    return _complex((nxe, nye // 2 + 1), seed)


@pytest.mark.parametrize("nx,ny", GRIDS_32)
def test_truncate_twin_matches_truncate_32_half_and_jax(nx, ny):
    """vortex_truncate_32's twin bitwise truncate_32_half(jf) * nyq/scale,
    jf and the table either way, within 1e-12 of JAX's truncate_32_half
    times its nyq / scale; the wrapper takes it on the CPU."""
    jcfg, cfg = _configs(nx, ny, "ps32")
    _, _, _, nyq = vortex._half_consts(cfg, F64, "cpu")
    table = nyq / 2.25
    jf = _fine(nx, ny, 7)
    want = spectral.truncate_32_half(jf, nx, ny) * table
    for j in (jf, jf.mT.contiguous().mT):
        for t in (table, table.mT.contiguous().mT):
            assert torch.equal(ck.vortex_truncate_32_plain(j, t), want)
            assert torch.equal(ck.vortex_truncate_32(j, t), want)
    _, _, _, jnyq = jax_vortex._half_consts_traced(jcfg, jnp.float64)
    ref = jax_spectral.truncate_32_half(jnp.asarray(jf.numpy()), nx, ny) \
        * (jnyq / 2.25)
    _assert_scaled(want, np.asarray(ref), 1e-12)
    # the product by the table is a complex product: a NaN survives a 0
    bad = jf.clone()
    bad[nx // 2 + (3 * nx // 2 - nx), 0] = complex(np.nan, 0)
    assert torch.isnan(ck.vortex_truncate_32_plain(bad, table)).any()


@pytest.mark.parametrize("jf,table,err", [
    (torch.zeros(12, 7), torch.zeros(8, 5, dtype=F64), TypeError),
    (torch.zeros(12, 7, dtype=C128), torch.zeros(8, 5), TypeError),
    (torch.zeros(12, 7, dtype=C128), torch.zeros(7, 5, dtype=F64),
     ValueError),
    (torch.zeros(6, 7, dtype=C128), torch.zeros(8, 5, dtype=F64),
     ValueError),
    (torch.zeros(12, 4, dtype=C128), torch.zeros(8, 5, dtype=F64),
     ValueError),
    (torch.zeros(2, 12, 7, dtype=C128), torch.zeros(8, 5, dtype=F64),
     ValueError),
])
def test_truncate_refuses_bad_arguments(jf, table, err):
    with pytest.raises(err):
        ck.vortex_truncate_32(jf, table)


# --------------------------------------------------- the step, planned

@functools.lru_cache(maxsize=None)
def _jax_half_steps(solver, nx, ny, n):
    jcfg, _ = _configs(nx, ny, solver)
    w0 = np.random.default_rng(nx + ny).standard_normal((nx, ny))
    step = jax.jit(jax_vortex.make_spectral_step_half(jcfg, jnp.float64))
    state = jax_vortex.half_init(jnp.asarray(w0))
    for _ in range(n):
        state = step(state)
    return w0, np.asarray(state)


@pytest.fixture
def planned(monkeypatch):
    """make_spectral_step_half on the CPU takes the kernel route (the plan
    layouts and the passes through their plain versions); counts the
    route's calls."""
    calls = {"execute": 0, "truncate": 0}
    execute, truncate = fft_plans.execute, ck.vortex_truncate_32

    def counted_execute(*args):
        calls["execute"] += 1
        return execute(*args)

    def counted_truncate(*args):
        calls["truncate"] += 1
        return truncate(*args)

    monkeypatch.setattr(vortex.precision, "resolve_rhs_impl",
                        lambda name, device: "kernel")
    monkeypatch.setattr(fft_plans, "execute", counted_execute)
    monkeypatch.setattr(ck, "vortex_truncate_32", counted_truncate)
    return calls


@pytest.mark.parametrize("solver,nx,ny", [("ps23", 32, 32), ("ps23", 33, 48),
                                          ("ps32", 32, 32), ("ps32", 48, 32)])
def test_half_step_on_the_plan_layouts_matches_jax(planned, solver, nx, ny):
    """Three steps of the port's half step on the plan layouts' plain
    versions against the JAX package's, a state stored column by column
    stepping bitwise as the same state row by row."""
    w0, ref = _jax_half_steps(solver, nx, ny, 3)
    _, cfg = _configs(nx, ny, solver)
    step = vortex.make_spectral_step_half(cfg, F64, "cpu")
    H = vortex.half_init(interop.field_from_numpy(w0, F64, "cpu"))
    assert torch.equal(step(H.mT.contiguous().mT), step(H))
    for _ in range(3):
        H = step(H)
    np.testing.assert_allclose(interop.to_numpy(H), ref, rtol=0, atol=1e-11)
    # executions a Jacobian (ps23's kx transform one a field, then the
    # c2r), three Jacobians a step, 5 steps
    assert planned["execute"] == (5 if solver == "ps23" else 2) * 3 * 5
    assert planned["truncate"] == (3 * 5 if solver == "ps32" else 0)


def test_mesh_and_twin_steps_keep_torch_fft(planned, monkeypatch):
    """rhs_impl "torch" (the twins) never takes the plan layouts."""
    monkeypatch.setattr(vortex.precision, "resolve_rhs_impl",
                        lambda name, device: "torch")
    _, cfg = _configs(32, 32, "ps32")
    step = vortex.make_spectral_step_half(cfg, F64, "cpu")
    step(vortex.half_init(torch.randn(32, 32, dtype=F64)))
    assert planned == {"execute": 0, "truncate": 0}


@pytest.mark.parametrize("solver", ["ps23", "ps32"])
def test_planned_step_gradient_matches_the_twins(planned, monkeypatch,
                                                 solver):
    """d sum(w^2) / d w0 over two steps through the plan layouts (the
    inverse's autograd Function) against the twin route's."""
    _, cfg = _configs(32, 32, solver)
    w0 = torch.as_tensor(np.random.default_rng(3).standard_normal((32, 32)))

    def grad():
        step = vortex.make_spectral_step_half(cfg, F64, "cpu")
        x = w0.clone().requires_grad_()
        H = vortex.half_init(x)
        for _ in range(2):
            H = step(H)
        (g,) = torch.autograd.grad(
            torch.sum(vortex.half_decode(H, 32, 32) ** 2), x)
        return g

    g_plan = grad()
    assert planned["execute"] == (5 if solver == "ps23" else 2) * 3 * 2
    monkeypatch.setattr(vortex.precision, "resolve_rhs_impl",
                        lambda name, device: "torch")
    _assert_rel(g_plan, grad())


# ------------------------------------------------------- the adjoints

@pytest.mark.parametrize("ky_fastest", [False, True], ids=["kx", "ky"])
@pytest.mark.parametrize("n,rows,nb", [(16, 12, 5), (15, 9, 8), (12, 6, 7)])
def test_half_inverse_backward_plain_matches_autograd(n, rows, nb,
                                                      ky_fastest):
    """half_inverse_backward_plain against autograd of half_inverse_plain,
    and the inverse's autograd Function (on the CPU: the layouts' plain
    versions forward) against the same, in complex128, in either
    layout."""
    inv = fft_plans.HalfInverse(4, rows, n, nb, F64, "cpu", ky_fastest)
    buf = _complex(inv.buffer.shape, n).requires_grad_()
    G = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (4, rows, n)))
    (ref,) = torch.autograd.grad(
        fft_plans.half_inverse_plain(buf, n, nb, ky_fastest), buf, G)
    got = fft_plans.half_inverse_backward_plain(
        G, nb, ky_fastest, buf.shape[-1] if ky_fastest else None)
    assert got.shape == buf.shape and got.dtype == C128
    _assert_rel(got, ref)
    x = buf.detach().clone().requires_grad_()
    y = inv(x * 1)
    assert y is not inv.out
    _assert_rel(y.detach(), fft_plans.half_inverse_plain(
        buf.detach(), n, nb, ky_fastest), 1e-13)
    (via_fn,) = torch.autograd.grad(y, x, G)
    _assert_rel(via_fn, ref)


@pytest.mark.parametrize("ky_fastest", [True, False], ids=["ky", "kx"])
@pytest.mark.parametrize("solver", ["ps23", "ps32"])
def test_derivs_buffer_backward_matches_autograd(solver, ky_fastest):
    """The buffer mode's adjoint (the buffer's live part, then
    vortex_derivs_half_backward_plain) against autograd of its twin."""
    nx, ny = 24, 36
    _, cfg = _configs(nx, ny, solver)
    hy = ny // 2 + 1
    band = solver == "ps23"
    nb = _band(ny) if band else ny // 2
    cols, pad = (hy, 0) if band else (3 * ny // 4 + 1, nx // 2)
    rowk, colk = vortex._deriv_tables(cfg, F64, "cpu", band=band)
    H = _complex((nx, hy), 2).requires_grad_()
    G = _complex(ck._buffer_shape(nx, cols, pad, ky_fastest), 3)
    (ref,) = torch.autograd.grad(ck.vortex_derivs_half_plain(
        H, rowk, colk, nb, 0.5, cols, pad, ky_fastest), H, G)
    got = ck.vortex_derivs_half_backward_plain(
        ck._from_buffer(G, nx, nb, pad, ky_fastest), rowk, colk, hy, 0.5)
    _assert_rel(got, ref)


@pytest.mark.parametrize("nx,ny", GRIDS_32)
def test_truncate_backward_plain_matches_autograd(nx, ny):
    """vortex_truncate_32_backward_plain against autograd of the twin, with
    a table that keeps the Nyquist column (its conjugate-flipped path)."""
    jf = _fine(nx, ny, 4).requires_grad_()
    table = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.0, (nx, ny // 2 + 1)))
    G = _complex((nx, ny // 2 + 1), 6)
    (ref,) = torch.autograd.grad(ck.vortex_truncate_32_plain(jf, table), jf,
                                 G)
    got = ck.vortex_truncate_32_backward_plain(G, table, *jf.shape)
    assert got.shape == jf.shape
    _assert_rel(got, ref)
