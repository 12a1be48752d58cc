"""cfd_julia_torch periodic vortex solvers (fdm, hybrid, ps32, ps23) vs
cfd_julia_tpu.

The same seeded numpy vorticity goes through the JAX steps and the port's
in fp64 on the CPU.  Tolerances: 1e-11 absolute on the spectrum after five
spectral steps from a standard-normal field (as tests/test_ns2d.py holds
JAX's half step to its full step); 1e-12 of the scale for fdm steps
(operation order only), against the XLA RHS and the Pallas kernel in
interpret mode.  Also: `solve` with its snapshots, the TGV bounds of
tests/test_ns2d.py, the diagnostics, the preset runner's files, config
interop and selector typos.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop, presets
from cfd_julia_torch.models import vortex
from cfd_julia_torch.ops import cuda_kernels, spectral
from cfd_julia_torch.run import run_preset
from cfd_julia_torch.stepping import loop
from cfd_julia_torch.utils import diagnostics
from cfd_julia_tpu import presets as jax_presets
from cfd_julia_tpu.models import vortex as jax_vortex
from cfd_julia_tpu.ops import spectral as jax_spectral
from cfd_julia_tpu.run import run_preset as jax_run_preset
from cfd_julia_tpu.stepping import ssprk3 as jax_ssprk3
from cfd_julia_tpu.utils import diagnostics as jax_diagnostics

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECTRAL = ["hybrid", "ps32", "ps23"]
F64 = torch.float64


def _w0(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a):
    return interop.field_from_numpy(a, F64, "cpu")


def _configs(solver, n=48, **kw):
    jcfg = jax_vortex.VortexConfig(nx=n, ny=n, solver=solver, dt=0.01,
                                   re=1000.0, rhs_impl="xla",
                                   fft_impl="xla", **kw)
    return jcfg, interop.vortex_config_from_jax(jcfg)


def _iterate(step, state, n):
    for _ in range(n):
        state = step(state)
    return state


# ------------------------------------------------------------ the steps

@pytest.mark.parametrize("solver", SPECTRAL)
def test_half_step_matches_jax(solver):
    """Five steps of make_spectral_step_half against the JAX package's,
    from a generic field; the port's irfft2 stands where JAX inverts a
    packed Hermitian pair."""
    jcfg, cfg = _configs(solver)
    w0 = _w0((48, 48))
    jstep = jax.jit(jax_vortex.make_spectral_step_half(jcfg, jnp.float64))
    ref = _iterate(jstep, jax_vortex.half_init(jnp.asarray(w0)), 5)
    step = vortex.make_spectral_step_half(cfg, F64, "cpu")
    got = _iterate(step, vortex.half_init(_t(w0)), 5)
    assert got.dtype == torch.complex128 and got.shape == (48, 25)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(ref),
                               rtol=0, atol=1e-11)
    # and the decoded field
    np.testing.assert_allclose(
        interop.to_numpy(vortex.half_decode(got, 48, 48)),
        np.asarray(jax_vortex.half_decode(ref, 48, jnp.float64)),
        rtol=0, atol=1e-13)


@pytest.mark.parametrize("solver", SPECTRAL)
def test_full_step_matches_jax_and_half(solver):
    """Five steps of make_spectral_step on the full spectrum against the
    JAX package's, and against the port's own half step on the mirror."""
    jcfg, cfg = _configs(solver)
    w0 = _w0((48, 48))
    jstep = jax.jit(jax_vortex.make_spectral_step(jcfg, jnp.float64))
    wf0 = jax_spectral.zero_mean_mode(
        jnp.fft.fft2(jnp.asarray(w0).astype(jnp.complex128)))
    ref = np.asarray(_iterate(jstep, wf0, 5))
    step = vortex.make_spectral_step(cfg, F64, "cpu")
    got = _iterate(step, spectral.zero_mean_mode(spectral.fft2(_t(w0))), 5)
    np.testing.assert_allclose(interop.to_numpy(got), ref, rtol=0, atol=1e-11)
    half = _iterate(vortex.make_spectral_step_half(cfg, F64, "cpu"),
                    vortex.half_init(_t(w0)), 5)
    full_of_half = np.asarray(jax_spectral.hermitian_full(
        jnp.asarray(interop.to_numpy(half)), 48))
    np.testing.assert_allclose(full_of_half, interop.to_numpy(got),
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("nx,ny", [(48, 40), (24, 36)])
@pytest.mark.parametrize("solver", SPECTRAL)
def test_half_step_non_square_matches_jax(solver, nx, ny):
    """Non-square even grids catch axis transpositions in the constants,
    the band mask and the 3/2 pad."""
    jcfg = jax_vortex.VortexConfig(nx=nx, ny=ny, solver=solver, dt=0.005,
                                   re=200.0, rhs_impl="xla", fft_impl="xla")
    cfg = interop.vortex_config_from_jax(jcfg)
    w0 = _w0((nx, ny), seed=11)
    jstep = jax.jit(jax_vortex.make_spectral_step_half(jcfg, jnp.float64))
    ref = _iterate(jstep, jax_vortex.half_init(jnp.asarray(w0)), 3)
    got = _iterate(vortex.make_spectral_step_half(cfg, F64, "cpu"),
                   vortex.half_init(_t(w0)), 3)
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(ref),
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", ["jacobian_hybrid", "jacobian_ps32",
                                  "jacobian_ps23"])
def test_jacobians_match_jax(name):
    jcfg, cfg = _configs("ps23", n=32)
    w0 = _w0((32, 32), seed=3)
    # mean mode out, as every step leaves it: psi's would be 1/eps^2 large
    wf = np.fft.fft2(w0 - w0.mean())
    k2j, kxj, kyj = jax_vortex._spectral_consts(jcfg, np.float64)
    k2, kx, ky = vortex._spectral_consts(cfg, F64, "cpu")
    np.testing.assert_array_equal(k2.numpy(), np.asarray(k2j))
    if name == "jacobian_hybrid":
        ref = jax_vortex.jacobian_hybrid(jnp.asarray(wf), k2j, jcfg.dx,
                                         jcfg.dy)
        got = vortex.jacobian_hybrid(_t(wf), k2, cfg.dx, cfg.dy)
    else:
        ref = getattr(jax_vortex, name)(jnp.asarray(wf), k2j, kxj, kyj,
                                        32, 32)
        got = getattr(vortex, name)(_t(wf), k2, kx, ky, 32, 32)
    ref = np.asarray(ref)
    assert np.abs(interop.to_numpy(got) - ref).max() \
        <= 1e-12 * np.abs(ref).max()


def test_deriv_spectra_and_masks_match_jax():
    jcfg, cfg = _configs("ps32", n=16)
    wf = np.fft.fft2(_w0((16, 16), seed=4))
    k2j, kxj, kyj = jax_vortex._spectral_consts(jcfg, np.float64)
    ref = jax_vortex._deriv_spectra(jnp.asarray(wf), k2j, kxj, kyj)
    got = vortex._deriv_spectra(_t(wf), *vortex._spectral_consts(cfg, F64))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-14,
                                   atol=1e-14)
    for nx, ny in [(16, 16), (15, 16), (16, 15), (9, 9)]:
        np.testing.assert_array_equal(
            vortex._nyquist_mask(nx, ny).numpy(),
            np.asarray(jax_vortex._nyquist_mask(nx, ny)))
        np.testing.assert_array_equal(
            vortex._nyquist_mask(nx, ny, hy=ny // 2 + 1).numpy(),
            np.asarray(jax_vortex._nyquist_mask(nx, ny))[:, : ny // 2 + 1])
    c = dataclasses.replace(cfg, nx=24, ny=18)
    jc = dataclasses.replace(jcfg, nx=24, ny=18)
    np.testing.assert_array_equal(
        vortex._band_mask_23_half(c).numpy(),
        np.asarray(jax_vortex._band_mask_23_half_traced(jc)))
    np.testing.assert_array_equal(
        vortex._band_mask_23_half(c).numpy(),
        spectral.dealias_mask_23(24, 18).numpy()[:, :10])


@pytest.mark.parametrize("dtype", ["fp32", "fp64"])
def test_half_constants_match_jax(dtype):
    """The step's constants follow the JAX step's rule (computed in the
    working dtype), so the fp32 values are the same bits."""
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "fp64": (F64, jnp.float64)}[dtype]
    jcfg, cfg = _configs("ps23", n=24)
    ref = jax_vortex._half_consts_traced(jcfg, jdt)
    got = vortex._half_consts(cfg, tdt, "cpu")
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)
    ref_cn = jax_vortex._cn_consts_traced(jcfg, ref[2], jdt)
    for gs, rs in zip(vortex._cn_consts(cfg, got[2]), ref_cn):
        for g, r in zip(gs, rs):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=2e-7 if dtype == "fp32"
                                       else 1e-15)


def _jax_fdm_steps(jcfg, w0, n):
    rhs = lambda w: jax_vortex.fdm_rhs(w, jcfg.dx, jcfg.dy, jcfg.re,
                                       impl=jcfg.rhs_impl)
    step = jax.jit(lambda w: jax_ssprk3.ssprk3_step(rhs, w, jcfg.dt))
    return np.asarray(_iterate(step, jnp.asarray(w0), n))


@pytest.mark.parametrize("jax_impl,steps", [("xla", 5), ("pallas", 2)])
@pytest.mark.parametrize("nx,ny", [(32, 32), (24, 40)])
def test_fdm_steps_match_jax(nx, ny, jax_impl, steps):
    """SSP-RK3 over fdm_rhs against the JAX package with its XLA RHS and
    with its Pallas kernel in interpret mode (the configuration the CUDA
    kernel replaces); on the CPU the port's wrapper takes its twin."""
    jcfg = jax_vortex.VortexConfig(nx=nx, ny=ny, solver="fdm", dt=0.002,
                                   re=100.0, rhs_impl=jax_impl)
    cfg = dataclasses.replace(interop.vortex_config_from_jax(jcfg),
                              rhs_impl="auto")
    w0 = _w0((nx, ny), seed=5)
    ref = _jax_fdm_steps(jcfg, w0, steps)
    cuda_kernels.reset_launch_counts()
    got = interop.to_numpy(
        _iterate(vortex.make_step(cfg, F64, "cpu"), _t(w0), steps))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert not any(cuda_kernels.LAUNCHES.values())
    # the one-off form of the RHS (eigenvalues built for the call)
    rhs = vortex.make_fdm_rhs(cfg, F64, "cpu")
    one_off = vortex.fdm_rhs(_t(w0), cfg.dx, cfg.dy, cfg.re)
    np.testing.assert_array_equal(one_off.numpy(), rhs(_t(w0)).numpy())
    ref_rhs = np.asarray(jax_vortex.fdm_rhs(jnp.asarray(w0), jcfg.dx,
                                            jcfg.dy, jcfg.re))
    assert np.abs(one_off.numpy() - ref_rhs).max() \
        <= 1e-12 * np.abs(ref_rhs).max()


# ------------------------------------------------------------- the solve

@pytest.mark.parametrize("solver", ["fdm", *SPECTRAL])
def test_solve_matches_jax(solver):
    """solve at 32^2, t = 0.1 (10 steps, 5 snapshots + the IC) against the
    JAX package's: final field, snapshots and node axes."""
    jcfg = jax_vortex.VortexConfig(nx=32, ny=32, solver=solver, dt=0.01,
                                   t_final=0.1, ns=5, rhs_impl="xla",
                                   fft_impl="xla")
    ref = jax_vortex.solve(jcfg, jnp.float64)
    res = vortex.solve(interop.vortex_config_from_jax(jcfg), F64, "cpu")
    assert res.snapshots.shape == (6, 32, 32) and res.w.dtype == F64
    for got, want in [(res.w, ref.w), (res.snapshots, ref.snapshots),
                      (res.x, ref.x), (res.y, ref.y)]:
        np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want),
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(res.snapshots[-1].numpy(), res.w.numpy())


def test_solve_leftover_steps_and_ic():
    """nt = 7, ns = 2: snapshots after steps 3 and 6, one leftover step."""
    cfg = vortex.VortexConfig(nx=16, ny=16, solver="ps23", dt=0.01,
                              t_final=0.07, ns=2)
    res = vortex.solve(cfg, F64, "cpu")
    assert res.snapshots.shape == (3, 16, 16)
    np.testing.assert_array_equal(
        res.snapshots[0].numpy(),
        vortex.initial_vorticity(cfg, F64, "cpu").numpy())
    ref = jax_vortex.solve(jax_vortex.VortexConfig(
        nx=16, ny=16, solver="ps23", dt=0.01, t_final=0.07, ns=2,
        fft_impl="xla"), jnp.float64)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize(
    "solver,l2_tol",
    # the bounds of tests/test_ns2d.py::test_tgv_decay
    [("fdm", 8e-3), ("hybrid", 2e-5), ("ps32", 2e-5), ("ps23", 2e-5)],
)
def test_tgv_decay(solver, l2_tol):
    """Taylor-Green vortex vs analytic decay at the reference config
    (tgv.jl: 64^2, Re=10, dt=.01, t=1), and vs the JAX package's error."""
    cfg = vortex.VortexConfig(nx=64, ny=64, solver=solver, dt=0.01,
                              t_final=1.0, re=10.0, ic="tgv", ns=1)
    res = vortex.solve(cfg, F64, "cpu")
    l2, linf = vortex.tgv_error(cfg, res)
    assert float(l2) < l2_tol, (solver, float(l2))
    assert float(linf) >= float(l2) and bool(torch.isfinite(res.w).all())
    jcfg = jax_vortex.VortexConfig(nx=64, ny=64, solver=solver, dt=0.01,
                                   t_final=1.0, re=10.0, ic="tgv", ns=1,
                                   rhs_impl="xla", fft_impl="xla")
    jl2, jlinf = jax_vortex.tgv_error(jcfg, jax_vortex.solve(jcfg,
                                                             jnp.float64))
    np.testing.assert_allclose([float(l2), float(linf)],
                               [float(jl2), float(jlinf)], rtol=1e-6)


def test_initial_conditions_match_jax():
    for ic in ("vm", "tgv"):
        jcfg = jax_vortex.VortexConfig(nx=24, ny=20, ic=ic, re=10.0)
        cfg = interop.vortex_config_from_jax(jcfg)
        np.testing.assert_allclose(
            vortex.initial_vorticity(cfg, F64, "cpu").numpy(),
            np.asarray(jax_vortex.initial_vorticity(jcfg, jnp.float64)),
            rtol=1e-14, atol=1e-16)


def test_observe_decodes_snapshots():
    """run_steps_with_snapshots(observe=...): the buffer takes observe's
    shape and dtype, not the state's."""
    state = torch.zeros(4, 3, dtype=torch.complex128)
    final, snaps = loop.run_steps_with_snapshots(
        lambda s: s + 1, state, 5, 2, observe=lambda s: s.real[:2] * 2)
    assert snaps.shape == (2, 2, 3) and snaps.dtype == F64
    np.testing.assert_array_equal(snaps[:, 0, 0].numpy(), [4.0, 8.0])
    assert final[0, 0] == 5
    final, snaps = loop.run_steps_with_snapshots(lambda s: s + 1, state, 4, 2)
    assert snaps.dtype == torch.complex128 and snaps.shape == (2, 4, 3)


# ------------------------------------------------------- the diagnostics

@pytest.mark.parametrize("shape", [(32, 32), (24, 32), (17, 17)])
def test_diagnostics_match_jax(shape):
    """energy_spectrum bins with a scatter-add in both packages: rel 1e-12
    on the CPU in fp64 (summation order)."""
    w = _w0(shape, seed=9)
    kb, e = diagnostics.energy_spectrum(_t(w))
    jkb, je = jax_diagnostics.energy_spectrum(jnp.asarray(w))
    np.testing.assert_array_equal(kb.numpy(), np.asarray(jkb))
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-12)
    dx, dy = 2 * np.pi / shape[0], 1.5 * np.pi / shape[1]
    got = diagnostics.invariants(_t(w), dx, dy)
    ref = jax_diagnostics.invariants(jnp.asarray(w), dx, dy)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(r) for r in ref], rtol=1e-12)


def test_energy_spectrum_of_the_half_spectrum_state():
    w = _w0((32, 32), seed=10)
    H = vortex.half_init(_t(w))
    _, e = diagnostics.energy_spectrum(H)
    packed = jnp.stack([jnp.asarray(H.real.numpy()),
                        jnp.asarray(H.imag.numpy())])
    _, je = jax_diagnostics.energy_spectrum(packed, packed=True)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-12)
    # ny given for an odd grid; inconsistent ny raises
    wo = _w0((17, 17), seed=10)
    _, eo = diagnostics.energy_spectrum(torch.fft.rfft2(_t(wo)), ny=17)
    _, ref = diagnostics.energy_spectrum(_t(wo))
    np.testing.assert_allclose(eo.numpy(), ref.numpy(), rtol=1e-13)
    with pytest.raises(ValueError, match="inconsistent"):
        diagnostics.energy_spectrum(H, ny=40)


def test_enstrophy_decays_and_energy_budget():
    """dE/dt = -2 nu Z over a short ps23 run (the budget the invariants
    exist for)."""
    cfg = vortex.VortexConfig(nx=32, ny=32, solver="ps23", dt=0.01,
                              t_final=0.2, re=100.0, ns=2)
    res = vortex.solve(cfg, F64, "cpu")
    inv = [diagnostics.invariants(s, cfg.dx, cfg.dy) for s in res.snapshots]
    e = [float(i[0]) for i in inv]
    z = [float(i[1]) for i in inv]
    assert z[0] > z[1] > z[2] and e[0] > e[1] > e[2]
    rate = (e[2] - e[0]) / 0.2
    assert abs(rate + 2.0 / cfg.re * z[1]) < 2e-2 * abs(rate)


# --------------------------------------------- presets, runner, interop

@pytest.mark.parametrize("name", ["vortex_merger_fdm", "tgv",
                                  "vortex_merger_hybrid",
                                  "vortex_merger_ps32",
                                  "vortex_merger_ps23"])
def test_presets_mirror_jax(name):
    ref = jax_presets.get(name)
    got = presets.get(name)
    assert got.family == ref.family == "vortex"
    assert got.reference == ref.reference
    assert got.cfg == interop.vortex_config_from_jax(ref.cfg)


def test_preset_count():
    assert len(presets.PRESETS) == 29
    assert set(presets.PRESETS) == set(jax_presets.PRESETS)


@pytest.mark.parametrize("name", ["tgv", "vortex_merger_ps23"])
def test_run_preset_files_match_jax(tmp_path, name):
    over = dict(nx=16, ny=16, t_final=0.04, ns=2)
    jm = jax_run_preset(name, outdir=str(tmp_path / "jax"), **over)
    m = run_preset(name, outdir=str(tmp_path / "torch"), dtype=F64,
                   device="cpu", **over)
    assert m["device"] == "cpu" and m["preset"] == name
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert "vm2.txt" in names and "vm3.txt" not in names
    for n in names:
        if n.startswith("vm"):
            np.testing.assert_allclose(np.loadtxt(tmp_path / "torch" / n),
                                       np.loadtxt(tmp_path / "jax" / n),
                                       rtol=0, atol=1e-12, err_msg=n)
    keys = {"wmax_final"} | ({"l2_error", "linf_error"} if name == "tgv"
                             else set())
    for k in keys:
        assert abs(m[k] - jm[k]) <= 1e-9 * abs(jm[k]), k
    if name == "tgv":
        assert (tmp_path / "torch" / "output.txt").read_text().split("=")[0] \
            == (tmp_path / "jax" / "output.txt").read_text().split("=")[0]


def test_cli_run_vortex_cpu(tmp_path):
    rc = cli.main(["run", "vortex_merger_hybrid", "--device", "cpu",
                   "--outdir", str(tmp_path), "--nx", "16", "--ny", "12",
                   "--t_final", "0.03", "--ns", "3"])
    assert rc == 0
    for name in ("vm1.txt", "vm2.txt", "vm3.txt", "metrics.json"):
        assert (tmp_path / name).exists(), name
    assert np.loadtxt(tmp_path / "vm3.txt").shape == (17 * 13, 3)


@pytest.mark.parametrize("field,value", [
    ("solver", "ps"), ("solver", "fdmm"), ("ic", "gauss"),
    ("rhs_impl", "pallas"), ("rhs_impl", "xla"), ("ns", 0),
])
def test_selector_typos_raise(field, value):
    """A typo'd or unported variant never silently runs the default."""
    with pytest.raises(ValueError):
        vortex.VortexConfig(**{field: value})


def test_unknown_impls_and_devices_raise():
    cfg = vortex.VortexConfig(nx=8, ny=8, solver="fdm")
    with pytest.raises(ValueError, match="spectral step"):
        vortex.make_spectral_step_half(cfg, F64, "cpu")
    with pytest.raises(ValueError, match="spectral step"):
        vortex.make_spectral_step(cfg, F64, "cpu")
    with pytest.raises(ValueError, match="fdm rhs impl"):
        vortex.fdm_rhs(torch.zeros(8, 8), 0.1, 0.1, 10.0, impl="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        vortex.make_fdm_rhs(dataclasses.replace(cfg, rhs_impl="kernel"),
                            F64, "cpu")
    with pytest.raises(ValueError, match="even grid sizes"):
        vortex.make_spectral_step_half(
            vortex.VortexConfig(nx=9, ny=8, solver="ps32"), F64, "cpu")(
                torch.zeros(9, 5, dtype=torch.complex128))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            vortex.solve(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            vortex.make_spectral_step_half(
                dataclasses.replace(cfg, solver="ps23"))


def test_config_from_jax():
    """Same field names and defaults; rhs_impl maps pallas->kernel,
    xla->torch; both pair_impl values and fft_impl auto/xla map to the one
    torch.fft path; the MXU FFT is not ported."""
    assert interop.vortex_config_from_jax(jax_vortex.VortexConfig()) \
        == vortex.VortexConfig()
    for kw, want in [(dict(rhs_impl="pallas"), dict(rhs_impl="kernel")),
                     (dict(rhs_impl="xla"), dict(rhs_impl="torch")),
                     (dict(pair_impl="rowsfirst", fft_impl="xla",
                           solver="ps23", nx=64), dict(solver="ps23", nx=64)),
                     (dict(fft_precision="high", ic="tgv", tgv_n=2),
                      dict(ic="tgv", tgv_n=2))]:
        assert interop.vortex_config_from_jax(
            jax_vortex.VortexConfig(**kw)) == vortex.VortexConfig(**want)
    with pytest.raises(ValueError, match="not ported"):
        interop.vortex_config_from_jax(
            jax_vortex.VortexConfig(fft_impl="matmul"))
    bogus = dataclasses.replace(jax_vortex.VortexConfig())
    object.__setattr__(bogus, "rhs_impl", "bogus")
    with pytest.raises(ValueError, match="not ported"):
        interop.vortex_config_from_jax(bogus)


def test_complex_state_round_trips_through_numpy():
    H = vortex.half_init(_t(_w0((8, 8))))
    back = interop.field_from_numpy(interop.to_numpy(H), F64, "cpu")
    assert back.dtype == torch.complex128 and torch.equal(back, H)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import cfd_julia_torch.ops.spectral, cfd_julia_torch.models.vortex\n"
        "import cfd_julia_torch.utils.diagnostics, cfd_julia_torch.run\n"
        "import cfd_julia_torch.interop, cfd_julia_torch.cli\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'cfd_julia_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
