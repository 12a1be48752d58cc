"""cfd_julia_torch multigrid and iterative Poisson solves vs cfd_julia_tpu.

The same problem goes through the JAX solver and the port in fp64 on the
CPU: iteration counts must be equal, solutions within 1e-10, and residual
histories within rel 1e-9 of their scale (the last cycles' rms sits at the
fp64 roundoff floor of the residual, where operation order alone moves it
by ~1e-7 of its own size).  JAX's fused="on" runs its Pallas level edges in
interpret mode.  The mixed-precision pyramid is held to the contract of
tests/test_poisson2d.py (bf16 rounds differently in the two frameworks).
Also: the preset runner's files, the CLI, config interop and the unported
options that must raise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop
from cfd_julia_torch.models import poisson2d
from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.poisson import multigrid
from cfd_julia_torch.run import run_preset
from cfd_julia_torch.utils import io
from cfd_julia_tpu.models import poisson2d as jax_poisson2d
from cfd_julia_tpu.poisson import multigrid as jax_multigrid
from cfd_julia_tpu.run import run_preset as jax_run_preset
from cfd_julia_tpu.utils import io as jax_io

torch.set_num_threads(1)


def _history(h, n):
    return np.asarray(h, np.float64)[:n]


def _assert_history_close(got, ref):
    assert got.shape == ref.shape
    scale = np.abs(ref[0])
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * scale.max())


def _problem(nx, ny, mgc):
    cfg = jax_poisson2d.PoissonConfig(nx=nx, ny=ny, solver="multigrid",
                                      problem="poly", mg=mgc)
    _, _, _, _, ue, f = jax_poisson2d.build_problem(cfg, jnp.float64)
    return cfg, f, jax_poisson2d._dirichlet_init(ue)


@pytest.mark.parametrize("nx,ny,opts", [
    (64, 64, dict(fused="off")),
    (64, 64, dict(fused="on")),
    (64, 64, dict(fmg=True, transfers="matmul")),
    (64, 32, dict(transfers="conv")),
    (64, 32, dict(fused="off", transfers="reshape", fmg=True)),
    (64, 64, dict(n_levels=9, v1=3, v3=1)),
    (32, 32, dict(smoother="cheb", tol=1e-6)),
], ids=["off", "on", "fmg_matmul", "64x32_conv", "64x32_off_reshape_fmg",
        "clamped_levels", "cheb"])
def test_multigrid_solve_matches_jax(nx, ny, opts):
    mgc = jax_multigrid.MGConfig(**{"tol": 1e-9, "max_cycles": 30, **opts})
    cfg, f, u0 = _problem(nx, ny, mgc)
    ref = jax_multigrid.solve(f, u0, cfg.dx, cfg.dy, cfg=mgc)
    tcfg = interop.mg_config_from_jax(mgc)
    got = multigrid.solve(interop.field_from_numpy(f, torch.float64),
                          interop.field_from_numpy(u0, torch.float64),
                          cfg.dx, cfg.dy, cfg=tcfg)
    assert got.iterations == int(ref.iterations) > 0
    assert got.n_records == int(ref.n_records)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=1e-10)
    _assert_history_close(_history(got.history, got.n_records),
                          _history(ref.history, got.n_records))
    assert np.isnan(got.history.numpy()[got.n_records:]).all()
    np.testing.assert_allclose(float(got.rms0), float(ref.rms0), rtol=1e-12)


def test_levels_clamped_like_jax():
    for n_levels in (0, 3, 9):
        for nx, ny in ((128, 128), (20, 16), (80, 64)):
            assert multigrid._build_levels(nx, ny, 1 / nx, 1 / ny, n_levels) \
                == jax_multigrid._build_levels(nx, ny, 1 / nx, 1 / ny,
                                               n_levels)


def test_mixed_pyramid_contract():
    """cycle_dtype='mixed' (finest level fp32, coarser levels bf16) by the
    contract of test_poisson2d.test_mg_mixed_precision_pyramid: at most
    one cycle more than fp32, and max|u - ue| within 1.5x fp32's."""
    errs, cycles = {}, {}
    for cd in ("fp32", "mixed"):
        mgc = multigrid.MGConfig(tol=1e-5, max_cycles=30, cycle_dtype=cd)
        cfg = poisson2d.PoissonConfig(nx=64, ny=64, solver="multigrid",
                                      problem="poly", mg=mgc)
        res = poisson2d.solve(cfg, torch.float32, "cpu")
        assert float(res.rms / res.rms0) <= 1e-5, cd
        assert res.u.dtype == torch.float32
        errs[cd] = float(res.linf_error)
        cycles[cd] = res.iterations
    assert cycles["mixed"] <= cycles["fp32"] + 1, cycles
    assert errs["mixed"] <= 1.5 * errs["fp32"] + 1e-6, errs


@pytest.mark.parametrize("solver,over", [
    ("jacobi", dict(nx=16, ny=16, tol=1e-6, freq=50)),
    ("redblack", dict(nx=16, ny=24, tol=1e-8, freq=20)),
    ("cg", dict(nx=24, ny=16, tol=1e-9, freq=5)),
    ("multigrid", dict(nx=32, ny=32)),
    ("mgcg", dict(nx=32, ny=32, tol=1e-9)),
])
def test_poisson2d_solve_matches_jax(solver, over):
    jcfg = jax_poisson2d.PoissonConfig(solver=solver, problem="poly",
                                       **over)
    ref = jax_poisson2d.solve(jcfg, jnp.float64)
    got = poisson2d.solve(interop.poisson_config_from_jax(jcfg),
                          torch.float64, "cpu")
    assert got.iterations == int(ref.iterations) > 0
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(got.l2_error), float(ref.l2_error),
                               rtol=0, atol=1e-10)
    n = int(np.sum(~np.isnan(np.asarray(ref.history)[:, 0])))
    _assert_history_close(_history(got.history, n),
                          _history(ref.history, n))


@pytest.mark.parametrize("problem", ["sine32", "poly", "sine16"])
def test_build_problem_matches_jax(problem):
    jcfg = jax_poisson2d.PoissonConfig(nx=16, ny=24, problem=problem)
    ref = jax_poisson2d.build_problem(jcfg, jnp.float64)
    got = poisson2d.build_problem(poisson2d.PoissonConfig(
        nx=16, ny=24, problem=problem), torch.float64)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13,
                                   atol=1e-13)
    u0 = poisson2d._dirichlet_init(got[4])
    np.testing.assert_allclose(
        u0.numpy(), np.asarray(jax_poisson2d._dirichlet_init(ref[4])),
        rtol=1e-13, atol=1e-13)
    assert not u0[1:-1, 1:-1].any()


def test_norms_match_jax():
    from cfd_julia_torch.ops import norms
    from cfd_julia_tpu.ops import norms as jax_norms

    rng = np.random.default_rng(0)
    f, u = rng.standard_normal((2, 17, 13))
    r1 = rng.standard_normal(9)
    for name in ("l2norm_interior", "l2norm_bounds", "linf"):
        for a in (u, r1):
            np.testing.assert_allclose(
                float(getattr(norms, name)(torch.as_tensor(a))),
                float(getattr(jax_norms, name)(jnp.asarray(a))), rtol=1e-14)
    np.testing.assert_allclose(
        norms.residual_poisson(torch.as_tensor(f), torch.as_tensor(u), 0.1,
                               0.2).numpy(),
        np.asarray(jax_norms.residual_poisson(jnp.asarray(f), jnp.asarray(u),
                                              0.1, 0.2)),
        rtol=1e-13, atol=1e-12)


def _columns(path):
    return np.loadtxt(path, ndmin=2)


def test_run_preset_files_match_jax(tmp_path):
    """`run poisson_mgN` at 64^2 in fp64: the same three files as the JAX
    runner, within the solve's tolerances."""
    over = dict(nx=64, ny=64)
    jm = jax_run_preset("poisson_mgN", outdir=str(tmp_path / "jax"), **over)
    m = run_preset("poisson_mgN", outdir=str(tmp_path / "torch"),
                   dtype=torch.float64, device="cpu", **over)
    assert m["device"] == "cpu" and m["iterations"] == jm["iterations"]
    np.testing.assert_allclose(m["l2_error"], jm["l2_error"], rtol=0,
                               atol=1e-10)
    got = _columns(tmp_path / "torch" / "field_final.txt")
    ref = _columns(tmp_path / "jax" / "field_final.txt")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    _assert_history_close(
        _columns(tmp_path / "torch" / "multigrid_residual.txt"),
        _columns(tmp_path / "jax" / "multigrid_residual.txt"))
    lines = (tmp_path / "torch" / "output.txt").read_text().splitlines()
    ref_lines = (tmp_path / "jax" / "output.txt").read_text().splitlines()
    assert [ln.split("=")[0] for ln in lines] == \
        [ln.split("=")[0] for ln in ref_lines]
    assert lines[-1] == ref_lines[-1]        # Iterations=...
    assert (tmp_path / "torch" / "metrics.json").exists()


def test_io_writers_match_jax(tmp_path):
    hist = np.full((5, 3), np.nan)
    hist[:3] = [[1, 0.5, 0.25], [2, 0.125, 1 / 3], [3, 1e-9, 2e-10]]
    for mod, d in ((io, "torch"), (jax_io, "jax")):
        mod.write_error_report(tmp_path / d / "err.txt", 1.5, 2.5,
                               {"Iterations": 3})
        mod.write_residual_report(tmp_path / d / "res.txt", 0.1, 0.2, 7)
        mod.write_residual_history(tmp_path / d / "hist.txt", hist)
        mod.write_residual_history(tmp_path / d / "hist2.txt", hist, 2)
    for name in ("err.txt", "res.txt", "hist.txt", "hist2.txt"):
        assert (tmp_path / "torch" / name).read_text() == \
            (tmp_path / "jax" / name).read_text(), name
    io.write_residual_history(tmp_path / "t.txt", torch.as_tensor(hist))
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "jax" / "hist.txt").read_text()


def test_cli_run_poisson_cpu(tmp_path):
    """`run poisson_mgN --device cpu` with flat-field overrides."""
    rc = cli.main(["run", "poisson_mgN", "--device", "cpu", "--outdir",
                   str(tmp_path), "--nx", "32", "--ny", "16", "--tol",
                   "1e-7"])
    assert rc == 0
    for name in ("output.txt", "multigrid_residual.txt", "field_final.txt",
                 "metrics.json"):
        assert (tmp_path / name).exists(), name
    assert len(_columns(tmp_path / "field_final.txt")) == 33 * 17


def test_presets_mirror_jax():
    from cfd_julia_torch import presets
    from cfd_julia_tpu import presets as jax_presets

    for name in ("poisson_jacobi", "poisson_gs_redblack", "poisson_cg",
                 "poisson_mg2", "poisson_mgcg", "poisson_mgN"):
        ref = jax_presets.get(name)
        got = presets.get(name)
        assert got.family == ref.family == "poisson"
        assert got.cfg == interop.poisson_config_from_jax(ref.cfg), name


@pytest.mark.parametrize("field,value", [
    ("smoother", "pallas"), ("smoother", "xla"), ("smoother", "cheb"),
    ("cycle_dtype", "mixed"), ("transfers", "matmul"), ("fused", "off"),
])
def test_mg_config_from_jax_maps(field, value):
    jcfg = dataclasses.replace(jax_multigrid.MGConfig(), **{field: value})
    got = interop.mg_config_from_jax(jcfg)
    want = {("smoother", "pallas"): dict(impl="kernel"),
            ("smoother", "xla"): dict(impl="torch"),
            ("smoother", "cheb"): dict(smoother="cheb")}.get(
                (field, value), {field: value})
    assert got == dataclasses.replace(multigrid.MGConfig(), **want)


@pytest.mark.parametrize("nx,ny", [(32, 32), (24, 40)])
@pytest.mark.parametrize("solver", ["fft", "fft_spectral", "fst"])
def test_direct_solvers_match_jax(solver, nx, ny):
    """The FFT and DST-I direct solves on the sine32 problem against the
    JAX package's: solution within 1e-12 of the scale, the same error
    norms, and no iterative fields."""
    jcfg = jax_poisson2d.PoissonConfig(nx=nx, ny=ny, solver=solver,
                                       problem="sine32")
    ref = jax_poisson2d.solve(jcfg, jnp.float64)
    cfg = interop.poisson_config_from_jax(jcfg)
    assert cfg.solver == solver
    res = poisson2d.solve(cfg, torch.float64, "cpu")
    u_ref = np.asarray(ref.u)
    assert np.abs(res.u.numpy() - u_ref).max() <= 1e-12 * np.abs(u_ref).max()
    # fft_spectral is exact on sine32: its error is roundoff, hence atol
    np.testing.assert_allclose(float(res.l2_error), float(ref.l2_error),
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(float(res.linf_error), float(ref.linf_error),
                               rtol=1e-9, atol=1e-13)
    assert res.iterations is None and res.history is None
    assert res.rms is None and res.rms0 is None and ref.iterations is None


@pytest.mark.parametrize("name", ["poisson_fft", "poisson_fft_spectral",
                                  "poisson_fst"])
def test_direct_presets_and_runner_match_jax(tmp_path, name):
    """The three direct presets mirror the JAX package's, and the runner
    writes a direct solve's files (an error report, no residual history)
    as the JAX runner does."""
    from cfd_julia_torch import presets
    from cfd_julia_tpu import presets as jax_presets

    ref = jax_presets.get(name)
    assert presets.get(name).cfg == interop.poisson_config_from_jax(ref.cfg)
    over = dict(nx=16, ny=16)
    jm = jax_run_preset(name, outdir=str(tmp_path / "jax"), **over)
    m = run_preset(name, outdir=str(tmp_path / "torch"),
                   dtype=torch.float64, device="cpu", **over)
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["field_final.txt", "metrics.json", "output_16.txt"]
    assert "iterations" not in m and "rms_final" not in m
    np.testing.assert_allclose(m["linf_error"], jm["linf_error"], rtol=1e-9,
                               atol=1e-13)
    np.testing.assert_allclose(
        _columns(tmp_path / "torch" / "field_final.txt"),
        _columns(tmp_path / "jax" / "field_final.txt"), rtol=0, atol=1e-12)
    lines = (tmp_path / "torch" / "output_16.txt").read_text().splitlines()
    ref_lines = (tmp_path / "jax" / "output_16.txt").read_text().splitlines()
    assert [ln.split("=")[0] for ln in lines] == \
        [ln.split("=")[0] for ln in ref_lines]


@pytest.mark.parametrize("jcfg", [
    jax_multigrid.MGConfig(cycle_dtype="bf16"),
    jax_multigrid.MGConfig(smoother="bogus"),
    jax_poisson2d.PoissonConfig(solver="sor"),
    jax_poisson2d.PoissonConfig(solver="fft_mxu"),
])
def test_config_from_jax_rejects_unported(jcfg):
    convert = (interop.mg_config_from_jax
               if isinstance(jcfg, jax_multigrid.MGConfig)
               else interop.poisson_config_from_jax)
    with pytest.raises(ValueError, match="not ported"):
        convert(jcfg)


def _small():
    cfg = poisson2d.PoissonConfig(nx=8, ny=8, solver="multigrid",
                                  problem="poly")
    _, _, _, _, ue, f = poisson2d.build_problem(cfg, torch.float64)
    return f, poisson2d._dirichlet_init(ue), cfg.dx, cfg.dy


@pytest.mark.parametrize("opts,exc,match", [
    (dict(cycle_dtype="bf16"), NotImplementedError, "A.0"),
    (dict(cycle_dtype="fp16"), ValueError, "cycle_dtype"),
    (dict(impl="kernel"), ValueError, "CUDA device"),
    (dict(impl="pallas"), ValueError, "impl"),
    (dict(fused="yes"), ValueError, "fused"),
    (dict(transfers="fft"), ValueError, "transfers"),
    (dict(smoother="jacobi"), ValueError, "smoother"),
])
def test_mg_unported_options_raise(opts, exc, match):
    f, u0, dx, dy = _small()
    with pytest.raises(exc, match=match):
        multigrid.solve(f, u0, dx, dy, multigrid.MGConfig(**opts))


def test_mg_mesh_and_fft_solvers_raise():
    f, u0, dx, dy = _small()
    # the mesh solve is ported (tests/test_torch_parallel.py); it refuses a
    # single-device option before it touches the mesh
    with pytest.raises(ValueError, match="transfers"):
        multigrid.solve(f, u0, dx, dy, multigrid.MGConfig(transfers="conv"),
                        mesh=object())
    for solver in ("fft", "fft_spectral", "fst"):
        res = poisson2d.solve(poisson2d.PoissonConfig(nx=8, ny=8,
                                                      solver=solver),
                              torch.float64, "cpu")
        assert res.u.shape == (9, 9) and res.iterations is None
    with pytest.raises(ValueError, match="unknown solver"):
        poisson2d.solve(poisson2d.PoissonConfig(nx=8, ny=8, solver="sor"),
                        torch.float64, "cpu")


def test_cpu_solve_counts_no_launches():
    f, u0, dx, dy = _small()
    cuda_kernels.reset_launch_counts()
    res = multigrid.solve(f, u0, dx, dy, multigrid.MGConfig(fmg=True))
    assert res.iterations > 0
    assert all(v == 0 for v in cuda_kernels.LAUNCHES.values())


def test_history_and_counters_are_host_side():
    f, u0, dx, dy = _small()
    res = multigrid.solve(f, u0, dx, dy,
                          multigrid.MGConfig(tol=1e-6, max_cycles=4))
    assert isinstance(res.iterations, int) and isinstance(res.n_records, int)
    assert res.history.shape == (5, 3)
    h = res.history.numpy()
    np.testing.assert_array_equal(h[:res.n_records, 0],
                                  np.arange(1, res.n_records + 1))
    assert np.isnan(h[res.n_records:]).all()

