"""cfd_julia_torch 1D Euler (Sod shock tube) vs cfd_julia_tpu.

The same seeded numpy state goes through the JAX RHS (the XLA form and
the Pallas kernel in interpret mode) and the port's (its torch path and
the CUDA kernel wrapper, which takes its plain twin for CPU tensors) in
fp64, where the only admissible difference is the order of floating-point
operations.  Also: SSP-RK3, the snapshot loop, whole trajectories, Sod
against the exact Riemann solution, conservation, fp32, interop, presets,
the preset runner's files and the CLI.  The kernel itself is held against
its twin on a GPU in tests/test_torch_cuda.py.
"""
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop
from cfd_julia_torch import presets as torch_presets
from cfd_julia_torch.models import euler1d
from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.run import run_preset
from cfd_julia_torch.stepping import loop, ssprk3
from cfd_julia_tpu import presets as jax_presets
from cfd_julia_tpu.models import euler1d as jax_euler1d
from cfd_julia_tpu.ops import pallas_kernels
from cfd_julia_tpu.run import run_preset as jax_run_preset
from cfd_julia_tpu.stepping import ssprk3 as jax_ssprk3

from test_euler1d import exact_sod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = [("roe", "roe"), ("hllc", "roe"), ("rusanov", "roe"),
            ("rusanov", "spectral")]
VARIANT_IDS = ["roe", "hllc", "rusanov-roe", "rusanov-spectral"]


def _random_state(nx, seed, gamma=1.4):
    """Physical cells: rho, p in [0.1, 2], u in [-1.5, 1.5]
    (tests/test_euler1d.py)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.1, 2.0, nx)
    u = rng.uniform(-1.5, 1.5, nx)
    p = rng.uniform(0.1, 2.0, nx)
    return np.stack([rho, rho * u, p / (gamma - 1) + 0.5 * rho * u**2])


def _cfg(solver, wavespeed, **kw):
    return euler1d.EulerConfig(solver=solver, rusanov_wavespeed=wavespeed,
                               **kw)


def _jax_cfg(cfg, rhs_impl="xla"):
    return jax_euler1d.EulerConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "rhs_impl": rhs_impl})


def _assert_rel(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype,jdtype", [(torch.float64, jnp.float64),
                                          (torch.float32, jnp.float32)])
def test_sod_initial_state_matches_jax(dtype, jdtype):
    cfg = euler1d.EulerConfig(nx=100)
    x, q = euler1d.sod_initial_state(cfg, dtype, "cpu")
    jx, jq = jax_euler1d.sod_initial_state(_jax_cfg(cfg), jdtype)
    assert q.dtype == dtype and q.shape == (3, 100)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("state", ["sod", "random"])
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_rhs_matches_jax_xla_and_pallas(variant, state):
    """make_rhs's torch path and euler_rhs_fused on CPU tensors vs JAX's
    XLA RHS and the Pallas kernel in interpret mode, nx=128, within 1e-12
    of the scale; the CPU wrapper call counts no launch."""
    solver, wavespeed = variant
    cfg = _cfg(solver, wavespeed, nx=128)
    if state == "sod":
        _, q = euler1d.sod_initial_state(cfg, torch.float64, "cpu")
        q_np = q.numpy()
    else:
        q_np = _random_state(cfg.nx, seed=11)
    jq = jnp.asarray(q_np)
    ref_xla = np.asarray(jax_euler1d.make_rhs(_jax_cfg(cfg))(jq))
    ref_pal = np.asarray(pallas_kernels.euler_rhs_fused(
        jq, cfg.gamma, cfg.dx, solver, interpret=True,
        rusanov_wavespeed=wavespeed))
    q_t = interop.field_from_numpy(q_np, torch.float64, "cpu")
    before = dict(cuda_kernels.LAUNCHES)
    got_rhs = euler1d.make_rhs(cfg, "cpu")(q_t).numpy()
    got_wrap = cuda_kernels.euler_rhs_fused(q_t, cfg.gamma, cfg.dx, solver,
                                            wavespeed).numpy()
    assert cuda_kernels.LAUNCHES == before
    np.testing.assert_array_equal(got_rhs, got_wrap)
    for ref in (ref_xla, ref_pal):
        _assert_rel(got_rhs, ref, 1e-12)


def test_wrapper_cpu_is_plain_and_uncounted():
    q = interop.field_from_numpy(_random_state(17, seed=2), torch.float64)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.euler_rhs_fused(q, 1.4, 1 / 17, "hllc")
    assert torch.equal(got, cuda_kernels.euler_rhs_fused_plain(
        q, 1.4, 1 / 17, "hllc"))
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError), ("int64", TypeError), ("1d", ValueError),
    ("four_rows", ValueError), ("nx2", ValueError), ("meta", ValueError),
    ("solver", ValueError), ("wavespeed", ValueError),
])
def test_wrapper_rejects(case, exc):
    q = torch.ones(3, 8, dtype=torch.float64)
    args = {"solver": "hllc", "rusanov_wavespeed": "roe"}
    if case == "float16":
        q = q.half()
    elif case == "int64":
        q = q.long()
    elif case == "1d":
        q = q[0]
    elif case == "four_rows":
        q = torch.ones(4, 8, dtype=torch.float64)
    elif case == "nx2":
        q = q[:, :2]
    elif case == "meta":
        q = q.to("meta")
    elif case == "solver":
        args["solver"] = "hll"
    else:
        args["rusanov_wavespeed"] = "fast"
    with pytest.raises(exc):
        cuda_kernels.euler_rhs_fused(q, 1.4, 0.1, **args)


@pytest.mark.parametrize("field,value", [
    ("rhs_impl", "kernel"), ("rhs_impl", "pallas"), ("rhs_impl", "xla"),
    ("solver", "hll"), ("rusanov_wavespeed", "fast"),
])
def test_make_rhs_rejects(field, value):
    """rhs_impl="kernel" on the CPU and typo'd or unported variants raise
    instead of silently running the default."""
    cfg = dataclasses.replace(euler1d.EulerConfig(nx=8), **{field: value})
    with pytest.raises(ValueError):
        euler1d.make_rhs(cfg, "cpu")


@pytest.mark.parametrize("as_tuple", [False, True], ids=["tensor", "tuple"])
def test_ssprk3_step_matches_jax(as_tuple):
    """One SSP-RK3 step of a nonlinear RHS, on a tensor and on a tuple."""
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(16), rng.standard_normal(16)

    def rhs_t(u):
        return tuple(-x * x for x in u) if as_tuple else torch.sin(u)

    def rhs_j(u):
        return tuple(-x * x for x in u) if as_tuple else jnp.sin(u)

    u_t = (torch.tensor(a), torch.tensor(b)) if as_tuple else torch.tensor(a)
    u_j = (jnp.asarray(a), jnp.asarray(b)) if as_tuple else jnp.asarray(a)
    got = ssprk3.ssprk3_step(rhs_t, u_t, 0.1)
    ref = jax_ssprk3.ssprk3_step(rhs_j, u_j, 0.1)
    got = got if as_tuple else (got,)
    ref = ref if as_tuple else (ref,)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-14)


def test_ssprk3_step_with_post_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal(16)
    got = ssprk3.ssprk3_step_with_post(torch.cos, lambda u: u.clamp(-0.5, 2),
                                       torch.tensor(a), 0.2)
    ref = jax_ssprk3.ssprk3_step_with_post(
        jnp.cos, lambda u: jnp.clip(u, -0.5, 2), jnp.asarray(a), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14)


@pytest.mark.parametrize("nt,every", [(10, 3), (9, 3), (2, 5), (7, 1)])
def test_run_steps_with_snapshots_positions(nt, every):
    """Snapshots after steps every, 2*every, ...; nt % every leftover steps
    after the last."""
    final, snaps = loop.run_steps_with_snapshots(
        lambda s: s + 1, torch.zeros(2), nt, every)
    assert float(final[0]) == nt
    assert snaps.shape == (nt // every, 2)
    assert snaps[:, 0].tolist() == [float(every * (c + 1))
                                    for c in range(nt // every)]


def test_run_steps_with_snapshots_rejects_zero_every():
    with pytest.raises(ValueError):
        loop.run_steps_with_snapshots(lambda s: s, torch.zeros(1), 4, 0)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_solve_matches_jax(variant):
    """Whole trajectories, snapshots included, nx=128, 200 steps, fp64."""
    solver, wavespeed = variant
    cfg = _cfg(solver, wavespeed, nx=128, dt=1e-4, t_final=0.02, ns=4)
    res = euler1d.solve(cfg, torch.float64, "cpu")
    ref = jax_euler1d.solve(_jax_cfg(cfg), jnp.float64)
    assert res.snapshots.shape == (5, 3, 128)
    np.testing.assert_array_equal(res.x.numpy(), np.asarray(ref.x))
    np.testing.assert_allclose(res.q.numpy(), np.asarray(ref.q), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.snapshots.numpy(),
                               np.asarray(ref.snapshots), rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def sod_runs():
    """t=0.2 at nx=128 (dt=4e-4, 500 steps) for each solver, fp64."""
    return {solver: (cfg, euler1d.solve(cfg, torch.float64, "cpu"))
            for solver in ("roe", "hllc", "rusanov")
            for cfg in [euler1d.EulerConfig(nx=128, solver=solver, dt=4e-4,
                                            ns=1)]}


# density / pressure L1 errors against exact Sod at nx=128, t=0.2 are
# 3.1e-3 .. 5.1e-3 in fp64 (roe 3.9e-3, hllc 4.0e-3, rusanov 5.1e-3 in
# density); the bounds leave ~25% headroom
@pytest.mark.parametrize("solver,l1_tol", [("roe", 5e-3), ("hllc", 5e-3),
                                           ("rusanov", 6.5e-3)])
def test_sod_profile_vs_exact(sod_runs, solver, l1_tol):
    cfg, res = sod_runs[solver]
    rho_e, u_e, p_e = exact_sod(res.x.numpy(), cfg.t_final)
    rho, u, p, _ = euler1d.primitives_from_result(res, cfg.gamma)
    assert np.abs(rho.numpy() - rho_e).mean() < l1_tol
    assert np.abs(p.numpy() - p_e).mean() < l1_tol
    assert bool((rho > 0).all()) and bool((p > 0).all())


def test_conservation(sod_runs):
    """Mass and energy have zero boundary flux (u=0 at both ends until the
    waves arrive); total momentum grows at the exact rate pL - pR."""
    cfg, res = sod_runs["hllc"]
    d_tot = (res.q.sum(dim=1) - res.snapshots[0].sum(dim=1)).numpy() * cfg.dx
    assert abs(d_tot[0]) < 1e-12
    assert abs(d_tot[2]) < 1e-12
    assert abs(d_tot[1] - (cfg.p_l - cfg.p_r) * cfg.t_final) < 1e-10


def test_solvers_agree(sod_runs):
    q = {s: sod_runs[s][1].q.numpy() for s in sod_runs}
    assert np.abs(q["roe"] - q["hllc"]).max() < 0.05
    assert np.abs(q["roe"] - q["rusanov"]).max() < 0.08


def test_fp32_matches_fp64():
    """fp32 within 5e-4 of fp64 (tests/test_precision.py's bound), hllc
    nx=128 to t=0.1."""
    cfg = euler1d.EulerConfig(nx=128, solver="hllc", dt=4e-4, t_final=0.1,
                              ns=1)
    q32 = euler1d.solve(cfg, torch.float32, "cpu").q
    q64 = euler1d.solve(cfg, torch.float64, "cpu").q
    assert q32.dtype == torch.float32
    assert float((q32.double() - q64).abs().max()) < 5e-4


def test_config_from_jax():
    """Same fields and defaults; rhs_impl xla -> torch, pallas -> kernel."""
    assert interop.euler_config_from_jax(
        jax_euler1d.EulerConfig()) == euler1d.EulerConfig()
    for jax_impl, impl in (("xla", "torch"), ("pallas", "kernel"),
                           ("auto", "auto")):
        jcfg = jax_euler1d.EulerConfig(rhs_impl=jax_impl)
        assert interop.euler_config_from_jax(jcfg).rhs_impl == impl
    with pytest.raises(ValueError, match="not ported"):
        interop.euler_config_from_jax(
            jax_euler1d.EulerConfig(rhs_impl="bogus"))


@pytest.mark.parametrize("name", ["euler_roe", "euler_hllc", "euler_rusanov"])
def test_presets_match_jax(name):
    mine, ref = torch_presets.get(name), jax_presets.get(name)
    assert mine.family == ref.family == "euler"
    assert mine.reference == ref.reference
    assert interop.euler_config_from_jax(ref.cfg) == mine.cfg


def test_run_preset_files_match_jax(tmp_path):
    """solution_{d,v,e}.txt of the port's runner against the JAX runner's
    (euler_roe at nx=128, dt=2e-4, fp64)."""
    over = dict(nx=128, dt=2e-4)
    jax_m = jax_run_preset("euler_roe", outdir=str(tmp_path / "jax"), **over)
    m = run_preset("euler_roe", outdir=str(tmp_path / "torch"),
                   dtype=torch.float64, device="cpu", **over)
    assert m["device"] == "cpu" and m["preset"] == "euler_roe"
    for key in ("rho_min", "p_min"):
        assert abs(m[key] - jax_m[key]) <= 1e-10
    for tag in "dve":
        got = np.loadtxt(tmp_path / "torch" / f"solution_{tag}.txt")
        ref = np.loadtxt(tmp_path / "jax" / f"solution_{tag}.txt")
        assert got.shape == ref.shape == (128, 21)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    assert (tmp_path / "torch" / "metrics.json").exists()


def test_cli_run_cpu(tmp_path):
    rc = cli.main(["run", "euler_roe", "--device", "cpu", "--outdir",
                   str(tmp_path), "--nx", "32", "--dt", "1e-3",
                   "--t_final", "0.01", "--solver", "rusanov",
                   "--rusanov_wavespeed", "spectral"])
    assert rc == 0
    for name in ("solution_d.txt", "solution_v.txt", "solution_e.txt",
                 "metrics.json"):
        assert (tmp_path / name).exists(), name
    # nt = 10, ns = 20 -> a snapshot after every step
    assert np.loadtxt(tmp_path / "solution_d.txt").shape == (32, 11)


def test_chip_smoke_exact_sod_is_the_tests_copy():
    """chip_smoke.py carries its own exact Sod solver (the GPU machine has
    no JAX); it must equal tests/test_euler1d.exact_sod."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    x = (np.arange(400) + 0.5) / 400
    for t in (0.05, 0.2):
        for got, ref in zip(chip_smoke.exact_sod(x, t), exact_sod(x, t)):
            np.testing.assert_array_equal(got, ref)


def test_sod_on_three_cells_leaves_finite_states_as_jax_does():
    """fp64 hllc Sod on nx = 3 at dt = 1e-4*256/3 turns non-finite after a
    few steps in the JAX package too, at the same step as in the port: the
    reference algorithm's behaviour, not a fault of the port.  Before that
    step the two agree within 1e-12 of the state's scale while the state
    is physical (rho, p > 0), and within 1e-10 from there on, where the
    state grows by ~1e12 a step and amplifies the roundoff with it."""
    cfg = euler1d.EulerConfig(nx=3, solver="hllc", dt=1e-4 * 256 / 3)
    jcfg = _jax_cfg(cfg)
    _, q = euler1d.sod_initial_state(cfg, torch.float64, "cpu")
    _, jq = jax_euler1d.sod_initial_state(jcfg, jnp.float64)
    rhs, jrhs = euler1d.make_rhs(cfg, "cpu"), jax_euler1d.make_rhs(jcfg)
    physical_steps = 0
    for step in range(1, 21):
        q = ssprk3.ssprk3_step(rhs, q, cfg.dt)
        jq = jax_ssprk3.ssprk3_step(jrhs, jq, cfg.dt)
        got, ref = q.numpy(), np.asarray(jq)
        finite = (bool(np.isfinite(got).all()), bool(np.isfinite(ref).all()))
        if not all(finite):
            break
        rho = ref[0]
        p = (cfg.gamma - 1) * (ref[2] - 0.5 * ref[1] ** 2 / rho)
        physical = bool((rho > 0).all() and (p > 0).all())
        physical_steps += physical
        _assert_rel(got, ref, 1e-12 if physical else 1e-10)
    assert finite == (False, False), f"step {step}: finite {finite}"
    assert physical_steps >= 1 and step < 20
