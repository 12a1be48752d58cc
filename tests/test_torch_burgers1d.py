"""cfd_julia_torch 1D inviscid Burgers vs cfd_julia_tpu (reference ch.
05-08).

Every solver and boundary condition over a few SSP-RK3 steps in fp64
against the JAX package, within 1e-12 of the scale (operation order
only), snapshots included; the smooth-regime accuracy of
tests/test_burgers1d.py; the preset runner's files against the JAX
runner's; the 11 1D presets.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop, presets
from cfd_julia_torch.models import burgers1d
from cfd_julia_torch.run import run_preset
from cfd_julia_tpu import presets as jax_presets
from cfd_julia_tpu.models import burgers1d as jax_burgers1d
from cfd_julia_tpu.run import run_preset as jax_run_preset

torch.set_num_threads(1)

F64 = torch.float64
VARIANTS = [("weno", "dirichlet"), ("weno", "periodic"),
            ("crweno", "dirichlet"), ("crweno", "periodic"),
            ("central", "dirichlet"), ("flux_split", "periodic"),
            ("rusanov", "periodic")]


def _close(got, ref, rel=1e-12):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("solver,bc", VARIANTS)
def test_steps_match_jax(solver, bc):
    """40 steps on 64 cells past the shock's formation time (dt = 4e-3),
    with 4 snapshots, through the port's and JAX's solve."""
    jcfg = jax_burgers1d.BurgersConfig(nx=64, solver=solver, bc=bc, dt=4e-3,
                                       t_final=0.16, ns=4)
    cfg = interop.burgers_config_from_jax(jcfg)
    ref = jax_burgers1d.solve(jcfg, jnp.float64)
    got = burgers1d.solve(cfg, F64, "cpu")
    _close(got.x, ref.x)
    _close(got.snapshots, ref.snapshots)
    _close(got.u, ref.u)


@pytest.mark.parametrize("solver,bc", [("crweno", "dirichlet"),
                                       ("crweno", "periodic")])
def test_crweno_thomas_matches_jax(solver, bc):
    jcfg = jax_burgers1d.BurgersConfig(nx=48, solver=solver, bc=bc, dt=2e-3,
                                       t_final=0.02, ns=1,
                                       tridiag_method="thomas")
    ref = jax_burgers1d.solve(jcfg, jnp.float64)
    got = burgers1d.solve(interop.burgers_config_from_jax(jcfg), F64, "cpu")
    _close(got.u, ref.u)


@pytest.mark.parametrize("solver,bc", VARIANTS)
def test_rhs_matches_jax(solver, bc):
    """One RHS evaluation on a noisy wave."""
    jcfg = jax_burgers1d.BurgersConfig(nx=50, solver=solver, bc=bc)
    x = np.asarray(jax_burgers1d.grid_coords(jcfg, jnp.float64))
    u = np.sin(2 * np.pi * x) + 0.05 * np.random.default_rng(3) \
        .standard_normal(x.shape)
    got = burgers1d.make_rhs(interop.burgers_config_from_jax(jcfg))(
        torch.as_tensor(u))
    _close(got, jax_burgers1d.make_rhs(jcfg)(jnp.asarray(u)))


def exact_smooth(x, t, iters=60):
    """u = sin(2 pi (x - u t)) by fixed-point iteration (pre-shock)."""
    u = np.sin(2 * np.pi * x)
    for _ in range(iters):
        u = np.sin(2 * np.pi * (x - u * t))
    return u


@pytest.mark.parametrize("solver,bc,tol", [
    ("weno", "periodic", 2e-4), ("crweno", "periodic", 2e-4),
    ("weno", "dirichlet", 2e-4), ("crweno", "dirichlet", 2e-4),
    ("flux_split", "periodic", 2.5e-2), ("rusanov", "periodic", 5e-4),
    ("central", "dirichlet", 5e-3)])
def test_smooth_accuracy(solver, bc, tol):
    """tests/test_burgers1d.py's bounds (set at t = 0.1) against the
    characteristics solution at t = 0.05, well before the shock."""
    cfg = burgers1d.BurgersConfig(nx=128, solver=solver, bc=bc, dt=1e-4,
                                  t_final=0.05, ns=1)
    res = burgers1d.solve(cfg, F64, "cpu")
    err = np.abs(res.u.numpy() - exact_smooth(res.x.numpy(), 0.05)).max()
    assert err < tol, (solver, bc, err)


def test_central_periodic_and_unknown_names_raise():
    with pytest.raises(ValueError, match="dirichlet"):
        burgers1d.make_rhs(burgers1d.BurgersConfig(solver="central"))
    with pytest.raises(ValueError, match="Burgers solver"):
        burgers1d.make_rhs(burgers1d.BurgersConfig(solver="eno"))
    with pytest.raises(ValueError, match="bc"):
        burgers1d.make_rhs(burgers1d.BurgersConfig(bc="neumann"))


def test_presets_match_jax():
    """The 29 presets of the JAX package, the 11 1D ones among them with
    the same configurations and reference scripts."""
    assert set(presets.PRESETS) == set(jax_presets.PRESETS)
    one_d = 0
    for name, p in presets.PRESETS.items():
        jp = jax_presets.PRESETS[name]
        assert p.family == jp.family, name
        if p.family in ("heat", "burgers"):
            one_d += 1
            assert p.reference == jp.reference, name
            assert dataclasses.asdict(p.cfg) == dataclasses.asdict(jp.cfg)
    assert one_d == 11


def test_run_preset_files_match_jax(tmp_path):
    """burgers_crweno_periodic's snapshot file against the JAX runner's."""
    over = dict(nx=64, t_final=0.02)
    jm = jax_run_preset("burgers_crweno_periodic",
                        outdir=str(tmp_path / "jax"), **over)
    m = run_preset("burgers_crweno_periodic", outdir=str(tmp_path / "torch"),
                   dtype=F64, device="cpu", **over)
    assert m["output"] == jm["output"] == "solution_p_64.txt"
    got = np.loadtxt(tmp_path / "torch" / m["output"])
    ref = np.loadtxt(tmp_path / "jax" / jm["output"])
    assert got.shape == ref.shape == (64, 11)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-13)
    assert m["umax"] == pytest.approx(jm["umax"], rel=1e-12)
    assert m["tv"] == pytest.approx(jm["tv"], rel=1e-12)


@pytest.mark.parametrize("name", ["burgers_weno_dirichlet", "burgers_central",
                                  "burgers_flux_splitting", "burgers_riemann"])
def test_cli_runs_burgers_presets(tmp_path, name):
    """Each through the CLI at a short final time: its snapshot file,
    bounded and finite."""
    assert cli.main(["run", name, "--device", "cpu", "--outdir",
                     str(tmp_path), "--t_final", "0.01"]) == 0
    cfg = presets.get(name).cfg
    tag = "d" if cfg.bc == "dirichlet" else "p"
    data = np.loadtxt(tmp_path / f"solution_{tag}_{cfg.nx}.txt")
    assert np.isfinite(data).all() and np.abs(data[:, 1:]).max() <= 1.0 + 1e-6
