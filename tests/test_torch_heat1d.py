"""cfd_julia_torch 1D heat equation vs cfd_julia_tpu (reference ch. 01-04).

Every scheme and tridiagonal method over a few steps in fp64 against the
JAX package, within 1e-12 of the scale (operation order only); the golden
L2 errors of tests/test_heat1d.py at the reference resolution; the preset
runner's files against the JAX runner's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop
from cfd_julia_torch.models import heat1d
from cfd_julia_torch.run import run_preset
from cfd_julia_tpu.models import heat1d as jax_heat1d
from cfd_julia_tpu.run import run_preset as jax_run_preset

torch.set_num_threads(1)

F64 = torch.float64
SCHEMES = ["ftcs", "rk3", "cn", "icp"]


def _close(got, ref, rel=1e-12):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_steps_match_jax(scheme, method):
    """12 steps with the history kept, on a 40-cell grid."""
    jcfg = jax_heat1d.HeatConfig(nx=40, dt=0.0025, t_final=0.03,
                                 scheme=scheme, tridiag_method=method)
    cfg = interop.heat_config_from_jax(jcfg)
    assert cfg.nt == jcfg.nt == 12 and cfg.alpha == jcfg.alpha
    ref = jax_heat1d.solve(jcfg, jnp.float64, keep_history=True)
    got = heat1d.solve(cfg, F64, "cpu", keep_history=True)
    _close(got.x, ref.x)
    _close(got.u, ref.u)
    _close(got.history, ref.history)
    _close(got.u_exact, ref.u_exact)
    # the errors are differences of near-equal fields: held to u's scale
    scale = np.abs(np.asarray(ref.u)).max()
    for name in ("l2_error", "linf_error"):
        assert abs(float(getattr(got, name)) - float(getattr(ref, name))) \
            <= 1e-12 * scale, name


@pytest.mark.parametrize("scheme", ["cn", "icp"])
def test_implicit_systems_match_jax(scheme):
    """The constant rows and the right-hand side of one step."""
    jcfg = jax_heat1d.HeatConfig(nx=20, scheme=scheme)
    build = {"cn": "cn_system", "icp": "icp_system"}[scheme]
    *rows, rhs = getattr(heat1d, build)(interop.heat_config_from_jax(jcfg),
                                        F64)
    *jrows, jrhs = getattr(jax_heat1d, build)(jcfg, jnp.float64)
    for g, r in zip(rows, jrows):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    u = np.random.default_rng(0).standard_normal(21)
    _close(rhs(torch.as_tensor(u)), jrhs(jnp.asarray(u)))


@pytest.mark.parametrize("scheme,l2_tol", [("ftcs", 2.1e-4), ("rk3", 1.5e-4),
                                           ("cn", 1.5e-4), ("icp", 2e-7)])
def test_reference_resolution_error(scheme, l2_tol):
    """The golden bounds of tests/test_heat1d.py (nx=80, dt=.0025, t=1)."""
    res = heat1d.solve(heat1d.HeatConfig(scheme=scheme), F64, "cpu")
    assert float(res.l2_error) < l2_tol, float(res.l2_error)
    assert float(res.linf_error) < 10 * l2_tol


def test_tridiag_methods_agree():
    cfg = heat1d.HeatConfig(scheme="cn")
    u1 = heat1d.solve(cfg, F64, "cpu").u
    u2 = heat1d.solve(dataclasses.replace(cfg, tridiag_method="thomas"),
                      F64, "cpu").u
    assert np.abs((u1 - u2).numpy()).max() < 1e-13


def test_unknown_scheme_and_method_raise():
    with pytest.raises(ValueError, match="heat scheme"):
        heat1d.make_step_fn(heat1d.HeatConfig(scheme="bdf2"), F64, "cpu")
    with pytest.raises(ValueError, match="tridiagonal method"):
        heat1d.make_step_fn(heat1d.HeatConfig(scheme="cn",
                                              tridiag_method="lu"),
                            F64, "cpu")


def test_run_preset_files_match_jax(tmp_path):
    """heat_cn's output.txt and field_final.csv against the JAX runner's."""
    over = dict(nx=40, t_final=0.1)
    jax_run_preset("heat_cn", outdir=str(tmp_path / "jax"), **over)
    m = run_preset("heat_cn", outdir=str(tmp_path / "torch"),
                   dtype=F64, device="cpu", **over)
    assert m["preset"] == "heat_cn" and m["device"] == "cpu"
    got = np.loadtxt(tmp_path / "torch" / "field_final.csv", skiprows=1)
    ref = np.loadtxt(tmp_path / "jax" / "field_final.csv", skiprows=1)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-14)
    lines = (tmp_path / "torch" / "output.txt").read_text().splitlines()
    assert lines[0] == (tmp_path / "jax" / "output.txt").read_text(
    ).splitlines()[0] == "Error details:"


def test_cli_runs_heat_preset(tmp_path):
    assert cli.main(["run", "heat_icp", "--device", "cpu", "--outdir",
                     str(tmp_path), "--t_final", "0.05"]) == 0
    assert (tmp_path / "output.txt").exists()
    assert (tmp_path / "field_final.csv").exists()
