"""cfd_julia_torch lid-driven cavity vs cfd_julia_tpu.

The same seeded numpy state goes through the JAX full-grid step
(poisson="matmul"; the XLA RHS, or the Pallas kernel in interpret mode)
and the port's step in fp64, where the only admissible difference is
operation order (~1e-13 rel).  Also: the preset runner's files, the Ghia
Re=100 benchmark, and that the port never imports JAX.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop
from cfd_julia_torch.core import precision
from cfd_julia_torch.models import cavity
from cfd_julia_torch.run import run_preset
from cfd_julia_torch.stepping import loop
from cfd_julia_tpu.models import cavity as jax_cavity
from cfd_julia_tpu.run import run_preset as jax_run_preset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Ghia, Ghia & Shin (1982), Re=100, centerline velocities
# (as tests/test_ns2d.py)
GHIA_Y = np.array([0.0, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813,
                   0.4531, 0.5, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609,
                   0.9688, 0.9766, 1.0])
GHIA_U = np.array([0.0, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150,
                   -0.15662, -0.21090, -0.20581, -0.13641, 0.00332, 0.23151,
                   0.68717, 0.73722, 0.78871, 0.84123, 1.0])
GHIA_X = np.array([0.0, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266,
                   0.2344, 0.5, 0.8047, 0.8594, 0.9063, 0.9453, 0.9531,
                   0.9609, 0.9688, 1.0])
GHIA_V = np.array([0.0, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077,
                   0.17507, 0.17527, 0.05454, -0.24533, -0.22445, -0.16914,
                   -0.10313, -0.08864, -0.07391, -0.05906, 0.0])


def _initial(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.nx + 1, cfg.ny + 1)
    return 0.5 * rng.standard_normal(shape), 0.01 * rng.standard_normal(shape)


def _jax_trajectory(jcfg, w0, s0, nt):
    step = jax.jit(jax_cavity.make_step_fn(jcfg))
    state = (jnp.asarray(w0), jnp.asarray(s0), jnp.zeros((), jnp.float64))
    rms = []
    for _ in range(nt):
        state = step(state)
        rms.append(state[2])
    return np.asarray(state[0]), np.asarray(state[1]), np.asarray(jnp.stack(rms))


def _torch_trajectory(cfg, w0, s0, nt, device="cpu"):
    step = cavity.make_step_fn(cfg, torch.float64, device)
    state = interop.state_from_numpy(w0, s0, torch.float64, device)
    (w, s, _), rms = loop.run_steps(step, state, nt)
    return interop.to_numpy(w), interop.to_numpy(s), interop.to_numpy(rms)


def _assert_trajectories_match(got, ref):
    """Tolerances of tests/test_cavity_fused.py (fp64, operation order)."""
    (w, s, rms), (w_ref, s_ref, rms_ref) = got, ref
    np.testing.assert_allclose(w, w_ref, rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(s, s_ref, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(rms, rms_ref, rtol=1e-10)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 16)])
def test_wall_bc_matches_jax(nx, ny, order):
    rng = np.random.default_rng(3)
    wi = rng.standard_normal((nx - 1, ny - 1))
    s = rng.standard_normal((nx + 1, ny + 1))
    ref = np.asarray(jax_cavity.assemble_with_wall_bc(
        jnp.asarray(wi), jnp.asarray(s), 1.0 / nx, 1.0 / ny, order))
    got = cavity.assemble_with_wall_bc(
        torch.as_tensor(wi), torch.as_tensor(s), 1.0 / nx, 1.0 / ny, order)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=0)


@pytest.mark.parametrize("cfg", [
    jax_cavity.CavityConfig(nx=16, ny=16, dt=2e-3, re=100.0, bc_order=1),
    jax_cavity.CavityConfig(nx=16, ny=16, dt=2e-3, re=100.0, bc_order=2),
    # non-square: catches axis/wall transposition bugs
    jax_cavity.CavityConfig(nx=24, ny=16, dt=1e-3, re=50.0),
], ids=["bc1_16", "bc2_16", "bc2_24x16"])
def test_trajectory_matches_jax(cfg):
    """20 steps of the port's step (plain RHS) vs the jitted JAX step with
    the XLA RHS and the sine-matmul solve."""
    jcfg = dataclasses.replace(cfg, poisson="matmul", rhs_impl="xla")
    tcfg = interop.cavity_config_from_jax(jcfg)
    assert tcfg.rhs_impl == "torch" and tcfg.poisson == "matmul"
    w0, s0 = _initial(cfg)
    _assert_trajectories_match(_torch_trajectory(tcfg, w0, s0, 20),
                               _jax_trajectory(jcfg, w0, s0, 20))


def test_trajectory_matches_jax_pallas_rhs():
    """2 steps against the JAX step on the Pallas RHS kernel (interpret
    mode): the configuration the CUDA kernel replaces."""
    jcfg = jax_cavity.CavityConfig(nx=16, ny=16, dt=2e-3, poisson="matmul",
                                   rhs_impl="pallas")
    tcfg = dataclasses.replace(interop.cavity_config_from_jax(jcfg),
                               rhs_impl="auto")
    w0, s0 = _initial(jcfg, seed=1)
    _assert_trajectories_match(_torch_trajectory(tcfg, w0, s0, 2),
                               _jax_trajectory(jcfg, w0, s0, 2))


@pytest.mark.parametrize("rhs", ["xla", "pallas"])
@pytest.mark.parametrize("poisson", ["fst", "fst_half"])
def test_trajectory_matches_jax_fst(poisson, rhs):
    """3 steps at 33x47 with the rfft DST-I Poisson solves (odd-extension
    and half-length) against the JAX step with the same solver, on its XLA
    RHS and on its Pallas RHS in interpret mode; 1e-12 of the scale."""
    jcfg = jax_cavity.CavityConfig(nx=33, ny=47, dt=5e-4, re=100.0,
                                   poisson=poisson, rhs_impl=rhs)
    tcfg = interop.cavity_config_from_jax(jcfg)
    assert tcfg.poisson == poisson
    w0, s0 = _initial(jcfg, seed=2)
    got = _torch_trajectory(dataclasses.replace(tcfg, rhs_impl="auto"),
                            w0, s0, 3)
    ref = _jax_trajectory(jcfg, w0, s0, 3)
    for g, r in zip(got[:2], ref[:2]):
        assert np.abs(g - r).max() <= 1e-12 * np.abs(r).max()
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-10)


@pytest.mark.parametrize("poisson", ["fst", "fst_half"])
def test_fst_trajectory_matches_matmul(poisson):
    """The three Poisson variants are one solve: 20 steps from rest agree
    within 1e-11 of the scale."""
    base = cavity.CavityConfig(nx=24, ny=16, dt=1e-3, poisson="matmul")

    def run(cfg):
        step = cavity.make_step_fn(cfg, torch.float64, "cpu")
        state, _ = loop.run_steps(
            step, cavity.initial_state(cfg, torch.float64, "cpu"), 20)
        return state[1].numpy()

    ref = run(base)
    got = run(dataclasses.replace(base, poisson=poisson))
    assert np.abs(got - ref).max() <= 1e-11 * np.abs(ref).max()


def _read_columns(path, skip_header):
    return np.loadtxt(path, skiprows=1 if skip_header else 0)


def test_run_preset_files_match_jax(tmp_path):
    """The preset runner's text files against the JAX runner's (whose CPU
    `auto` runs the rfft DST-I solve)."""
    over = dict(nx=16, ny=16, t_final=0.02)
    jax_run_preset("cavity", outdir=str(tmp_path / "jax"), **over)
    m = run_preset("cavity", outdir=str(tmp_path / "torch"),
                   dtype=torch.float64, device="cpu", **over)
    assert m["device"] == "cpu" and m["preset"] == "cavity"
    for name, header in (("res_plot.txt", False), ("centerlines.txt", True),
                         ("field_final.txt", False)):
        got = _read_columns(tmp_path / "torch" / name, header)
        ref = _read_columns(tmp_path / "jax" / name, header)
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-15,
                                   err_msg=name)
    assert (tmp_path / "torch" / "metrics.json").exists()


def test_cavity_ghia_re100():
    """Steady cavity at Re=100, 64^2 (reference config) vs the Ghia et al.
    centerlines, with the tolerances of tests/test_ns2d.py."""
    cfg = cavity.CavityConfig(t_final=10.0)
    res = cavity.solve(cfg, torch.float64, "cpu")
    assert float(res.rms_history[-1]) < 1e-6
    u, v = cavity.centerline_velocities(res, cfg)
    ui = np.interp(GHIA_Y, np.linspace(0, 1, cfg.ny + 1), u.numpy())
    vi = np.interp(GHIA_X, np.linspace(0, 1, cfg.nx + 1), v.numpy())
    assert np.abs(ui - GHIA_U).max() < 0.01
    assert np.abs(vi - GHIA_V).max() < 0.01
    assert abs(float(res.s.min()) - (-0.103423)) < 2e-3


def test_import_leaves_out_jax():
    """Every module of the port imports without JAX or cfd_julia_tpu."""
    code = (
        "import pkgutil, sys, importlib, cfd_julia_torch\n"
        "for m in pkgutil.walk_packages(cfd_julia_torch.__path__,"
        " 'cfd_julia_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'cfd_julia_tpu'))\n"
        "for m in ('models.cavity', 'models.poisson2d', 'poisson.multigrid',"
        " 'poisson.iterative', 'ops.norms', 'ops.cuda_kernels',"
        " 'models.euler1d', 'ops.weno', 'ops.riemann', 'stepping.ssprk3',"
        " 'ops.spectral', 'models.vortex', 'utils.diagnostics'):\n"
        "    assert 'cfd_julia_torch.' + m in sys.modules, m\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    """No source line of the port imports JAX or cfd_julia_tpu (docstrings
    that name a JAX counterpart are fine)."""
    pattern = re.compile(r"^\s*(import|from) (jax|cfd_julia_tpu)")
    root = os.path.join(REPO, "cfd_julia_torch")
    sources = [os.path.join(d, n) for d, _, names in os.walk(root)
               for n in names if n.endswith(".py")]
    assert len(sources) > 20
    bad = [(p, ln) for p in sources for ln in open(p).read().splitlines()
           if pattern.match(ln)]
    assert not bad, bad


def test_kernel_rhs_on_cpu_raises():
    cfg = cavity.CavityConfig(nx=8, ny=8, rhs_impl="kernel")
    with pytest.raises(ValueError, match="CUDA device"):
        cavity.make_step_fn(cfg, torch.float64, "cpu")


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        precision.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cavity.solve(cavity.CavityConfig(nx=8, ny=8, t_final=0.002))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["run", "cavity", "--nx", "8", "--outdir", "unused"])


@pytest.mark.parametrize("field,value", [
    ("poisson", "fst_mxu"), ("poisson", "matmull"), ("rhs_impl", "xla"),
    ("rhs_impl", "pallas"), ("bc_order", 3),
])
def test_unknown_variant_raises(field, value):
    """A typo'd or unported variant never silently runs the default."""
    cfg = dataclasses.replace(cavity.CavityConfig(nx=8, ny=8),
                              **{field: value})
    with pytest.raises(ValueError):
        cavity.make_step_fn(cfg, torch.float64, "cpu")


@pytest.mark.parametrize("field,value", [
    ("poisson", "fst_half_mxu"), ("poisson", "fused_bf16x3"),
    ("poisson", "matmul_bf16x3"), ("rhs_impl", "bogus"),
])
def test_config_from_jax_rejects_unported(field, value):
    jcfg = dataclasses.replace(jax_cavity.CavityConfig(), **{field: value})
    with pytest.raises(ValueError, match="not ported"):
        interop.cavity_config_from_jax(jcfg)


def test_config_from_jax_defaults():
    """Same field names and defaults; rhs_impl names map pallas->kernel,
    xla->torch."""
    got = interop.cavity_config_from_jax(jax_cavity.CavityConfig())
    assert got == cavity.CavityConfig()
    pallas = dataclasses.replace(jax_cavity.CavityConfig(), rhs_impl="pallas")
    assert interop.cavity_config_from_jax(pallas).rhs_impl == "kernel"


def test_cli_run_cpu(tmp_path):
    rc = cli.main(["run", "cavity", "--device", "cpu", "--outdir",
                   str(tmp_path), "--nx", "16", "--ny", "12",
                   "--t_final", "0.004"])
    assert rc == 0
    for name in ("res_plot.txt", "field_final.txt", "centerline_u.txt",
                 "centerline_v.txt", "metrics.json"):
        assert (tmp_path / name).exists(), name
    assert len((tmp_path / "res_plot.txt").read_text().splitlines()) == 4


@pytest.mark.parametrize("argv", [["--bogus", "1"], ["--nx"],
                                  ["--nx", "1.5"]])
def test_cli_rejects_bad_override(tmp_path, argv):
    rc = cli.main(["run", "cavity", "--device", "cpu", "--outdir",
                   str(tmp_path), *argv])
    assert rc == 2

