"""The port's examples (cfd_julia_torch/examples/) against the repository's
JAX scripts (examples/) on the CPU at small sizes: the JAX script runs as a
subprocess (JAX_PLATFORMS=cpu, its fp32 default), the port's example
in-process with --device cpu, and their printed checks are compared.

Tolerances: fp32 runs of up to ~1000 steps, 1e-4 of each printed
quantity's scale (the Ghia columns, |w|max, E, Z, P, the spectrum); the
adjoint gradient, which the port computes in fp64, within 1e-9 relative
of jax.grad of the same loss in fp64, and within 1e-4 of its central
difference (h = 0.5, the difference's O(h^2) error).
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cfd_julia_torch.examples import (adjoint_cavity, cavity_ghia,
                                      vortex_diagnostics, vortex_merger)
from cfd_julia_tpu.core import precision as jprecision
from cfd_julia_tpu.models import cavity as jcavity
from cfd_julia_tpu.stepping import loop as jloop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4


def _jax_script(name, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join("examples", name),
                        *argv], capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-800:]
    return r.stdout


def _floats(text):
    return np.array([float(v) for v in re.findall(
        r"[-+]?\d+\.\d*(?:[eE][-+]?\d+)?", text)])


def _close(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= REL * max(np.abs(b).max(), 1e-30), (a, b)


def test_cavity_ghia_matches_jax(capsys):
    argv = ["--nx", "16", "--t", "0.5"]
    jout = _jax_script("cavity_ghia.py", *argv)
    res = cavity_ghia.main([*argv, "--device", "cpu"])
    tout = capsys.readouterr().out
    jl, tl = jout.splitlines(), tout.splitlines()
    assert len(tl) == len(jl) == 8
    # the Ghia columns (printed to 5 decimals) and psi_min (6)
    for a, b in zip(tl[1:], jl[1:]):
        np.testing.assert_allclose(_floats(a), _floats(b), rtol=0,
                                   atol=2e-5)
    assert f"{res['psi_min']:.6f}" == tl[1].split()[1]


def test_vortex_merger_matches_jax(tmp_path, capsys):
    argv = ["--nx", "32", "--t", "0.5", "--solver", "ps23"]
    jout = _jax_script("vortex_merger.py", *argv, "--outdir",
                       str(tmp_path / "jax"))
    res = vortex_merger.main([*argv, "--outdir", str(tmp_path / "torch"),
                              "--device", "cpu"])
    capsys.readouterr()
    wj = float(re.search(r"\|w\|max = ([-\d.]+)", jout).group(1))
    assert abs(res["wmax_final"] - wj) <= 1e-4
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == files
    for fn in files:
        if fn.endswith(".txt"):
            _close(np.loadtxt(tmp_path / "torch" / fn),
                   np.loadtxt(tmp_path / "jax" / fn))


def test_vortex_diagnostics_matches_jax(tmp_path, capsys):
    argv = ["--nx", "32", "--t", "1", "--solver", "ps23"]
    jout = _jax_script("vortex_diagnostics.py", *argv, "--outdir",
                       str(tmp_path / "jax"))
    res = vortex_diagnostics.main([*argv, "--outdir", str(tmp_path / "torch"),
                                   "--device", "cpu"])
    capsys.readouterr()
    jrows = np.array([_floats(line) for line in jout.splitlines()[1:]
                      if len(_floats(line)) == 4])
    rows = np.array(res["rows"])
    assert rows.shape == jrows.shape == (11, 4)
    for col in range(1, 4):              # E, Z, P
        _close(rows[:, col], jrows[:, col])
    # the budget's defect divides by dZ between snapshots, a small
    # difference of fp32 sums: held to the identity, not to JAX's roundoff
    jdefect = float(re.search(r"defect ([\d.]+)%", jout).group(1)) / 100
    assert res["budget_defect"] < 1e-3 and jdefect < 1e-3
    assert res["k_peak"] == int(re.search(r"peak at k=(\d+)", jout).group(1))
    _close(np.loadtxt(tmp_path / "torch" / "spectrum_final.txt"),
           np.loadtxt(tmp_path / "jax" / "spectrum_final.txt"))


def _jax_loss(re):
    """The JAX script's loss (examples/adjoint_cavity.py) in fp64."""
    n = adjoint_cavity.NX
    cfg = jcavity.CavityConfig(nx=n, ny=n, dt=adjoint_cavity.DT)
    step = jcavity.make_step_fn(cfg, re=re)
    w0 = jnp.zeros((n + 1, n + 1), jnp.float64)
    final = jloop.run_steps(step, (w0, jnp.zeros_like(w0),
                                   jnp.zeros((), jnp.float64)),
                            adjoint_cavity.STEPS)
    return 1e6 * jnp.mean(final[1] ** 2)


def test_adjoint_cavity_matches_jax_grad(capsys):
    res = adjoint_cavity.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "d loss / d Re @ Re=  200" in out
    assert res["fd_rel"] <= 1e-4
    with jprecision.x64(True):
        val, g = jax.jit(jax.value_and_grad(_jax_loss))(100.0)
    assert abs(res["loss"] - float(val)) <= 1e-9 * abs(float(val))
    assert abs(res["grad"] - float(g)) <= 1e-9 * abs(float(g))
    assert res["grads"][100.0] == res["grad"]
    assert res["grads"][50.0] < res["grads"][100.0] < res["grads"][200.0] < 0


def test_examples_run_as_modules(tmp_path):
    """`python -m cfd_julia_torch.examples.<name>` with --device cpu; the
    default --device cuda raises without a GPU."""
    r = subprocess.run([sys.executable, "-m",
                        "cfd_julia_torch.examples.cavity_ghia", "--nx", "8",
                        "--t", "0.01", "--device", "cpu"],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0 and "psi_min" in r.stdout, r.stderr[-800:]
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m",
                            "cfd_julia_torch.examples.vortex_merger",
                            "--outdir", str(tmp_path)],
                           capture_output=True, text=True, timeout=120,
                           cwd=REPO)
        assert r.returncode != 0 and "torch.cuda.is_available" in r.stderr
