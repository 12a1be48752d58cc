"""The port's `plot` subcommand and utils/plotting on the port's run
directories, against the JAX `plot` on the JAX runs of the same presets
(the same figures from the same files), on the CPU.
"""
import os
import sys

import pytest
import torch

from cfd_julia_torch import cli as tcli
from cfd_julia_torch import run as trun
from cfd_julia_torch.utils import plotting as tplotting
from cfd_julia_tpu import cli as jcli
from cfd_julia_tpu import run as jrun
from cfd_julia_tpu.core import precision as jprecision

torch.set_num_threads(1)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib made unimportable (the GPU machine has none)."""
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_plot_without_matplotlib_exits_2(tmp_path, capsys, no_matplotlib):
    trun.run_preset("heat_cn", outdir=str(tmp_path), device="cpu")
    assert tcli.main(["plot", str(tmp_path)]) == 2
    assert "matplotlib" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.png"))


def _wrote(capsys):
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("wrote:")][-1]
    return sorted(line[len("wrote: "):].split(", "))


# presets cut to seconds: the cavity contours, heat, the CG residual
# history, the Sod profiles (with a 'True' run), the vortex snapshots
PLOTS = [
    ("cavity", {"t_final": 0.2}, {"contours.png"}),
    ("heat_cn", {}, {"field_final.png"}),
    ("poisson_cg", {"nx": 64, "ny": 64}, {"residuals.png", "contours.png"}),
    ("euler_roe", {"nx": 128, "dt": 2e-4}, {"sod.png"}),
    ("tgv", {"nx": 16, "ny": 16, "t_final": 0.1}, {"vorticity.png"}),
]


@pytest.mark.parametrize("preset,overrides,figures", PLOTS,
                         ids=[p[0] for p in PLOTS])
def test_plot_port_rundir_like_jax(tmp_path, capsys, preset, overrides,
                                   figures):
    """`plot` on the port's run directory draws the figures the JAX `plot`
    draws on the JAX run of the same preset."""
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    trun.run_preset(preset, outdir=str(tdir), device="cpu", **overrides)
    with jprecision.x64(False):
        jrun.run_preset(preset, outdir=str(jdir), **overrides)
    extra = (["--true-dir", str(tdir)] if preset == "euler_roe" else [])
    assert tcli.main(["plot", str(tdir), *extra]) == 0
    made = _wrote(capsys)
    assert jcli.main(["plot", str(jdir), *extra]) == 0
    assert made == _wrote(capsys)
    assert figures <= set(made)
    for fig in made:
        assert os.path.getsize(tdir / fig) > 0


def test_plot_sweep_dir(tmp_path, capsys):
    """A sweep directory: the family from sweep_metrics.json; the Burgers
    aliases drawn as histories."""
    assert tcli.main(["run", "burgers_weno_dirichlet", "--outdir",
                      str(tmp_path), "--device", "cpu", "--sweep",
                      "nx=40,80", "--t_final", "0.05"]) == 0
    capsys.readouterr()
    assert tcli._plot_family(str(tmp_path)) == "burgers"
    assert tcli.main(["plot", str(tmp_path)]) == 0
    assert _wrote(capsys) == ["solution_d_40.png", "solution_d_80.png"]


