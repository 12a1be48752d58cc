"""The port's CLI (cfd_julia_torch/cli.py) against the JAX package's on the
CPU: `list`, `validate`, `run-all` and `run --sweep`, and what importing
the CLI may not touch.

The JAX commands run with JAX's fp32 default (x64 off, as the CLI runs by
default), the port's with --device cpu in its fp32 default.  Tolerances:
validate's values within 5% or 5e-6 absolute, whichever is larger, except
the Burgers WENO total-variation growth, a difference of two O(4) sums
over 200 nodes of fp32 fields that agree within ~7e-5 after the shock:
within 1e-3 absolute there; run metrics within 1e-4 of their scale (fp32
runs of up to ~1000 steps through different operation orders).
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfd_julia_torch import cli as tcli
from cfd_julia_torch import presets as tpresets
from cfd_julia_torch import run as trun
from cfd_julia_tpu import cli as jcli
from cfd_julia_tpu import presets as jpresets
from cfd_julia_tpu import run as jrun
from cfd_julia_tpu.core import precision as jprecision

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_REL = 1e-4


def _jax_main(argv):
    """The JAX CLI in its default fp32 (tests/conftest.py enables x64)."""
    with jprecision.x64(False):
        return jcli.main(argv)


def _lines(capsys, main, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out.splitlines()


def test_list_matches_jax(capsys):
    """The same lines but one: the port's reference text for
    poisson_gs_redblack says "data-parallel" where JAX's says
    "TPU-native"."""
    rc_j, jl = _lines(capsys, jcli.main, ["list"])
    rc_t, tl = _lines(capsys, tcli.main, ["list"])
    assert rc_j == rc_t == 0
    assert len(tl) == len(jl) == len(tpresets.PRESETS) + sum(
        bool(p.description) for p in tpresets.PRESETS.values())
    diff = [(a, b) for a, b in zip(jl, tl) if a != b]
    assert len(diff) == 1
    a, b = diff[0]
    assert b.startswith("poisson_gs_redblack")
    assert a == b.replace("data-parallel", "TPU-native")


def test_import_and_list_touch_no_cuda_kernels_or_matplotlib():
    """`python -m cfd_julia_torch list` initialises no CUDA, builds no
    kernel and imports no matplotlib (the GPU machine has none); no module
    of the port, the examples included, imports jax or cfd_julia_tpu."""
    code = (
        "import pkgutil, importlib, sys, torch\n"
        "def trap(*a, **k): raise SystemExit('CUDA initialised')\n"
        "torch.cuda._lazy_init = trap\n"
        "from cfd_julia_torch.ops import _cuda_build\n"
        "def build(*a, **k): raise SystemExit('kernel library built')\n"
        "_cuda_build.build = build\n"
        "from cfd_julia_torch import cli\n"
        "assert cli.main(['list']) == 0\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "import cfd_julia_torch\n"
        "for m in pkgutil.walk_packages(cfd_julia_torch.__path__,\n"
        "                               'cfd_julia_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'cfd_julia_tpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0 and r.stdout.splitlines()[-1] == "ok", \
        (r.stdout[-800:], r.stderr[-800:])


def _validate_rows(lines):
    rows = []
    for line in lines[:-1]:
        status, rest = line.split(" ", 1)
        name, rest = rest.split(": ", 1)
        rows.append((status, name, float(rest.split(" ")[0])))
    return rows, lines[-1]


def test_validate_matches_jax(capsys):
    rc_j, jl = _lines(capsys, _jax_main, ["validate"])
    rc_t, tl = _lines(capsys, tcli.main, ["validate", "--device", "cpu"])
    assert rc_j == rc_t == 0
    jrows, jlast = _validate_rows(jl)
    trows, tlast = _validate_rows(tl)
    assert jlast == tlast == "validate: PASS"
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    assert len(trows) == 7 and all(r[0] == "PASS" for r in trows)
    for (_, name, vj), (_, _, vt) in zip(jrows, trows):
        tol = 1e-3 if name == "burgers weno TV growth" else \
            max(0.05 * abs(vj), 5e-6)
        assert abs(vt - vj) <= tol, (name, vt, vj)


def test_device_defaults_to_cuda_and_raises_without_a_gpu(tmp_path):
    """Every subcommand that computes defaults to --device cuda, which
    raises on a machine without a GPU (no CPU fallback, no 29 FAILs)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda is a valid device here")
    for argv in (["validate"], ["run-all", "--outdir", str(tmp_path)],
                 ["order", "heat", "--grids", "8,16",
                  "--outdir", str(tmp_path)],
                 ["run", "heat_cn", "--outdir", str(tmp_path)],
                 ["run", "heat_cn", "--outdir", str(tmp_path),
                  "--sweep", "nx=8,16"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tcli.main(argv)
    assert not list(tmp_path.iterdir())


def _spy(monkeypatch, module):
    calls = {}

    def fake(name, outdir=".", **kw):
        kw.pop("device", None)
        calls[name] = kw
        return {"wall_time_s": 0.0}

    monkeypatch.setattr(module, "run_preset", fake)
    return calls


@pytest.mark.parametrize("full", [False, True])
def test_run_all_table_matches_jax(monkeypatch, capsys, tmp_path, full):
    """Every preset in the same order with the same overrides (the quick
    table, or none with --full), the same table and summary."""
    flag = ["--full"] if full else []
    jcalls = _spy(monkeypatch, jrun)
    tcalls = _spy(monkeypatch, trun)
    rc_j, jl = _lines(capsys, jcli.main,
                      ["run-all", "--outdir", str(tmp_path), *flag])
    rc_t, tl = _lines(capsys, tcli.main, ["run-all", "--outdir",
                                          str(tmp_path), "--device", "cpu",
                                          *flag])
    assert rc_j == rc_t == 0
    assert tl == jl
    assert list(tcalls) == list(jcalls) == sorted(tpresets.PRESETS)
    assert tcalls == jcalls
    assert tl[-1] == "run-all: 29/29 presets OK"
    assert bool(tcalls["cavity"]) != full


# one preset a family, cut to seconds on the CPU
SMALL = {
    "heat_cn": {},
    "burgers_riemann": {"t_final": 0.1},
    "euler_roe": {"nx": 64, "t_final": 0.05},
    "poisson_fst": {"nx": 32, "ny": 32},
    "cavity": {"nx": 16, "ny": 16, "t_final": 0.05},
    "tgv": {"nx": 16, "ny": 16, "t_final": 0.1},
}


def _subset(monkeypatch, presets_mod, broken=None):
    sub = {n: presets_mod.with_overrides(presets_mod.get(n), **o)
           for n, o in SMALL.items()}
    if broken:
        sub[broken] = presets_mod.with_overrides(sub[broken],
                                                 solver="no_such_solver")
    monkeypatch.setattr(presets_mod, "PRESETS", sub)


def _status(lines):
    return [line.split()[:2] for line in lines[:-1]
            if line.startswith(("OK", "FAIL"))], lines[-1]


@pytest.mark.parametrize("broken", [None, "poisson_fst"])
def test_run_all_runs_a_preset_a_family(monkeypatch, capsys, tmp_path,
                                        broken):
    """One preset a family through both CLIs: the same OK / FAIL column
    and summary, exit 1 when one failed (it is reported and the rest still
    run); the port's runs write the JAX runs' files, and their metrics
    agree within fp32 tolerance."""
    _subset(monkeypatch, jpresets, broken)
    _subset(monkeypatch, tpresets, broken)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    rc_j, jl = _lines(capsys, _jax_main, ["run-all", "--full",
                                          "--outdir", str(jdir)])
    rc_t, tl = _lines(capsys, tcli.main, ["run-all", "--full", "--outdir",
                                          str(tdir), "--device", "cpu"])
    assert _status(tl) == _status(jl)
    want = 1 if broken else 0
    assert rc_j == rc_t == want
    n = len(SMALL)
    assert tl[-1] == f"run-all: {n - bool(broken)}/{n} presets OK"
    for name in SMALL:
        if name == broken:
            assert not (tdir / name / "metrics.json").exists()
            continue
        assert sorted(os.listdir(tdir / name)) == \
            sorted(os.listdir(jdir / name))
        mj = json.loads((jdir / name / "metrics.json").read_text())
        mt = json.loads((tdir / name / "metrics.json").read_text())
        assert set(mt) == set(mj) | {"device"} and mt["device"] == "cpu"
        for k, v in mj.items():
            if k == "wall_time_s":
                continue
            if isinstance(v, float):
                assert abs(mt[k] - v) <= FP32_REL * max(abs(v), 1.0), \
                    (name, k, mt[k], v)
            else:
                assert mt[k] == v, (name, k)


SWEEPS = [
    # a grid sweep (the bare suffix: solution_d_<nx>.txt already names it)
    ("burgers_weno_dirichlet", "nx=40,80", ["--t_final", "0.05"]),
    # two zipped grid fields, one value: output_<nx>.txt as written
    ("poisson_fst", "nx=16,32;ny=16,32", []),
    # a non-grid field: the keyed suffix (output_t_final0.1.txt)
    ("heat_cn", "t_final=0.1,0.2", []),
]


@pytest.mark.parametrize("preset,sweep,extra", SWEEPS)
def test_sweep_matches_jax(capsys, tmp_path, preset, sweep, extra):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    rc_j = _jax_main(["run", preset, "--outdir", str(jdir), "--sweep", sweep,
                      *extra])
    rc_t = tcli.main(["run", preset, "--outdir", str(tdir), "--device",
                      "cpu", "--sweep", sweep, *extra])
    capsys.readouterr()
    assert rc_j == rc_t == 0

    def tree(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*"))

    assert tree(tdir) == tree(jdir)
    mj = json.loads((jdir / "sweep_metrics.json").read_text())
    mt = json.loads((tdir / "sweep_metrics.json").read_text())
    assert len(mt) == len(mj) == 2
    for a, b in zip(mj, mt):
        assert set(b) == set(a) | {"device"}
        for k, v in a.items():
            if k == "wall_time_s":
                continue
            if isinstance(v, float):
                assert abs(b[k] - v) <= FP32_REL * max(abs(v), 1.0), (k,)
            else:
                assert b[k] == v, k
    # the alias files hold the per-point files' values
    for fn in os.listdir(tdir):
        if fn.endswith((".txt", ".csv")):
            a, b = _numbers(jdir / fn), _numbers(tdir / fn)
            assert a.shape == b.shape, fn
            scale = max(np.abs(a).max(), 1.0)
            assert np.abs(a - b).max() <= FP32_REL * scale, fn


def _numbers(path):
    """Every number of a text output file, in order (column dumps and
    the reports' labelled lines alike)."""
    return np.array([float(v) for v in re.findall(
        r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?", path.read_text())])


def test_sweep_refusals(tmp_path, capsys):
    """The JAX CLI's refusals: --checkpoint-every / --resume with a sweep,
    an unknown field, unequal value counts (rc 2, nothing run)."""
    base = ["run", "cavity", "--outdir", str(tmp_path), "--device", "cpu"]
    for extra in (["--sweep", "nx=8,16", "--checkpoint-every", "10"],
                  ["--sweep", "nx=8,16", "--resume"],
                  ["--sweep", "bogus=1,2"],
                  ["--sweep", "nx=8,16;ny=8"]):
        assert tcli.main(base + extra) == 2
        assert _jax_main(["run", "cavity", "--outdir", str(tmp_path)]
                         + extra) == 2
    capsys.readouterr()
    assert not list(tmp_path.iterdir())
