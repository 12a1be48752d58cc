"""The port's `order` subcommand against the JAX package's on the CPU.

`order` runs in fp64 in both packages (JAX switches x64 on for the study;
the port passes torch.float64 to the models).  Tolerances: each study's
errors within 1e-9 relative of the JAX study's, or 1e-12 absolute where
that is larger: the errors are differences of O(1) fields, and two fp64
runs of up to 6400 steps through different operation orders part by
~1e-13 (heat icp at 80 nodes: errors of 1e-8 apart by 1.8e-13); the
observed orders within 1e-6 plus what the error tolerance allows them,
(tol(e1)/e1 + tol(e2)/e2) / log(n2/n1).  The CRWENO study runs on grids
of 50, 100 and 200 nodes: 400 is launch-heavy in eager torch on the CPU.
The orders also meet tests/test_cli_tools.py's bounds where it has them.
"""
import math
import sys

import numpy as np
import pytest
import torch

from cfd_julia_torch import cli as tcli
from cfd_julia_torch.utils import plotting as tplotting
from cfd_julia_tpu import cli as jcli
from cfd_julia_tpu.utils import plotting as jplotting

torch.set_num_threads(1)

# each study with tests/test_cli_tools.py's bound on its orders, where
# that file has one
STUDIES = [
    (["heat", "--scheme", "icp", "--grids", "20,40,80"],
     lambda p: p > 3.5),
    (["heat", "--grids", "16,32,64"], None),               # the default cn
    (["burgers", "--scheme", "weno", "--grids", "32,64,128"], None),
    (["poisson", "--scheme", "fft", "--self", "--grids", "32,64,128"],
     lambda p: abs(p - 2.0) < 0.3),
    (["burgers", "--scheme", "crweno", "--self", "--bc", "dirichlet",
      "--grids", "50,100,200"], lambda p: p > 3.5),
]


def _order(main, argv, outdir, *extra):
    return main(["order", *argv, "--outdir", str(outdir), *extra])


def _errors(path):
    """(grids, errors) of order.txt."""
    rows = [line.split() for line in path.read_text().splitlines()
            if not line.startswith("#")]
    return [int(r[0]) for r in rows], [float(r[1]) for r in rows]


def _self_rows(path):
    """(coarse, mid, fine, norm, e1, e2) rows of order_self.txt."""
    rows = [line.split() for line in path.read_text().splitlines()
            if not line.startswith("#")]
    return [(*map(int, r[:3]), r[3], float(r[4]), float(r[5]))
            for r in rows]


def _err_tol(e):
    return max(1e-9 * abs(e), 1e-12)


def _order_tol(e1, e2, beta):
    return 1e-6 + (_err_tol(e1) / e1 + _err_tol(e2) / e2) / math.log(beta)


@pytest.mark.parametrize("argv,bound", STUDIES,
                         ids=["-".join(a[::2]) for a, _ in STUDIES])
def test_order_study_matches_jax(tmp_path, capsys, argv, bound):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert _order(jcli.main, argv, jdir) == 0
    assert _order(tcli.main, argv, tdir, "--device", "cpu") == 0
    out = capsys.readouterr().out
    if "--self" in argv:
        jr, tr = (_self_rows(d / "order_self.txt") for d in (jdir, tdir))
        assert [r[:4] for r in tr] == [r[:4] for r in jr] and tr
        for (*_, n, je1, je2), (*_, _, te1, te2) in zip(jr, tr):
            assert abs(te1 - je1) <= _err_tol(je1), (n, te1, je1)
            assert abs(te2 - je2) <= _err_tol(je2), (n, te2, je2)
            p_j = math.log(je1 / je2) / math.log(2)
            p_t = math.log(te1 / te2) / math.log(2)
            assert abs(p_t - p_j) <= _order_tol(je1, je2, 2.0), (n, p_t, p_j)
            assert bound is None or bound(p_t), (n, p_t)
        # the table's header line and a row a (triplet, norm)
        assert out.count("coarse    mid   fine  norm") == 2
        assert (tdir / "order_self.png").exists()
    else:
        (jn, je), (tn, te) = (_errors(d / "order.txt") for d in (jdir, tdir))
        assert tn == jn
        for t, j in zip(te, je):
            assert abs(t - j) <= _err_tol(j), (te, je)
        pt = tplotting.observed_orders(tn, te)
        pj = jplotting.observed_orders(jn, je)
        for k in range(len(pj)):
            assert abs(pt[k] - pj[k]) <= _order_tol(
                je[k], je[k + 1], jn[k + 1] / jn[k]), (pt, pj)
            assert bound is None or bound(pt[k]), pt
        assert (tdir / "order.png").exists()


@pytest.mark.parametrize("argv", [
    ["poisson", "--scheme", "fft", "--self", "--grids", "32,64"],
    ["burgers", "--bc", "dirichlet", "--grids", "16,32"],  # no exact solution
])
def test_order_refusals_match_jax(tmp_path, capsys, argv):
    """--self with two grids exits 2 before any solve; a study without an
    exact solution and without --self exits 2; in both packages."""
    assert _order(jcli.main, argv, tmp_path / "j") == 2
    assert _order(tcli.main, argv, tmp_path / "t", "--device", "cpu") == 2
    capsys.readouterr()


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib made unimportable (the GPU machine has none)."""
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_order_without_matplotlib_writes_its_numbers(tmp_path, capsys,
                                                     no_matplotlib):
    """The numbers are the study's result: order.txt and the table are
    written, the figure is named on stderr as not written, rc 0."""
    assert not tplotting.have_matplotlib()
    assert _order(tcli.main, ["heat", "--scheme", "icp", "--grids",
                              "10,20"], tmp_path, "--device", "cpu") == 0
    cap = capsys.readouterr()
    assert "observed orders:" in cap.out
    assert "order.png not written: matplotlib is not installed" in cap.err
    assert (tmp_path / "order.txt").exists()
    assert not (tmp_path / "order.png").exists()
    assert _order(tcli.main, ["poisson", "--self", "--grids", "8,16,32"],
                  tmp_path, "--device", "cpu") == 0
    assert "order_self.png not written" in capsys.readouterr().err
    assert (tmp_path / "order_self.txt").exists()


def test_observed_orders_helper():
    np.testing.assert_allclose(
        tplotting.observed_orders([32, 64, 128], [1e-2, 2.5e-3, 6.25e-4]),
        [2.0, 2.0])
