"""cfd_julia_torch's loop layer on the CPU: the chunk plan, checkpoint /
resume (utils/checkpoint.py, the cavity and vortex solves, the CLI), and
utils/profiling.py, against the port's own one-step loops and the JAX
package's checkpoints.

On the CPU the loop runs its chunks eagerly; the CUDA graphs of the same
plan are held against eager runs in tests/test_torch_cuda.py.  Chunking
and resuming reorder no arithmetic, so the port is held to itself
bitwise; across packages, fp64, the tolerance is 1e-12 of the field's
scale (operation order, as in the other parity tests).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop, run
from cfd_julia_torch.models import cavity, euler1d, vortex
from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.poisson import multigrid
from cfd_julia_torch.stepping import loop, ssprk3
from cfd_julia_torch.utils import checkpoint, profiling
from cfd_julia_tpu.models import cavity as jax_cavity
from cfd_julia_tpu.models import vortex as jax_vortex

torch.set_num_threads(1)

F64 = torch.float64


def _cavity_step(nx=12):
    cfg = cavity.CavityConfig(nx=nx, ny=nx, dt=1e-3, re=100.0)
    return (cavity.make_step_fn(cfg, F64, "cpu"),
            cavity.initial_state(cfg, F64, "cpu"))


def _euler_step(nx=32):
    cfg = euler1d.EulerConfig(nx=nx, solver="hllc", dt=2e-3)
    rhs = euler1d.make_rhs(cfg, "cpu")
    _, q0 = euler1d.sod_initial_state(cfg, F64, "cpu")
    return (lambda q: ssprk3.ssprk3_step(rhs, q, cfg.dt)), q0


# ------------------------------------------------------------- chunk plan

@pytest.mark.parametrize("nt,every,chunk", [
    (103, 20, 7), (100, 20, 50), (100, 100, 50), (7, 3, 2), (5, 10, 3),
    (0, 4, 2), (60, 60, 60)])
def test_chunk_plan(nt, every, chunk):
    """Boundaries every `every` steps and after the leftover; no chunk
    longer than `chunk` or its interval; at most three distinct
    lengths (the graphs a run captures)."""
    plan = loop._chunk_plan(nt, every, chunk)
    assert sum(map(sum, plan)) == nt
    sizes = [sum(p) for p in plan]
    assert sizes == [every] * (nt // every) + ([nt % every] if nt % every
                                               else [])
    lengths = {n for p in plan for n in p}
    assert all(0 < n <= min(chunk, every) for n in lengths)
    assert len(lengths) <= 3
    with pytest.raises(ValueError):
        loop._chunk_plan(nt, every, 0)


@pytest.mark.parametrize("nt,chunk", [(23, 1), (23, 7), (23, 50), (20, 5)])
def test_run_steps_chunked_equals_one_step_loop(nt, chunk, monkeypatch):
    """The cavity's run_steps, whatever the chunk length, is the one-step
    loop bit for bit, per-step rms history included."""
    monkeypatch.setattr(loop, "CHUNK", chunk)
    step, state = _cavity_step()
    ref, hist = state, []
    for _ in range(nt):
        ref = step(ref)
        hist.append(ref[-1])
    got, history = loop.run_steps(step, state, nt)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(history, torch.stack(hist))
    assert torch.equal(loop.advance(step, state, nt)[1], ref[1])


@pytest.mark.parametrize("nt,every,chunk", [(25, 6, 4), (25, 5, 5),
                                            (24, 8, 3), (9, 20, 2)])
@pytest.mark.parametrize("observed", [False, True])
def test_snapshots_chunked_equal_one_step_loop(nt, every, chunk, observed,
                                               monkeypatch):
    """run_steps_with_snapshots with chunks that divide neither nt nor
    `every` (and an `every` beyond nt) is the one-step loop bit for bit:
    the state and each snapshot, observed or whole."""
    monkeypatch.setattr(loop, "CHUNK", chunk)
    step, q = _euler_step()
    observe = (lambda s: 2.0 * s[0]) if observed else None
    obs = observe or (lambda s: s)
    ref, snaps = q, []
    for k in range(1, nt + 1):
        ref = step(ref)
        if k % every == 0:
            snaps.append(obs(ref))
    got, got_snaps = loop.run_steps_with_snapshots(step, q, nt, every,
                                                   observe=observe)
    assert torch.equal(got, ref)
    assert got_snaps.shape[0] == nt // every
    if snaps:
        assert torch.equal(got_snaps, torch.stack(snaps))
    with pytest.raises(ValueError, match="every"):
        loop.run_steps_with_snapshots(step, q, nt, 0)


def test_run_steps_with_checkpoints_resumes_bitwise(tmp_path, monkeypatch):
    """A checkpoint every 7 steps records the absolute step; the state
    reloaded at step 14 and run on equals the uninterrupted run."""
    step, q = _euler_step()
    path = str(tmp_path / "euler")
    full = loop.advance(step, q, 30)
    monkeypatch.setattr(loop, "CHUNK", 3)
    mid = loop.run_steps_with_checkpoints(step, q, 14, 7, path)
    loaded, at = checkpoint.load_state(path, q)
    assert at == 14 and torch.equal(loaded, mid)
    end = loop.run_steps_with_checkpoints(step, loaded, 16, 7, path,
                                          start_step=at)
    assert torch.equal(end, full)
    assert checkpoint.load_state(path, q)[1] == 30


# -------------------------------------------------------------- checkpoint

def test_checkpoint_round_trip(tmp_path):
    """0-d, complex128, fp32 and nested leaves come back exactly, with the
    structure of `like` and the step; '.npz' is added to the path."""
    rng = np.random.default_rng(3)
    c = torch.as_tensor(rng.standard_normal((5, 3))
                        + 1j * rng.standard_normal((5, 3)))
    state = (torch.tensor(2.5, dtype=F64), c,
             (torch.as_tensor(rng.standard_normal(4), dtype=torch.float32),
              [torch.arange(6, dtype=F64).reshape(2, 3)]))
    path = str(tmp_path / "sub" / "ck")
    checkpoint.save_state(path, state, step=17)
    assert os.path.exists(path + ".npz") and checkpoint.exists(path)
    assert checkpoint.exists(path + ".npz")
    like = (torch.zeros((), dtype=F64), torch.zeros_like(c),
            (torch.zeros(4), [torch.zeros(2, 3, dtype=F64)]))
    got, step = checkpoint.load_state(path + ".npz", like)
    assert step == 17
    assert isinstance(got[2][1], list) and got[0].shape == ()
    for a, b in zip(checkpoint._leaves(got), checkpoint._leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(path + ".npz") as data:
        assert str(data["__treedef__"]) == "PyTreeDef((*, *, (*, [*])))"
    checkpoint.save_state(str(tmp_path / "nostep"), c)
    assert checkpoint.load_state(str(tmp_path / "nostep"), c)[1] is None


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A save that dies while writing leaves the previous checkpoint."""
    path = str(tmp_path / "ck.npz")
    old = (torch.ones(3, dtype=F64),)
    checkpoint.save_state(path, old, step=1)

    def broken_savez(file, **payload):
        with open(file, "wb") as fh:
            fh.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken_savez)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_state(path, (torch.zeros(3, dtype=F64),), step=2)
    monkeypatch.undo()
    got, step = checkpoint.load_state(path, old)
    assert step == 1 and torch.equal(got[0], old[0])


@pytest.mark.parametrize("like,match", [
    ((torch.zeros(4, dtype=F64), torch.zeros((0, 3))), "leaf 0 is float64"),
    ((torch.zeros(3, dtype=torch.float32), torch.zeros((0, 3))),
     "leaf 0 is float64"),
    ((torch.zeros(3, dtype=F64), torch.zeros((0, 4))), "leaf 1"),
    ((torch.zeros(3, dtype=F64), torch.zeros((2, 2, 3))), "leaf 1"),
    ((torch.zeros(3, dtype=torch.complex128), torch.zeros((0, 3))),
     "leaf 0"),
    ((torch.zeros(3, dtype=F64),), "holds 2 leaves"),
])
def test_checkpoint_mismatch_raises(tmp_path, like, match):
    """A leaf of another dtype or shape raises with its index and what the
    file holds; a leading axis of 0 in `like` takes any history length."""
    path = str(tmp_path / "ck")
    checkpoint.save_state(path, (torch.ones(3, dtype=F64),
                                 torch.ones((5, 3))), step=5)
    got, _ = checkpoint.load_state(
        path, (torch.zeros(3, dtype=F64), torch.zeros((0, 3))))
    assert got[1].shape == (5, 3)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_state(path, like)


# ------------------------------------------------ resume in the port

def test_cavity_checkpoint_resume_bitexact(tmp_path):
    """Checkpointed, interrupted at 50 steps and resumed to 100, the cavity
    reproduces the uninterrupted run bit for bit, rms history included."""
    ck = str(tmp_path / "ck.npz")
    cfg50 = cavity.CavityConfig(nx=24, ny=24, dt=1e-3, t_final=0.05)
    assert cfg50.nt == 50
    cavity.solve(cfg50, F64, "cpu", checkpoint_every=20, checkpoint_path=ck)
    cfg100 = dataclasses.replace(cfg50, t_final=0.1)
    resumed = cavity.solve(cfg100, F64, "cpu", checkpoint_path=ck,
                           resume=True)
    full = cavity.solve(cfg100, F64, "cpu")
    for name in ("w", "s", "rms_history"):
        assert torch.equal(getattr(resumed, name), getattr(full, name))
    assert full.rms_history.shape == (100,)
    assert checkpoint.load_state(
        ck, (full.w, full.s, full.w.new_empty(0)))[1] == 50


@pytest.mark.parametrize("solver", ["fdm", "ps23"])
def test_vortex_checkpoint_resume_bitexact(tmp_path, solver):
    """Interrupted after 20 of 40 steps and resumed, the vortex run equals
    the checkpoint-free solve exactly, snapshots included."""
    ck = str(tmp_path / f"v_{solver}.npz")
    cfg_half = vortex.VortexConfig(nx=32, ny=32, solver=solver, dt=1e-3,
                                   t_final=0.02, ns=4)
    assert cfg_half.nt == 20
    vortex.solve(cfg_half, F64, "cpu", checkpoint_every=5,
                 checkpoint_path=ck)
    cfg_full = dataclasses.replace(cfg_half, t_final=0.04, ns=8)
    resumed = vortex.solve(cfg_full, F64, "cpu", checkpoint_path=ck,
                           resume=True)
    full = vortex.solve(cfg_full, F64, "cpu")
    assert torch.equal(resumed.w, full.w)
    assert torch.equal(resumed.snapshots, full.snapshots)
    assert full.snapshots.shape == (9, 32, 32)


def test_vortex_checkpoint_cadence_rounds_up(tmp_path):
    """checkpoint_every=7 with a snapshot every 5 steps saves at step 10
    and then at the end (20), as the JAX package does."""
    ck = str(tmp_path / "v.npz")
    cfg = vortex.VortexConfig(nx=16, ny=16, solver="fdm", dt=1e-3,
                              t_final=0.015, ns=3)   # nt=15, every=5
    like = (torch.zeros((16, 16), dtype=F64), torch.zeros((0, 16, 16),
                                                          dtype=F64))
    saved = []
    real_save = checkpoint.save_state

    def spy(path, state, step=None):
        saved.append(step)
        real_save(path, state, step)

    checkpoint.save_state = spy
    try:
        vortex.solve(cfg, F64, "cpu", checkpoint_every=7, checkpoint_path=ck)
    finally:
        checkpoint.save_state = real_save
    assert saved == [10, 15]
    assert checkpoint.load_state(ck, like)[0][1].shape == (3, 16, 16)


def test_checkpoint_contract_rejections(tmp_path):
    """As the JAX package: a resume whose snapshot cadence no longer
    divides the checkpoint's step, a run shorter than the checkpoint, a
    snapshot count that does not match the step, a cavity checkpoint whose
    rms history does not match its step, and checkpointing without a
    path, all raise."""
    ck = str(tmp_path / "v.npz")
    cfg = vortex.VortexConfig(nx=32, ny=32, solver="fdm", dt=1e-3,
                              t_final=0.02, ns=4)  # nt=20, every=5
    vortex.solve(cfg, F64, "cpu", checkpoint_every=5, checkpoint_path=ck)
    with pytest.raises(ValueError, match="snapshot"):
        vortex.solve(dataclasses.replace(cfg, t_final=0.04), F64, "cpu",
                     checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError, match="beyond"):
        vortex.solve(dataclasses.replace(cfg, t_final=0.01), F64, "cpu",
                     checkpoint_path=ck, resume=True)
    (w, snaps), at = checkpoint.load_state(
        ck, (torch.zeros((32, 32), dtype=F64),
             torch.zeros((0, 32, 32), dtype=F64)))
    checkpoint.save_state(ck, (w, snaps[:2]), step=at)
    with pytest.raises(ValueError, match="snapshot count"):
        vortex.solve(cfg, F64, "cpu", checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError, match="checkpoint_path"):
        vortex.solve(cfg, F64, "cpu", checkpoint_every=5)
    small = cavity.CavityConfig(nx=16, ny=16, dt=1e-3, t_final=0.01)
    with pytest.raises(ValueError, match="checkpoint_path"):
        cavity.solve(small, F64, "cpu", checkpoint_every=5)
    cck = str(tmp_path / "c.npz")
    cavity.solve(small, F64, "cpu", checkpoint_every=5, checkpoint_path=cck)
    with pytest.raises(ValueError, match="beyond"):
        cavity.solve(dataclasses.replace(small, t_final=0.005), F64, "cpu",
                     checkpoint_path=cck, resume=True)
    (cw, cs, h), at = checkpoint.load_state(
        cck, (w[:17, :17], w[:17, :17], w.new_empty(0)))
    checkpoint.save_state(cck, (cw, cs, h[:3]), step=at)
    with pytest.raises(ValueError, match="inconsistent"):
        cavity.solve(small, F64, "cpu", checkpoint_path=cck, resume=True)


# ------------------------------------------------- across the packages

def _jax_cavity_cfg(t_final):
    return jax_cavity.CavityConfig(nx=24, ny=24, dt=1e-3, t_final=t_final,
                                   poisson="fst")


def _close(got, want):
    """Within 1e-12 of want's scale; either side a tensor or an array."""
    got, want = (np.asarray(a.cpu() if torch.is_tensor(a) else a)
                 for a in (got, want))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cavity_checkpoint_resumes_across_packages(tmp_path, writer):
    """A 50-step cavity checkpoint written by either package resumes to
    100 steps in the other, within 1e-12 of JAX's uninterrupted run
    (poisson="fst" on both sides)."""
    ck = str(tmp_path / "ck.npz")
    j50, j100 = _jax_cavity_cfg(0.05), _jax_cavity_cfg(0.1)
    full = jax_cavity.solve(j100, jnp.float64)
    if writer == "jax":
        jax_cavity.solve(j50, jnp.float64, checkpoint_every=20,
                         checkpoint_path=ck)
        res = cavity.solve(interop.cavity_config_from_jax(j100), F64, "cpu",
                           checkpoint_path=ck, resume=True)
    else:
        cavity.solve(interop.cavity_config_from_jax(j50), F64, "cpu",
                     checkpoint_every=20, checkpoint_path=ck)
        res = jax_cavity.solve(j100, jnp.float64, checkpoint_path=ck,
                               resume=True)
    for name in ("w", "s", "rms_history"):
        _close(getattr(res, name), getattr(full, name))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fdm_checkpoint_resumes_across_packages(tmp_path, writer):
    """The same for the fdm vortex: 20 of 40 steps, snapshots included."""
    ck = str(tmp_path / "v.npz")
    jh = jax_vortex.VortexConfig(nx=32, ny=32, solver="fdm", dt=1e-3,
                                 t_final=0.02, ns=4, rhs_impl="xla",
                                 fft_impl="xla")
    jf = dataclasses.replace(jh, t_final=0.04, ns=8)
    full = jax_vortex.solve(jf, jnp.float64)
    if writer == "jax":
        jax_vortex.solve(jh, jnp.float64, checkpoint_every=5,
                         checkpoint_path=ck)
        res = vortex.solve(interop.vortex_config_from_jax(jf), F64, "cpu",
                           checkpoint_path=ck, resume=True)
    else:
        vortex.solve(interop.vortex_config_from_jax(jh), F64, "cpu",
                     checkpoint_every=5, checkpoint_path=ck)
        res = jax_vortex.solve(jf, jnp.float64, checkpoint_path=ck,
                               resume=True)
    _close(res.w, full.w)
    _close(res.snapshots, full.snapshots)


def test_jax_spectral_checkpoint_is_refused(tmp_path):
    """A JAX ps23 checkpoint holds pack_c's packed real state, not the
    port's complex half spectrum: the port refuses it on its leaf check."""
    ck = str(tmp_path / "ps.npz")
    jcfg = jax_vortex.VortexConfig(nx=16, ny=16, solver="ps23", dt=1e-3,
                                   t_final=0.004, ns=2, fft_impl="xla")
    jax_vortex.solve(jcfg, jnp.float64, checkpoint_every=2,
                     checkpoint_path=ck)
    with pytest.raises(ValueError, match="leaf 0"):
        vortex.solve(interop.vortex_config_from_jax(jcfg), F64, "cpu",
                     checkpoint_path=ck, resume=True)


# -------------------------------------------------------------------- CLI

def test_cli_checkpoint_and_resume(tmp_path):
    """run --checkpoint-every writes checkpoint.npz; --resume of the
    finished run gives the same psi_min; families other than cavity and
    vortex are rejected."""
    d = tmp_path / "cav"
    args = ["run", "cavity", "--device", "cpu", "--outdir", str(d),
            "--t_final", "0.05", "--dt", "0.001", "--nx", "16", "--ny", "16"]
    assert cli.main(args + ["--checkpoint-every", "25"]) == 0
    assert (d / "checkpoint.npz").exists()
    m1 = json.loads((d / "metrics.json").read_text())
    assert cli.main(args + ["--resume"]) == 0
    m2 = json.loads((d / "metrics.json").read_text())
    assert m2["psi_min"] == m1["psi_min"]
    assert len((d / "res_plot.txt").read_text().splitlines()) == 50
    with pytest.raises(ValueError, match="cavity, vortex"):
        cli.main(["run", "euler_hllc", "--device", "cpu", "--outdir",
                  str(tmp_path / "e"), "--checkpoint-every", "10"])
    with pytest.raises(ValueError, match="cavity, vortex"):
        run.run_preset("euler_hllc", outdir=str(tmp_path / "e"),
                       device="cpu", resume=True)


def test_cli_vortex_resume(tmp_path):
    """A vortex preset through the CLI: checkpoint at half the run, resume
    to the end, the snapshot files equal the uninterrupted run's."""
    common = ["--device", "cpu", "--nx", "16", "--ny", "16", "--dt",
              "0.001"]
    a, b = tmp_path / "a", tmp_path / "b"
    # 4 steps, snapshots every 2, then on to 8 steps at the same cadence
    assert cli.main(["run", "tgv", "--outdir", str(a), *common, "--t_final",
                     "0.004", "--ns", "2", "--checkpoint-every", "2"]) == 0
    assert cli.main(["run", "tgv", "--outdir", str(a), *common, "--t_final",
                     "0.008", "--ns", "4", "--resume"]) == 0
    assert cli.main(["run", "tgv", "--outdir", str(b), *common, "--t_final",
                     "0.008", "--ns", "4"]) == 0
    for name in sorted(os.listdir(b)):
        if name.startswith("vm"):
            assert (a / name).read_text() == (b / name).read_text(), name


# -------------------------------------------------------------- profiling

def test_steps_per_second_and_trace(tmp_path):
    """A positive rate whose state is run_steps' after 1 + repeats windows;
    trace writes a Chrome trace; timer reports its label."""
    step, state = _cavity_step(8)
    rate, got = profiling.steps_per_second(step, state, steps=4, repeats=2)
    assert rate > 0
    ref, _ = loop.run_steps(step, state, 12)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with profiling.trace(str(tmp_path / "tr")):
        loop.advance(step, state, 2)
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())
    lines = []
    with profiling.timer("window", sink=lines.append):
        pass
    assert lines and lines[0].startswith("window ")


# -------------------------------------------------- multigrid on the CPU

def test_stencils_and_graph_flag_on_cpu():
    """The conv transfers' stencils (built on the device, so that a CUDA
    graph can capture them) are the reference's; on the CPU graph=True
    and graph=False are the same eager solve, and no kernel is counted."""
    r = torch.zeros((5, 5), dtype=F64)
    np.testing.assert_array_equal(
        multigrid._stencil(1.0 / 16.0, r)[0, 0].numpy(),
        np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]) / 16.0)
    np.testing.assert_array_equal(
        multigrid._stencil(0.25, r)[0, 0].numpy(),
        np.array([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]]))
    rng = np.random.default_rng(1)
    f = torch.as_tensor(rng.standard_normal((33, 33)))
    u0 = torch.zeros_like(f)
    cuda_kernels.reset_launch_counts()
    for opts in ({}, {"smoother": "cheb", "transfers": "conv"}):
        cfg = multigrid.MGConfig(tol=1e-8, max_cycles=30, **opts)
        a = multigrid.solve(f, u0, 1 / 32, 1 / 32, cfg)
        b = multigrid.solve(f, u0, 1 / 32, 1 / 32, cfg, graph=False)
        assert a.iterations == b.iterations and torch.equal(a.u, b.u)
        assert a.iterations > 2
    assert not any(cuda_kernels.LAUNCHES.values())
