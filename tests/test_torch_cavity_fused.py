"""cfd_julia_torch packed cavity (models/cavity_fused.py) vs cfd_julia_tpu.

The counterpart of every test of tests/test_cavity_fused.py, held to both
the JAX package's make_fused_step_fn and the port's full-grid matmul step:
in fp64 the only admissible difference is operation order (JAX's
tolerances: w rtol = atol = 1e-11, s rtol 1e-11 atol 1e-13, rms rtol
1e-10).  The stage's plain twin (ops/cuda_kernels.cavity_fused_stage_plain,
what the stage wrapper runs on the CPU) is held to JAX's own rhs, combine
and mask within 1e-12 of the scale.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import cli, interop
from cfd_julia_torch.models import cavity, cavity_fused
from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.poisson import direct
from cfd_julia_torch.stepping import loop
from cfd_julia_torch.utils import checkpoint
from cfd_julia_tpu.models import cavity as jax_cavity
from cfd_julia_tpu.models import cavity_fused as jax_fused

torch.set_num_threads(1)

F64 = torch.float64
CASES = {
    "bc1_16": dict(nx=16, ny=16, dt=2e-3, re=100.0, bc_order=1),
    "bc2_16": dict(nx=16, ny=16, dt=2e-3, re=100.0, bc_order=2),
    # non-square: catches axis / wall-vector transposition bugs
    "bc2_24x16": dict(nx=24, ny=16, dt=1e-3, re=50.0, bc_order=2),
}


def _cfgs(**kw):
    return cavity.CavityConfig(**kw), jax_cavity.CavityConfig(**kw)


def _assert_close(got, ref):
    """JAX's tolerances of tests/test_cavity_fused.py."""
    (w, s, rms), (w_ref, s_ref, rms_ref) = got, ref
    np.testing.assert_allclose(w, w_ref, rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(s, s_ref, rtol=1e-11, atol=1e-13)
    if rms is not None:
        np.testing.assert_allclose(rms, rms_ref, rtol=1e-10)


def _fused_run(cfg, nt, state=None):
    """(w_full, s_full, rms history, packed state) after nt port steps."""
    step = cavity_fused.make_fused_step_fn(cfg, F64, "cpu")
    state = state or cavity_fused.init_state(cfg, F64, "cpu")
    state, rms = loop.run_steps(step, state, nt)
    w, s = cavity_fused.decode_state(cfg, state)
    return w.numpy(), s.numpy(), rms.numpy(), state


def _jax_fused_run(jcfg, nt, state=None):
    step = jax.jit(jax_fused.make_fused_step_fn(jcfg))
    state = state or jax_fused.init_state(jcfg, jnp.float64)
    rms = []
    for _ in range(nt):
        state = step(state)
        rms.append(state[3])
    w, s = jax_fused.decode_state(jcfg, state)
    return np.asarray(w), np.asarray(s), np.asarray(jnp.stack(rms)), state


def _matmul_run(cfg, nt, w0=None, s0=None):
    cfg = dataclasses.replace(cfg, poisson="matmul", rhs_impl="torch")
    step = cavity.make_step_fn(cfg, F64, "cpu")
    state = cavity.initial_state(cfg, F64, "cpu")
    if w0 is not None:
        state = (w0, s0, state[2])
    (w, s, _), rms = loop.run_steps(step, state, nt)
    return w, s, rms


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax_and_matmul_step(case):
    """20 steps from rest: the port's packed step against JAX's packed step
    and against the port's full-grid matmul step."""
    cfg, jcfg = _cfgs(**CASES[case])
    w, s, rms, _ = _fused_run(cfg, 20)
    jw, js, jrms, _ = _jax_fused_run(jcfg, 20)
    _assert_close((w, s, rms), (jw, js, jrms))
    mw, ms, mrms = _matmul_run(cfg, 20)
    _assert_close((w, s, rms), (mw.numpy(), ms.numpy(), mrms.numpy()))


def _jax_closure(step):
    """The named cells of JAX's step closure (rhs, wall_vecs, valid, ...)."""
    return dict(zip(step.__code__.co_freevars,
                    (c.cell_contents for c in step.__closure__)))


def _random_packed(cfg, seed):
    """A random packed state: interior fields and wall vectors of scale 1
    on the logical range, zero padding (numpy, fp64)."""
    rng = np.random.default_rng(seed)
    m, n = cfg.nx - 1, cfg.ny - 1
    P, Q = cavity_fused.padded_extents(cfg.nx, cfg.ny)
    w, wt, s = (np.zeros((P, Q)) for _ in range(3))
    for a in (w, wt, s):
        a[:m, :n] = rng.standard_normal((m, n))
    walls = [np.zeros(Q), np.zeros(Q), np.zeros(P), np.zeros(P)]
    for v, L in zip(walls, (n, n, m, m)):
        v[:L] = rng.standard_normal(L)
    return w, wt, s, walls


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("bc_order", [1, 2])
@pytest.mark.parametrize("shape", [(16, 16), (33, 47), (34, 130),
                                   (9, 129)])
def test_stage_twin_matches_jax(shape, bc_order, stage):
    """One stage through the port's stage wrapper (its twin on the CPU)
    against JAX's rhs, the stage combine and the validity mask, and the
    next wall vectors against JAX's wall_vecs, within 1e-12 of the scale."""
    cfg, jcfg = _cfgs(nx=shape[0], ny=shape[1], dt=1e-3, re=100.0,
                      bc_order=bc_order)
    w, wt, s, walls = _random_packed(cfg, seed=17 * stage + bc_order)
    if stage == 1:
        wt = w
    cells = _jax_closure(jax_fused.make_fused_step_fn(jcfg))
    dt = cfg.dt
    jw, jwt, js = (jnp.asarray(a) for a in (w, wt, s))
    r = cells["rhs"](jwt, js, tuple(jnp.asarray(v) for v in walls))
    raw = {1: lambda: jw + dt * r,
           2: lambda: 0.75 * jw + 0.25 * jwt + 0.25 * dt * r,
           3: lambda: (jw + 2.0 * jwt + 2.0 * dt * r) / 3.0}[stage]()
    ref = np.asarray(jnp.where(cells["valid"], raw, 0.0))
    ref_walls = [np.asarray(v) for v in cells["wall_vecs"](js)]

    tw, twt, ts = (torch.as_tensor(a) for a in (w, wt, s))
    got, got_walls = cuda_kernels.cavity_fused_stage(
        tw, twt, ts, tuple(torch.as_tensor(v) for v in walls), stage, dt,
        cfg.dx, cfg.dy, cfg.re, cfg.nx - 1, cfg.ny - 1, bc_order)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    for g, rv in zip(got_walls, ref_walls):
        assert np.abs(g.numpy() - rv).max() <= 1e-12 * np.abs(rv).max()
    m, n = cfg.nx - 1, cfg.ny - 1
    assert not got[m:].any() and not got[:, n:].any()
    assert not got_walls[2][m:].any() and not got_walls[3][m:].any()


def test_pack_and_decode_match_jax_and_round_trip():
    """pack_state / decode_state against JAX's on a mid-run full-grid state
    of the matmul step, and decode(pack(x)) == x bitwise, padding zero."""
    cfg, jcfg = _cfgs(**CASES["bc2_24x16"])
    w, s, _ = _matmul_run(cfg, 5)
    packed = cavity_fused.pack_state(cfg, w, s)
    jpacked = jax_fused.pack_state(jcfg, jnp.asarray(w.numpy()),
                                   jnp.asarray(s.numpy()))
    mapped = interop.cavity_fused_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpacked), F64)
    assert len(packed) == 7
    for g, r in zip(packed, mapped):
        assert torch.equal(g, r)
    wd, sd = cavity_fused.decode_state(cfg, packed)
    assert torch.equal(wd, w) and torch.equal(sd, s)
    jwd, jsd = jax_fused.decode_state(jcfg, jpacked)
    np.testing.assert_array_equal(wd.numpy(), np.asarray(jwd))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(jsd))
    m, n = cfg.nx - 1, cfg.ny - 1
    assert not packed[0][m:].any() and not packed[0][:, n:].any()
    assert not packed[2][n:].any() and not packed[4][m:].any()


def test_pack_midrun_state_continues_identically():
    """A packed mid-run full-grid state continues the full-grid trajectory
    (the walls are carried, not recomputed: they lag psi by one solve)."""
    cfg, _ = _cfgs(**CASES["bc2_16"])
    w, s, _ = _matmul_run(cfg, 10)
    w_ref, s_ref, _ = _matmul_run(cfg, 6, w, s)
    wf, sf, _, _ = _fused_run(cfg, 6, cavity_fused.pack_state(cfg, w, s))
    _assert_close((wf, sf, None), (w_ref.numpy(), s_ref.numpy(), None))


def test_init_state_decodes_to_rest():
    cfg, jcfg = _cfgs(nx=16, ny=16)
    state = cavity_fused.init_state(cfg, F64, "cpu")
    jstate = jax_fused.init_state(jcfg, jnp.float64)
    assert [tuple(t.shape) for t in state] == [
        np.shape(a) for a in jax.tree_util.tree_leaves(jstate)]
    w, s = cavity_fused.decode_state(cfg, state)
    assert not w.any() and not s.any()
    assert w.shape == (17, 17)


def test_padding_stays_exactly_zero():
    cfg, _ = _cfgs(**CASES["bc2_24x16"])
    *_, state = _fused_run(cfg, 8)
    w, s, rl, rh, cl, ch, _ = state
    m, n = cfg.nx - 1, cfg.ny - 1
    assert not w[m:, :].any() and not w[:, n:].any()
    assert not s[m:, :].any() and not s[:, n:].any()
    for v, L in ((rl, n), (rh, n), (cl, m), (ch, m)):
        assert not v[L:].any()


@pytest.mark.parametrize("nx,ny", [(1024, 1024), (16, 16), (24, 16),
                                   (33, 47), (34, 130)])
def test_padded_extents_match_jax(nx, ny):
    P, Q = cavity_fused.padded_extents(nx, ny)
    assert (P, Q) == jax_fused.padded_extents(nx, ny)
    assert P % 8 == 0 and Q % 128 == 0
    assert cavity_fused.padded_extents(1024, 1024) == (1024, 1024)


def test_solve_routes_fused_and_resumes_bitwise(tmp_path):
    """cavity.solve(poisson="fused") reproduces the matmul solve (fields
    and rms history); checkpointed at 10 and 25 steps and resumed to 40 it
    is bitwise the uninterrupted fused run (pack and decode at each
    interval)."""
    base = cavity.CavityConfig(nx=16, ny=16, dt=2e-3, t_final=0.08,
                               poisson="matmul")
    ref = cavity.solve(base, F64, "cpu")
    fcfg = dataclasses.replace(base, poisson="fused")
    fus = cavity.solve(fcfg, F64, "cpu")
    np.testing.assert_allclose(fus.s.numpy(), ref.s.numpy(), rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(fus.w.numpy(), ref.w.numpy(), rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(fus.rms_history.numpy(),
                               ref.rms_history.numpy(), rtol=1e-10)
    ck = str(tmp_path / "fused.npz")
    for steps in (10, 25, 40):
        res = cavity.solve(dataclasses.replace(fcfg, t_final=steps * 2e-3),
                           F64, "cpu", checkpoint_every=7,
                           checkpoint_path=ck, resume=True)
    for name in ("w", "s", "rms_history"):
        assert torch.equal(getattr(res, name), getattr(fus, name)), name
    assert checkpoint.load_state(ck, (fus.w, fus.s, fus.w.new_empty(0)))[1] \
        == 40


def test_make_step_fn_rejects_fused_names():
    cfg = cavity.CavityConfig(nx=16, ny=16, poisson="fused")
    with pytest.raises(ValueError, match="fused"):
        cavity.make_step_fn(cfg, F64, "cpu")


@pytest.mark.parametrize("tier", ["fused_bf16x3", "fused_bf16x1",
                                  "matmul_bf16x3", "matmul_bf16x1"])
def test_bf16_tiers_raise(tier):
    """A bf16 tier takes fp32 states only: with an fp64 or bf16 state both
    entry points raise naming the tier, and make_fused_step_fn and the
    Poisson solve refuse it too; it never runs at another precision."""
    cfg = cavity.CavityConfig(nx=16, ny=16, poisson=tier)
    for dtype in (F64, torch.bfloat16):
        if tier.startswith("matmul"):
            with pytest.raises(ValueError, match=tier):
                cavity.make_step_fn(cfg, dtype, "cpu")
        with pytest.raises(ValueError, match=tier):
            cavity.solve(cfg, dtype, "cpu")
        with pytest.raises(ValueError, match="fp32"):
            cavity_fused.make_fused_step_fn(cfg, dtype, "cpu")
    with pytest.raises(ValueError, match="fp32"):
        direct.make_fst_matmul_interior(16, 16, 1 / 16, 1 / 16, F64, "cpu",
                                        tier=tier.rpartition("_")[2])


def test_invalid_bc_order_rejected():
    cfg = cavity.CavityConfig(nx=16, ny=16, bc_order=3)
    with pytest.raises(ValueError, match="bc_order"):
        cavity_fused.make_fused_step_fn(cfg, F64, "cpu")


def test_interop_maps_fused_config_and_state():
    """cavity_config_from_jax keeps poisson="fused"; the nested JAX state
    after 3 steps maps to the flat one, and one more step of each package
    agrees."""
    _, jcfg = _cfgs(**CASES["bc2_16"])
    tcfg = interop.cavity_config_from_jax(
        dataclasses.replace(jcfg, poisson="fused"))
    assert tcfg.poisson == "fused"
    *_, jstate = _jax_fused_run(jcfg, 3)
    state = interop.cavity_fused_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), F64)
    w, s, rms, _ = _fused_run(tcfg, 1, state)
    jw, js, jrms, _ = _jax_fused_run(jcfg, 1, jstate)
    _assert_close((w, s, rms), (jw, js, jrms))


def test_cli_runs_fused_cavity(tmp_path):
    """`run cavity --poisson fused` through the CLI's overrides gives the
    matmul run's psi_min."""
    args = ["run", "cavity", "--device", "cpu", "--nx", "16", "--ny", "16",
            "--t_final", "0.04", "--dt", "0.002"]
    assert cli.main(args + ["--outdir", str(tmp_path / "f"), "--poisson",
                            "fused"]) == 0
    assert cli.main(args + ["--outdir", str(tmp_path / "m"), "--poisson",
                            "matmul"]) == 0
    mf = json.loads((tmp_path / "f" / "metrics.json").read_text())
    mm = json.loads((tmp_path / "m" / "metrics.json").read_text())
    assert mf["psi_min"] == pytest.approx(mm["psi_min"], rel=1e-5)
    assert len((tmp_path / "f" / "res_plot.txt").read_text().splitlines()) \
        == 20
