"""The port's multi-device layer (cfd_julia_torch/parallel/, the mesh
multigrid solve, the sharded checkpoints) against the JAX package's
(tests/test_parallel.py's cases), fp64 on the CPU.

The port runs as spawned ranks over gloo (parallel/launch.py): one group
for each world size 1, 2 and 4, each running every case once
(tests/torch_parallel_ranks.py, which imports no JAX) and returning the
gathered global results.  The JAX side runs on the conftest's virtual CPU
devices with meshes of `make_mesh(jax.devices()[:k])`, so both sides have
the same (px, py) and the same padded shapes, compared whole.

Tolerances: the stencils 1e-12 (the same arithmetic a point); the sharded
cavity rtol 1e-10, atol 1e-12 (tests/test_parallel.py's: the block
matmuls and the rms sum add in another order); the mesh multigrid rtol
1e-10 with equal cycle counts; the checkpoints bitwise.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from cfd_julia_torch import interop
from cfd_julia_torch.models import cavity as t_cavity
from cfd_julia_torch.parallel import launch
from cfd_julia_torch.parallel import mesh as t_mesh
from cfd_julia_torch.poisson import direct as t_direct
from cfd_julia_torch.poisson import multigrid as t_mg
from cfd_julia_torch.utils import checkpoint as t_checkpoint
from cfd_julia_tpu.models import cavity as j_cavity
from cfd_julia_tpu.models import poisson2d as j_poisson2d
from cfd_julia_tpu.parallel import halo as j_halo
from cfd_julia_tpu.parallel import mesh as j_mesh
from cfd_julia_tpu.parallel import sharded as j_sharded
from cfd_julia_tpu.poisson import direct as j_direct
from cfd_julia_tpu.poisson import multigrid as j_mg

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks  # noqa: E402

torch.set_num_threads(1)

WORLDS = (4, 2, 1)          # launch order: 2 and 1 load 4's checkpoint
N = 32
MG_N = 64
CAVITY_STEPS = 4
JACOBI_SWEEPS = 20
MG_CFG = dict(tol=1e-8, max_cycles=30, transfers="matmul", smoother="cheb",
              fused="off")


def _inputs():
    rng = np.random.default_rng(17)
    w, s = rng.standard_normal((2, N, N))
    jdx = 1.0 / N
    x = np.arange(N) * jdx
    X, Y = np.meshgrid(x, x, indexing="ij")
    jf = -8 * np.pi**2 * np.sin(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    nb = 256
    bu = np.sin(2 * np.pi * np.arange(nb) / nb) + 0.3
    cw0 = np.zeros((N + 1, N + 1))
    cw0[1:-1, 1:-1] = 0.1 * rng.standard_normal((N - 1, N - 1))
    cs0 = np.zeros((N + 1, N + 1))
    cs0[1:-1, 1:-1] = 1e-3 * rng.standard_normal((N - 1, N - 1))
    mgc = j_mg.MGConfig(**MG_CFG)
    pcfg = j_poisson2d.PoissonConfig(nx=MG_N, ny=MG_N, solver="multigrid",
                                     problem="poly", mg=mgc)
    _, _, _, _, ue, f = j_poisson2d.build_problem(pcfg, jnp.float64)
    u0 = j_poisson2d._dirichlet_init(ue)
    return {"w": w, "s": s, "dx": 2 * np.pi / N, "jf": jf, "jdx": jdx,
            "jacobi_sweeps": JACOBI_SWEEPS, "bu": bu, "bdx": 1.0 / nb,
            "cavity_n": N, "cavity_dt": 1e-3, "cavity_steps": CAVITY_STEPS,
            "cavity_w0": cw0, "cavity_s0": cs0, "mg_f": np.asarray(f),
            "mg_u0": np.asarray(u0), "mg_dx": pcfg.dx, "mg_cfg": MG_CFG,
            "level_sizes": (64, 4096)}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory, request):
    """{world: rank results} of the port, every group launched once; the
    JAX side's references are computed while the first group runs."""
    tmp = tmp_path_factory.mktemp("ckpt")
    path = {w: str(tmp / f"world{w}") for w in WORLDS}
    first = launch.start(torch_parallel_ranks.all_cases, 4, "cpu",
                         args=(inputs, path[4], None))
    request.getfixturevalue("jax_refs")
    out = {4: first.join()}
    saved = (path[4], out[4][0]["cavity"][0].shape)
    rest = {w: launch.start(torch_parallel_ranks.all_cases, w, "cpu",
                            args=(inputs, path[w], saved))
            for w in WORLDS[1:]}
    out.update({w: group.join() for w, group in rest.items()})
    return out


def _jmesh(k):
    return j_mesh.make_mesh(jax.devices()[:k])


def _place(a, mesh):
    return j_sharded.place(jnp.asarray(a), mesh)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shape_is_jax_factorisation(port, world):
    assert port[world][0]["mesh_shape"] == j_mesh.factor_2d(world)
    assert tuple(_jmesh(world).devices.shape) == j_mesh.factor_2d(world)


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_2d_matches_jax(n):
    assert t_mesh.factor_2d(n) == j_mesh.factor_2d(n)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(port, world):
    """Every rank returns the same gathered fields."""
    for r in port[world][1:]:
        for key in ("rhs", "jacobi", "burgers"):
            np.testing.assert_array_equal(r[key], port[world][0][key])


def _jax_refs_of(inputs, k):
    """The JAX package's results for a world of k on a k-device mesh."""
    mesh = _jmesh(k)
    refs = {}
    rhs = jax.jit(j_halo.make_distributed_vorticity_rhs(
        mesh, inputs["dx"], inputs["dx"], 100.0))
    refs["rhs"] = rhs(_place(inputs["w"], mesh), _place(inputs["s"], mesh))
    mesh1d = Mesh(np.array(jax.devices()[:k]), ("x",))
    burgers = jax.jit(j_halo.make_distributed_burgers_weno_rhs(
        mesh1d, inputs["bdx"]))
    refs["burgers"] = burgers(jax.device_put(
        jnp.asarray(inputs["bu"]), NamedSharding(mesh1d, PartitionSpec("x"))))
    sweep = jax.jit(j_halo.make_distributed_jacobi_step(
        mesh, inputs["jdx"], inputs["jdx"]))
    u = _place(np.zeros_like(inputs["jf"]), mesh)
    f = _place(inputs["jf"], mesh)
    for _ in range(JACOBI_SWEEPS):
        u = sweep(u, f)
    refs["jacobi"] = u
    cfg = j_cavity.CavityConfig(nx=N, ny=N, dt=inputs["cavity_dt"])
    step = j_sharded.make_sharded_cavity_step(cfg, mesh)
    st = tuple(j_sharded.place(j_sharded.pad_to_mesh(
        jnp.asarray(inputs[key]), mesh), mesh)
        for key in ("cavity_w0", "cavity_s0")) + (jnp.zeros(()),)
    for _ in range(CAVITY_STEPS):
        st = step(st)
    refs["cavity"] = st
    return jax.tree.map(np.asarray, refs)


def _jax_mesh_solve(inputs, fmg, k=4):
    import dataclasses as dc

    mgc = dc.replace(j_mg.MGConfig(**MG_CFG), fmg=fmg)
    return j_mg.solve(jnp.asarray(inputs["mg_f"]),
                      jnp.asarray(inputs["mg_u0"]), inputs["mg_dx"],
                      inputs["mg_dx"], cfg=mgc, mesh=_jmesh(k))


@pytest.fixture(scope="module")
def jax_refs(inputs):
    refs = {k: _jax_refs_of(inputs, k) for k in WORLDS}
    refs["mg"] = {name: _jax_mesh_solve(inputs, fmg)
                  for name, fmg in (("mg_vcycle", False), ("mg_fmg", True))}
    return refs


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["rhs", "burgers", "jacobi"])
def test_distributed_stencils(port, jax_refs, world, key):
    """make_distributed_vorticity_rhs (kernel 1's twin on framed blocks)
    on 32^2, the WENO-5 Burgers RHS on a 1D mesh of the world's ranks, and
    20 distributed Jacobi sweeps against JAX's shard_map forms."""
    np.testing.assert_allclose(port[world][0][key], jax_refs[world][key],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cavity_matches_jax(port, jax_refs, world):
    """4 steps of make_sharded_cavity_step at 32^2 against JAX's: padded
    arrays whole, the padding exactly zero on both."""
    ref = jax_refs[world]["cavity"]
    got = port[world][0]["cavity"]
    for g, r in zip(got[:2], ref[:2]):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12)
        assert not np.any(g[N + 1:]) and not np.any(g[:, N + 1:])
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_round_trip(port, world):
    """save_sharded, then load_sharded on the same mesh: bitwise."""
    same = port[world][0]["checkpoint"]["same"]
    for g, r in zip(same, port[world][0]["cavity"]):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("world", [2, 1])
def test_sharded_checkpoint_onto_another_world(port, world):
    """The 2x2 checkpoint restored into a (1, 2) and a (1, 1) mesh."""
    other = port[world][0]["checkpoint"]["other"]
    for g, r in zip(other, port[4][0]["cavity"]):
        np.testing.assert_array_equal(g, r)


def test_load_sharded_refuses_other_format(tmp_path):
    t_checkpoint.save_state(str(tmp_path / "plain"), (torch.zeros(3),))
    with pytest.raises(ValueError, match="torch.distributed.checkpoint"):
        t_checkpoint.load_sharded(str(tmp_path), (torch.zeros(3),))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["mg_vcycle", "mg_fmg"])
def test_mesh_multigrid_matches_jax(port, jax_refs, world, name):
    """The 64^2 mesh solve against JAX's 2x2 mesh solve: equal cycle
    counts, converged, u within rtol 1e-10; and against the port's world
    4 solve (world sizes agreeing)."""
    ref = jax_refs["mg"][name]
    got = port[world][0][name]
    assert got["iterations"] == int(ref.iterations)
    assert got["rel"] <= MG_CFG["tol"]
    np.testing.assert_allclose(got["u"], np.asarray(ref.u), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got["u"], port[4][0][name]["u"], rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_levels_match_jax(port, world):
    """The padded pyramid, extents and sharded axes, is JAX's."""
    mesh = _jmesh(world)
    for n, levels in port[world][0]["mg_levels"].items():
        ref = j_mg._mesh_levels(n, n, 1.0 / n, 1.0 / n, 0, mesh)
        assert [L[:6] for L in levels] == [tuple(L[:6]) for L in ref]
        assert [L[6:] for L in levels] == [tuple(L.spec) for L in ref]


def test_mesh_cfg_refusals():
    """Single-device options are refused loudly, never run as another
    solve (tests/test_parallel.py's refusals, and the port's impl)."""
    import dataclasses as dc

    mgc = t_mg.MGConfig(**MG_CFG)
    with pytest.raises(ValueError, match="transfers"):
        t_mg._mesh_cfg(dc.replace(mgc, transfers="conv"))
    with pytest.raises(ValueError, match="single-device"):
        t_mg._mesh_cfg(dc.replace(mgc, cycle_dtype="mixed"))
    with pytest.raises(ValueError, match="Chebyshev"):
        t_mg._mesh_cfg(dc.replace(mgc, smoother="xla"))
    with pytest.raises(ValueError, match="single-device"):
        t_mg._mesh_cfg(dc.replace(mgc, impl="kernel"))
    resolved = t_mg._mesh_cfg(t_mg.MGConfig())
    assert (resolved.transfers, resolved.smoother, resolved.fused) == \
        ("matmul", "cheb", "off")


def test_padded_step_matches_jax():
    """The single-device padded step (kernel 1's twin on the CPU) on
    (P, Q) = (40, 36) padded fields against JAX's make_padded_step_fn."""
    rng = np.random.default_rng(3)
    cfg = j_cavity.CavityConfig(nx=N, ny=N - 4, dt=1e-3)
    ps = (40, 36)
    w0 = np.zeros(ps)
    w0[1:N, 1:N - 4] = 0.1 * rng.standard_normal((N - 1, N - 5))
    ref = (jnp.asarray(w0), jnp.zeros(ps), jnp.zeros(()))
    step = jax.jit(j_cavity.make_padded_step_fn(cfg, ps))
    t_step = t_cavity.make_padded_step_fn(
        interop.cavity_config_from_jax(cfg), ps, torch.float64, "cpu")
    got = interop.state_from_numpy(w0, np.zeros(ps), torch.float64, "cpu")
    for _ in range(3):
        ref, got = step(ref), t_step(got)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(interop.to_numpy(g), np.asarray(r),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("order", [1, 2])
def test_wall_bc_fields_match_jax(order):
    """Rolls of the whole field, and slices of a framed block, against
    JAX's rolls."""
    s = np.random.default_rng(order).standard_normal((12, 10))
    ref = j_cavity._wall_bc_fields(jnp.asarray(s), 0.1, 0.2, order)
    st = torch.from_numpy(s)
    framed = torch.from_numpy(np.pad(s, 2, mode="wrap"))
    for halo, field in ((0, st), (2, framed)):
        got = t_cavity._wall_bc_fields(field, 0.1, 0.2, order, halo)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("shape", [(33, 33), (40, 36), (66, 68)])
def test_solve_fst_matmul_padded_matches_jax(shape):
    nx, ny = 32, 32
    f = np.random.default_rng(5).standard_normal(shape)
    solve = jax.jit(j_direct.solve_fst_matmul_padded,
                    static_argnums=(1, 2, 3, 4))
    ref = solve(jnp.asarray(f), nx, ny, 1 / nx, 1 / ny)
    got = t_direct.solve_fst_matmul_padded(torch.from_numpy(f), nx, ny,
                                           1 / nx, 1 / ny)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)
    assert not got[nx:].any() and not got[:, ny:].any()


def test_launch_names_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed first"):
        launch.run(torch_parallel_ranks.raise_on_rank, 2, "cpu", args=(1,))


def test_multichip_example_matches_jax_example(capsys):
    """`python -m cfd_julia_torch.examples.multichip_cavity` (main, 2
    ranks on the CPU, 10 steps) against the JAX package's example step
    (examples/multichip_cavity.py: 64^2 fp32 from rest) on a 2-device mesh:
    ||dpsi|| and psi_min within fp32 roundoff."""
    from cfd_julia_torch.examples import multichip_cavity

    steps = 10
    got = multichip_cavity.main(["--ranks", "2", "--device", "cpu",
                                 "--steps", str(steps)])
    mesh = _jmesh(2)
    cfg = j_cavity.CavityConfig(nx=64, ny=64)
    step = j_sharded.make_sharded_cavity_step(cfg, mesh)
    w0 = j_sharded.pad_to_mesh(jnp.zeros((65, 65), jnp.float32), mesh)
    st = (j_sharded.place(w0, mesh), j_sharded.place(jnp.zeros_like(w0),
                                                     mesh),
          jnp.zeros((), jnp.float32))
    for _ in range(steps):
        st = step(st)
    assert got["mesh"] == {"x": 1, "y": 2}
    np.testing.assert_allclose(got["dpsi"], float(st[2]), rtol=1e-4)
    np.testing.assert_allclose(got["psi_min"], float(np.asarray(st[1]).min()),
                               rtol=1e-5)
    assert "||dpsi||" in capsys.readouterr().out
