"""The port's periodic spectral family on a mesh of ranks (the pencil
transposes of cfd_julia_torch/parallel/transpose.py, the mesh forms of
ops/spectral.py and poisson/direct.py, the sharded fdm / hybrid / ps23 /
ps32 steps and the cavity's fst / fst_half solve) against the JAX
package's mesh forms (tests/test_parallel.py's cases), fp64 on the CPU at
32^2.

The port runs as spawned ranks over gloo (parallel/launch.py): one group
for each world size 4, 2 and 1, all started at once and each running
every case once (tests/torch_parallel_spectral_ranks.py, which imports no
JAX) and returning the gathered global results; the JAX side runs on the
conftest's virtual CPU devices with meshes of `make_mesh(jax.devices()[:k])`
meanwhile (the half steps on every k, the rest on 4 devices:
`_jax_steps`).  The JAX states are its packed Re/Im stacks, unpacked here
as h[0] + 1j h[1].

Tolerances: the transposes bitwise; the transforms and solves 1e-12 of
their scale; the steps JAX's own rtol 1e-10, atol 1e-12
(tests/test_parallel.py: the transforms add in another order).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch.parallel import launch
from cfd_julia_tpu.models import cavity as j_cavity
from cfd_julia_tpu.models import vortex as j_vortex
from cfd_julia_tpu.ops import spectral as j_spectral
from cfd_julia_tpu.parallel import mesh as j_mesh
from cfd_julia_tpu.parallel import sharded as j_sharded
from cfd_julia_tpu.poisson import direct as j_direct

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_spectral_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

WORLDS = (4, 2, 1)
N = 32
STEPS = 2
CAVITY_STEPS = 3
FULL_DT, HALF_DT = 0.01, 5e-3
# the fdm RHS's tensor Re: not the config's 1000
FDM_RE = 437.5
# ragged extents: 31 rows and the 17 columns of a 32^2 half spectrum
TRANSPOSE_SHAPES = {"31x17": (31, 17), "32x17": (32, 17), "32x32": (32, 32),
                    "34x34": (34, 34)}
TRANSFORM_SHAPES = {"32x32": (32, 32), "30x18": (30, 18)}
DST_SHAPE = (31, 23)


def _inputs():
    rng = np.random.default_rng(18)
    inp = {"transpose": {k: rng.standard_normal((2, *s))
                         + 1j * rng.standard_normal((2, *s))
                         for k, s in TRANSPOSE_SHAPES.items()},
           "transform": {k: rng.standard_normal(s)
                         for k, s in TRANSFORM_SHAPES.items()}}
    inp["spectrum"] = {k: np.fft.fft2(rng.standard_normal(s))
                       for k, s in TRANSFORM_SHAPES.items()}
    inp["half"] = {k: np.fft.rfft2(rng.standard_normal(s))
                   for k, s in TRANSFORM_SHAPES.items()}
    inp["dst"] = rng.standard_normal(DST_SHAPE)
    inp["periodic"] = rng.standard_normal((N, N))
    inp["grid"] = rng.standard_normal((N + 1, N + 1))
    inp["dx"], inp["dy"] = 1.0 / N, 1.3 / N
    cfg = j_vortex.VortexConfig(nx=N, ny=N, solver="ps23", dt=HALF_DT)
    w0 = j_vortex.initial_vorticity(cfg, jnp.float64)
    inp["w0"] = np.asarray(w0)
    inp["wf0"] = np.asarray(j_spectral.zero_mean_mode(
        jnp.fft.fft2(w0.astype(jnp.complex128))))
    h0 = np.asarray(jax.jit(j_vortex.half_init_packed)(w0))
    inp["h0"] = h0[0] + 1j * h0[1]
    cw0 = np.zeros((N + 1, N + 1))
    cw0[1:-1, 1:-1] = 0.1 * rng.standard_normal((N - 1, N - 1))
    inp["cavity_w0"] = cw0
    inp.update(steps=STEPS, cavity_steps=CAVITY_STEPS, full_dt=FULL_DT,
               half_dt=HALF_DT, fdm_re=FDM_RE)
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def port(inputs, request):
    """{world: rank results} of the port, the three groups started at once
    and joined after the JAX side's references are computed."""
    groups = {w: launch.start(ranks.all_cases, w, "cpu", args=(inputs,))
              for w in WORLDS}
    request.getfixturevalue("jax_refs")
    return {w: g.join() for w, g in groups.items()}


def _jmesh(k):
    return j_mesh.make_mesh(jax.devices()[:k])


def _unpack(h):
    h = np.asarray(h)
    return h[0] + 1j * h[1]


def _jax_steps(inputs, k):
    """The JAX package's sharded steps on a k-device mesh: the half steps
    for every k; the full-spectrum and fdm steps and the fst cavity, which
    compile slowest, on 4 devices only (every world of the port is held
    against those; JAX's own tests hold its worlds together)."""
    mesh = _jmesh(k)
    out = {"full": {}, "half": {}, "cavity": {}}
    cfg = j_vortex.VortexConfig(nx=N, ny=N, solver="fdm", dt=FULL_DT)
    out["fdm_rhs_re"] = np.asarray(jax.jit(
        lambda w, re: j_vortex.fdm_rhs(w, cfg.dx, cfg.dy, re, mesh=mesh))(
            j_sharded.place(jnp.asarray(inputs["w0"]), mesh),
            jnp.asarray(FDM_RE)))
    for solver in ranks.SOLVERS if k == 4 else ():
        cfg = j_vortex.VortexConfig(nx=N, ny=N, solver=solver, dt=FULL_DT)
        step = j_sharded.make_sharded_vortex_step(cfg, mesh, jnp.float64)
        if solver == "fdm":
            x = j_sharded.place(jnp.asarray(inputs["w0"]), mesh)
        else:
            x = jax.device_put(
                j_spectral.pack_c(jnp.asarray(inputs["wf0"])),
                j_sharded.packed_full_sharding(mesh))
        for _ in range(STEPS):
            x = step(x)
        out["full"][solver] = np.asarray(x) if solver == "fdm" \
            else _unpack(x)
    for solver in ranks.HALF_SOLVERS:
        cfg = j_vortex.VortexConfig(nx=N, ny=N, solver=solver, dt=HALF_DT)
        step = j_sharded.make_sharded_vortex_step_half(cfg, mesh, jnp.float64)
        h = jax.device_put(j_spectral.pack_c(jnp.asarray(inputs["h0"])),
                           j_sharded.packed_half_sharding(mesh))
        for _ in range(STEPS):
            h = step(h)
        out["half"][solver] = _unpack(h)
    for poisson in ("fst", "fst_half") if k == 4 else ():
        cfg = j_cavity.CavityConfig(nx=N, ny=N, poisson=poisson)
        step = jax.jit(j_cavity.make_step_fn(cfg, mesh=mesh))
        w0 = jnp.asarray(inputs["cavity_w0"])
        st = (w0, jnp.zeros_like(w0), jnp.zeros(()))
        for _ in range(CAVITY_STEPS):
            st = step(st)
        out["cavity"][poisson] = tuple(np.asarray(a) for a in st)
    return out


def _jax_transforms(inputs):
    """The JAX package's mesh transforms and solves on its 4-device mesh
    (32^2; the DST's own row padding takes the ragged 31 x 23)."""
    mesh = _jmesh(4)
    x = jnp.asarray(inputs["transform"]["32x32"])
    out = {"fft2": jax.jit(lambda a: j_spectral.fft2(a, mesh))(x),
           "rfft2": jax.jit(lambda a: j_spectral.rfft2(a, mesh))(x),
           "ifft2": jax.jit(lambda a: j_spectral.ifft2(a, mesh))(
               jnp.asarray(inputs["spectrum"]["32x32"]))}
    v = jnp.asarray(inputs["dst"])
    dx, dy = inputs["dx"], inputs["dy"]
    for impl in ("rfft", "half"):
        out[f"dst_{impl}"] = {
            "axis-1": jax.jit(lambda a: j_spectral.dst1(
                a, -1, mesh, impl))(v),
            "axis-2": jax.jit(lambda a: j_spectral.dst1(
                a, -2, mesh, impl))(v),
            "fst": jax.jit(lambda a: j_spectral.fst_poisson_dirichlet(
                a, dx, dy, mesh, impl))(v),
            "dst1_2d": jax.jit(lambda a: j_spectral.dst1_2d(
                a, impl=impl))(v),
            "idst1_2d": jax.jit(lambda a: j_spectral.idst1_2d(
                a, 7, 9, impl=impl))(v)}
    f = jnp.asarray(inputs["periodic"])
    out["fft_poisson"] = {eigen: jax.jit(
        lambda a: j_spectral.fft_poisson_periodic(a, dx, dy, eigen,
                                                  mesh=mesh))(f)
        for eigen in ("fdm", "spectral")}
    g = jnp.asarray(inputs["grid"])
    out["solve_fft"] = jax.jit(lambda a: j_direct.solve_fft(
        a, dx, dy, mesh=mesh))(g)
    for impl in ("rfft", "half"):
        out[f"solve_fst_{impl}"] = jax.jit(lambda a: j_direct.solve_fst(
            a, dx, dy, mesh, impl))(g)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def jax_refs(inputs):
    refs = {k: _jax_steps(inputs, k) for k in WORLDS}
    refs["transform"] = _jax_transforms(inputs)
    return refs


def _close(got, ref, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _close_scaled(got, ref, tol=1e-12):
    """|got - ref| within tol of max|ref|."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shape_is_jax_factorisation(port, world):
    assert port[world][0]["mesh_shape"] == j_mesh.factor_2d(world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("shape", list(TRANSPOSE_SHAPES))
def test_transposes_are_the_global_slices(port, world, shape):
    """Every move against the global array's slices, and the round trip
    row -> column -> row slab, bitwise on every rank; block moves where the
    shape divides over the mesh (34 rows over 4 ranks: the all-ranks form
    of block <-> row slab)."""
    for r in port[world]:
        res = r["transpose"][shape]
        assert all(res.values()), res
        px, py = j_mesh.factor_2d(world)
        n, m = TRANSPOSE_SHAPES[shape]
        assert ("block_to_rows" in res) == (n % px == 0 and m % py == 0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("shape", list(TRANSFORM_SHAPES))
def test_pencil_transforms(port, inputs, jax_refs, world, shape):
    """fft2, ifft2, rfft2 and the c2r inverse against numpy, and at 32^2
    against the JAX package's mesh forms on 4 devices: 1e-12."""
    got = port[world][0]["transform"][shape]
    x = inputs["transform"][shape]
    nx, ny = x.shape
    ref = {"fft2": np.fft.fft2(x), "rfft2": np.fft.rfft2(x),
           "ifft2": np.fft.ifft2(inputs["spectrum"][shape]),
           "irfft2": np.fft.irfft2(inputs["half"][shape], s=(nx, ny))}
    for key, r in ref.items():
        _close_scaled(got[key], r)
    if shape == "32x32":
        for key in ("fft2", "rfft2", "ifft2"):
            _close_scaled(got[key], jax_refs["transform"][key])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["rfft", "half"])
def test_dst_on_both_axes(port, jax_refs, world, impl):
    """dst1 along each axis on its slab and the Dirichlet solve at a ragged
    31 x 23 against JAX's mesh forms; the 2D pair and its inverse against
    JAX's dst1_2d / idst1_2d: 1e-12."""
    got = port[world][0]["transform"][f"dst_{impl}"]
    ref = jax_refs["transform"][f"dst_{impl}"]
    for key in ("axis-1", "axis-2", "fst", "dst1_2d", "idst1_2d"):
        _close_scaled(got[key], ref[key])


@pytest.mark.parametrize("world", WORLDS)
def test_periodic_and_direct_solves(port, jax_refs, world):
    """fft_poisson_periodic (both eigenvalue modes), solve_fft and
    solve_fst (rfft, half) on blocks of the padded node grid against JAX's
    mesh forms: 1e-12, the padding exactly zero."""
    got = port[world][0]["transform"]
    ref = jax_refs["transform"]
    for eigen in ("fdm", "spectral"):
        _close_scaled(got["fft_poisson"][eigen], ref["fft_poisson"][eigen])
    for key in ("solve_fft", "solve_fst_rfft", "solve_fst_half"):
        g = got[key]
        _close_scaled(g[:N + 1, :N + 1], ref[key])
        assert not g[N + 1:].any() and not g[:, N + 1:].any()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", ranks.SOLVERS)
def test_sharded_vortex_step_matches_jax(port, jax_refs, world, solver):
    """make_sharded_vortex_step, two steps: fdm's real blocks and the full
    complex spectrum's, against JAX's sharded step on 4 devices."""
    _close(port[world][0]["full"][solver], jax_refs[4]["full"][solver])


@pytest.mark.parametrize("world", WORLDS)
def test_fdm_rhs_tensor_re_matches_jax(port, jax_refs, world):
    """vortex.make_fdm_rhs(cfg, mesh=, re=<0-d fp64 tensor>) on the rank's
    blocks against JAX's fdm_rhs(w, dx, dy, jnp.asarray(re), mesh=) on as
    many devices, a traced Re that is not cfg.re."""
    _close(port[world][0]["fdm_rhs_re"], jax_refs[world]["fdm_rhs_re"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("solver", ranks.HALF_SOLVERS)
def test_sharded_half_step_matches_jax(port, jax_refs, world, solver):
    """make_sharded_vortex_step_half, two steps on row slabs of the half
    spectrum, against JAX's packed half step on k devices."""
    _close(port[world][0]["half"][solver], jax_refs[world]["half"][solver])


@pytest.mark.parametrize("world", WORLDS)
def test_half_init_and_decode(port, inputs, world):
    """vortex.half_init and half_decode on row slabs: the half spectrum of
    the vortex merger's w0 (JAX's half_init_packed, unpacked) and, back
    from it, w0 less its mean, 1e-12."""
    got = port[world][0]["half"]
    _close_scaled(got["init"], inputs["h0"])
    _close_scaled(got["decode"], inputs["w0"] - inputs["w0"].mean())


@pytest.mark.parametrize("world", [2, 4])
def test_half_step_world_sizes_agree(port, world):
    """The half ps23 step on 1, 2 and 4 ranks (counterpart of
    test_weak_scaling_device_counts_agree)."""
    _close(port[world][0]["half"]["ps23"], port[1][0]["half"]["ps23"])


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(port, world):
    for r in port[world][1:]:
        for solver in ranks.SOLVERS:
            np.testing.assert_array_equal(r["full"][solver],
                                          port[world][0]["full"][solver])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("poisson", ["fst", "fst_half"])
def test_sharded_cavity_fst_matches_jax(port, jax_refs, world, poisson):
    """The cavity with the pencil DST, three steps on blocks of the padded
    field (kernel 1's twin on the framed blocks) against JAX's
    make_step_fn(cfg, mesh=) on 4 devices: the padding exactly zero."""
    got = port[world][0]["cavity"][poisson]
    ref = jax_refs[4]["cavity"][poisson]
    for g, r in zip(got[:2], ref[:2]):
        _close(g[:N + 1, :N + 1], r)
        assert not g[N + 1:].any() and not g[:, N + 1:].any()
    np.testing.assert_allclose(got[2], float(ref[2]), rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_refusals(port, world):
    """Names the mesh paths do not run raise, naming what does."""
    got = port[world][0]["refusals"]
    assert "fst" in got["cavity_poisson"] and "matmul" in \
        got["cavity_poisson"]
    assert "single-device" in got["step_fn_matmul"]
    assert (got["ragged_grid"] is None) == (world == 1)
    assert "fdm" in got["half_fdm"]
    assert "global shape" in got["no_shape"]
    assert "axis" in got["dst_axis"]


@pytest.mark.parametrize("world", WORLDS)
def test_steps_run_no_gather(port, world):
    """One step of every mesh path (the four full steps, the three half
    steps, the fst and fst_half cavity) with dist.all_gather (tensor and
    object forms), broadcast and any all_reduce of a field made to raise:
    none gathers, and each transpose's all-to-all sends a rank's elements
    once and receives only what it returns."""
    for r in port[world]:
        errors, n_calls = r["no_gather"]
        assert all(e is None for e in errors.values()), errors
        assert (n_calls > 0) == (world > 1)
