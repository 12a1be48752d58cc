"""Gradients through the port's mesh steps (the autograd Functions of
cfd_julia_torch/parallel/halo.py and transpose.py) against jax.grad of the
JAX package's mesh forms and the port's single-device gradients, fp64 on
the CPU at 32^2.

The port runs as spawned ranks over gloo (parallel/launch.py): one group
for each world size 4, 2 and 1, all started at once, each running every
case once (tests/torch_parallel_grad_ranks.py, which imports no JAX); the
JAX gradients run on the conftest's virtual CPU devices with a 4-device
mesh meanwhile (the padded matmul step, fdm and the half step under
lax.scan: XLA's CPU compile of their unrolled gradients runs for
minutes).  Each rank's loss is halo.all_reduce_sum(local loss), and its
.backward() leaves the global d loss/dRe in re.grad on every rank and
each rank's block of d loss/d(initial state) in its leaf.

Tolerances: the adjoint identities 1e-12 relative; the gradients 1e-9
relative (the Re gradients) or 1e-9 of the largest value (the fields);
the transposes of two runs, and a forward without grad against the
tracked one, bitwise.
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
from cfd_julia_tpu.parallel import mesh as j_mesh
from cfd_julia_tpu.parallel import sharded as j_sharded
from cfd_julia_tpu.stepping import ssprk3 as j_ssprk3

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_grad_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

WORLDS = (4, 2, 1)
N = 32
# a tensor Re that is not cfg.re (100) for the cavity, nor 1000 for fdm
RE, FDM_RE = 137.5, 437.5
CAVITY_STEPS, HALF_STEPS = 3, 2
FULL_DT, HALF_DT = 0.01, 5e-3
GRAD_RTOL = 1e-9
ADJOINT_RTOL = 1e-12


def _inputs():
    rng = np.random.default_rng(20)
    cw0 = np.zeros((N + 1, N + 1))
    cw0[1:-1, 1:-1] = 0.1 * rng.standard_normal((N - 1, N - 1))
    cfg = j_vortex.VortexConfig(nx=N, ny=N, solver="ps23")
    return {"n": N, "cavity_w0": cw0, "re": RE, "fdm_re": FDM_RE,
            "w0": np.asarray(j_vortex.initial_vorticity(cfg, jnp.float64)),
            "cavity_steps": CAVITY_STEPS, "steps": HALF_STEPS,
            "full_dt": FULL_DT, "half_dt": HALF_DT}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def port(inputs, request):
    """{world: rank results}, the three groups started at once and joined
    after the JAX side's gradients are computed."""
    groups = {w: launch.start(ranks.all_cases, w, "cpu", args=(inputs,))
              for w in WORLDS}
    request.getfixturevalue("jax_refs")
    return {w: g.join() for w, g in groups.items()}


def _cavity_loss(state):
    return jnp.sum(state[1] ** 2) + jnp.sum(state[0] ** 2)


def _jax_cavity(inputs, mesh, poisson):
    """jax.grad of ranks' cavity loss through make_step_fn(cfg, mesh,
    re=) in (re, initial w)."""
    cfg = j_cavity.CavityConfig(nx=N, ny=N, poisson=poisson)

    def loss(re, w0):
        step = j_cavity.make_step_fn(cfg, mesh=mesh, re=re)
        st = (w0, jnp.zeros_like(w0), jnp.zeros(()))
        for _ in range(CAVITY_STEPS):
            st = step(st)
        return _cavity_loss(st)

    g_re, g_w = jax.jit(jax.grad(loss, (0, 1)))(
        jnp.asarray(RE), jnp.asarray(inputs["cavity_w0"]))
    return {"re_grad": float(g_re), "w_grad": np.asarray(g_w)}


def _jax_matmul(inputs, mesh):
    """jax.grad in the initial w of the loss through the sharded padded
    matmul step (JAX's parallel/sharded.make_sharded_cavity_step)."""
    cfg = j_cavity.CavityConfig(nx=N, ny=N, re=RE)
    step = j_sharded.make_sharded_cavity_step(cfg, mesh)
    P, Q = j_sharded.padded_shape((N + 1, N + 1), mesh)
    w0 = np.zeros((P, Q))
    w0[:N + 1, :N + 1] = inputs["cavity_w0"]

    def loss(w):
        st, _ = jax.lax.scan(lambda s, _: (step(s), None),
                             (w, jnp.zeros_like(w), jnp.zeros(())), None,
                             CAVITY_STEPS)
        return _cavity_loss(st)

    return np.asarray(jax.jit(jax.grad(loss))(
        j_sharded.place(jnp.asarray(w0), mesh)))


def _jax_fdm(inputs, mesh):
    """jax.grad in Re of sum(w^2) after SSP-RK3 steps over JAX's
    fdm_rhs(w, dx, dy, jnp.asarray(re), mesh=)."""
    cfg = j_vortex.VortexConfig(nx=N, ny=N, solver="fdm", dt=FULL_DT)

    w0 = j_sharded.place(jnp.asarray(inputs["w0"]), mesh)

    def loss(re):
        def step(w, _):
            return j_ssprk3.ssprk3_step(
                lambda u: j_vortex.fdm_rhs(u, cfg.dx, cfg.dy, re, mesh=mesh),
                w, cfg.dt), None

        w, _ = jax.lax.scan(step, w0, None, CAVITY_STEPS)
        return jnp.sum(w ** 2)

    return float(jax.jit(jax.grad(loss))(jnp.asarray(FDM_RE)))


def _jax_half(inputs, mesh):
    """The gradient in the initial w of sum(w^2) after ps23 half steps
    through JAX's make_spectral_step_half(cfg, dtype, mesh), half_init and
    half_decode, in forward mode (jax.jacfwd of the scalar loss): jax.grad
    of it on the CPU mesh stops at XLA's CPU FFT, which refuses the
    transposed layout that the reverse pass hands it."""
    cfg = j_vortex.VortexConfig(nx=N, ny=N, solver="ps23", dt=HALF_DT)
    step = j_vortex.make_spectral_step_half(cfg, jnp.float64, mesh)

    def loss(w0):
        h, _ = jax.lax.scan(lambda h, _: (step(h), None),
                            j_vortex.half_init(w0), None, HALF_STEPS)
        return jnp.sum(j_vortex.half_decode(h, N, jnp.float64) ** 2)

    return np.asarray(jax.jit(jax.jacfwd(loss))(
        j_sharded.place(jnp.asarray(inputs["w0"]), mesh)))


@pytest.fixture(scope="module")
def jax_refs(inputs):
    mesh = j_mesh.make_mesh(jax.devices()[:4])
    return {"cavity": {p: _jax_cavity(inputs, mesh, p)
                       for p in ("fst", "fst_half")},
            "matmul": _jax_matmul(inputs, mesh),
            "fdm": _jax_fdm(inputs, mesh),
            "half": _jax_half(inputs, mesh)}


def _rel(got, ref):
    return abs(got - ref) / abs(ref)


def _field_close(got, ref, tol=GRAD_RTOL):
    """got's logical (N+1)^2 part within tol of max|ref| of ref, and its
    padding exactly zero."""
    n = ref.shape[0]
    err = np.abs(got[:n, :n] - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())
    assert not got[n:].any() and not got[:, n:].any()


def _adjoint_cases():
    """(world, op) of every collective and move; a block move of a shape
    that does not divide over the world's mesh is not made."""
    ops = ["halo_2d_w1", "halo_2d_w2", "halo_1d_w3", "gather_x", "gather_y",
           "all_reduce_sum", "replicate"]
    out = []
    for world in WORLDS:
        px, py = j_mesh.factor_2d(world)
        moves = [f"{m}_{key}" for m in ranks.MOVES
                 for key, (n, k) in ranks.TRANSPOSE_SHAPES.items()
                 if "block" not in m or (n % px == 0 and k % py == 0)]
        out += [(world, op) for op in ops + moves]
    return out


@pytest.mark.parametrize("world,op", _adjoint_cases())
def test_collective_adjoint(port, world, op):
    """sum over ranks <A x, y> = sum over ranks <x, A^T y> (a replicated
    side once), A^T the backward; two backward runs bitwise equal; the
    forward without grad bitwise the tracked one, and untracked."""
    assert set(port[world][0]["adjoint"]) == {
        o for w, o in _adjoint_cases() if w == world}
    for r in port[world]:
        got = r["adjoint"][op]
        assert _rel(got["rhs"], got["lhs"]) <= ADJOINT_RTOL, got
        assert got["bitwise"] and got["nograd"], got


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("poisson", ["fst", "fst_half"])
def test_cavity_mesh_gradients(port, jax_refs, world, poisson):
    """make_step_fn(cfg, mesh=, re=<0-d tensor>): d loss/dRe on every rank
    and the gathered d loss/d(initial w) against jax.grad of JAX's
    make_step_fn(cfg, mesh, re=) on 4 devices and against the port's
    single-device gradient, 0 on the padding; without grad the run is
    bitwise the tracked one."""
    ref = jax_refs["cavity"][poisson]
    single = port[1][0]["single"]["cavity"][poisson]
    for r in port[world]:
        got = r["cavity"][poisson]
        assert _rel(got["re_grad"], ref["re_grad"]) <= GRAD_RTOL
        assert _rel(got["re_grad"], single["re_grad"]) <= GRAD_RTOL
        _field_close(got["w_grad"], ref["w_grad"])
        _field_close(got["w_grad"], single["w_grad"])
        assert got["nograd"]


@pytest.mark.parametrize("world", WORLDS)
def test_matmul_mesh_state_gradient(port, jax_refs, world):
    """The sharded matmul step's d loss/d(initial w) against jax.grad of
    JAX's make_sharded_cavity_step; a tensor Re raises, naming fst."""
    ref = jax_refs["matmul"][:N + 1, :N + 1]
    for r in port[world]:
        _field_close(r["cavity"]["matmul"]["w_grad"], ref)
        assert r["cavity"]["matmul"]["nograd"]
        assert "fst" in r["matmul_refusal"]


@pytest.mark.parametrize("world", WORLDS)
def test_fdm_mesh_re_gradient(port, jax_refs, world):
    """SSP-RK3 over make_fdm_rhs(mesh=, re=<0-d tensor>): d sum(w^2)/dRe
    against jax.grad through JAX's fdm_rhs(..., jnp.asarray(re), mesh=)."""
    for r in port[world]:
        assert _rel(r["fdm"]["re_grad"], jax_refs["fdm"]) <= GRAD_RTOL
        assert r["fdm"]["nograd"]


@pytest.mark.parametrize("world", WORLDS)
def test_half_step_initial_field_gradient(port, jax_refs, world):
    """The ps23 half step on row slabs: d sum(w^2)/d(initial w) against
    the gradient through JAX's make_spectral_step_half(cfg, dtype, mesh)
    on 4 devices and against the port's single-device gradient."""
    single = port[1][0]["single"]["half"]
    for r in port[world]:
        got = r["half"]["w_grad"]
        for ref in (jax_refs["half"], single):
            err = np.abs(got - ref).max()
            assert err <= GRAD_RTOL * np.abs(ref).max(), err
        assert r["half"]["nograd"]


def test_multichip_example_gradient(capsys):
    """`python -m cfd_julia_torch.examples.multichip_cavity --grad` (main,
    2x2 ranks, 3 steps at 32^2) prints the single-device
    make_step_fn(cfg, re=) fst gradient of the same loss (rel 1e-9)."""
    from cfd_julia_torch.examples import multichip_cavity
    from cfd_julia_torch.models import cavity

    got = multichip_cavity.main(["--ranks", "4", "--device", "cpu",
                                 "--grad", "--nx", str(N), "--steps",
                                 str(CAVITY_STEPS)])
    assert "d(1e6 mean psi^2)/dRe" in capsys.readouterr().out
    cfg = cavity.CavityConfig(nx=N, ny=N, poisson="fst")
    re = torch.tensor(cfg.re, dtype=torch.float64, requires_grad=True)
    step = cavity.make_step_fn(cfg, torch.float64, "cpu", re=re)
    st = cavity.initial_state(cfg, torch.float64, "cpu")
    for _ in range(CAVITY_STEPS):
        st = step(st)
    (1e6 * (st[1] ** 2).sum() / (N + 1) ** 2).backward()
    assert _rel(got["re_grad"], float(re.grad)) <= GRAD_RTOL
    assert got["mesh"] == {"x": 2, "y": 2}
