"""Reverse-mode gradients through cfd_julia_torch vs cfd_julia_tpu
(the port's counterparts of tests/test_autodiff.py).

torch.autograd runs through the eager loop (loop.advance(...,
graph=False)): the RK stages, the DST / FFT Poisson solves and the Arakawa
RHS, whose kernel has a hand-written backward on the GPU
(cuda_kernels.arakawa_rhs_backward) and whose twin autograd differentiates
on the CPU.  Each gradient, in fp64, against the JAX package's jax.grad of
the same function (rel 1e-9: two reverse sweeps of one program, roundoff
apart) and against central finite differences of the port's own loss
(rtol 1e-4, the FD truncation at h = 0.5; 1e-6 for the spectral step at
h = 1e-6).  The backward's plain version is held against
torch.autograd.grad of the twin and jax.vjp of the JAX RHS within 1e-12 of
the scale; the graphed loop refuses what it cannot differentiate.

The packed step (models/cavity_fused.py) and the bf16 tiers: the packed
fp64 step's gradients in Re and in the whole packed state against jax.grad
of the JAX package's packed step (rel 1e-9, and 1e-9 of the state
gradient's scale), the tiers' Re gradients against JAX's CPU gradient
(which runs the tiers in fp32: an accuracy check), the tier Functions'
backward bitwise the tier product of the cotangent, and the stage
kernel's backward's plain version against autograd of the stage's twin
(1e-12 of the scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.models import cavity, cavity_fused, ensemble, vortex
from cfd_julia_torch.ops import arakawa, cuda_kernels
from cfd_julia_torch.stepping import loop
from cfd_julia_tpu.models import cavity as jax_cavity
from cfd_julia_tpu.models import cavity_fused as jax_cavity_fused
from cfd_julia_tpu.models import ensemble as jax_ensemble
from cfd_julia_tpu.models import vortex as jax_vortex
from cfd_julia_tpu.ops import arakawa as jax_arakawa
from cfd_julia_tpu.stepping import loop as jax_loop

torch.set_num_threads(1)

F64 = torch.float64


# ------------------------------------------------------------- the cavity

def _jax_cavity_cfg(nx, poisson):
    return jax_cavity.CavityConfig(nx=nx, ny=nx, dt=1e-3, poisson=poisson)


def _jax_cavity_loss(re, nx, steps, poisson):
    """tests/test_autodiff.py's _cavity_loss with the Poisson solve named."""
    step = jax_cavity.make_step_fn(_jax_cavity_cfg(nx, poisson), re=re)
    w0 = jnp.zeros((nx + 1, nx + 1), jnp.float64)
    state = (w0, jnp.zeros_like(w0), jnp.zeros((), jnp.float64))
    return 1e6 * jnp.mean(jax_loop.run_steps(step, state, steps)[1] ** 2)


def _cavity_loss(re, nx, steps, poisson):
    """The same functional through the port: 1e6 mean(psi^2) after `steps`
    eager steps from rest; re a float or a 0-d tensor."""
    cfg = interop.cavity_config_from_jax(_jax_cavity_cfg(nx, poisson))
    step = cavity.make_step_fn(cfg, F64, "cpu", re=re)
    final = loop.advance(step, cavity.initial_state(cfg, F64, "cpu"), steps,
                         graph=False)
    return 1e6 * torch.mean(final[1] ** 2)


def _grad_re(loss, re):
    r = torch.tensor(re, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(r), r)
    return float(g)


@pytest.mark.parametrize("poisson", ["fst", "matmul"])
def test_cavity_grad_wrt_reynolds(poisson):
    """d loss / d Re through 40 cavity steps (nx = 24, dt = 1e-3): against
    jax.grad of the JAX step with a traced re, and central FD."""
    loss = lambda r: _cavity_loss(r, 24, 40, poisson)
    g = _grad_re(loss, 100.0)
    ref = float(jax.grad(lambda r: _jax_cavity_loss(r, 24, 40, poisson))(
        100.0))
    assert np.isfinite(g) and abs(g) > 0
    np.testing.assert_allclose(g, ref, rtol=1e-9)
    h = 0.5
    with torch.no_grad():
        fd = (float(loss(100.0 + h)) - float(loss(100.0 - h))) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=1e-4)


def test_cavity_grads_per_member():
    """Per-member sensitivities at Re 80 / 100 / 120 (nx = 16, 10 steps)
    against jax.vmap(jax.grad(...)): three distinct values."""
    res = (80.0, 100.0, 120.0)
    got = [_grad_re(lambda r: _cavity_loss(r, 16, 10, "fst"), re)
           for re in res]
    ref = np.asarray(jax.vmap(jax.grad(
        lambda r: _jax_cavity_loss(r, 16, 10, "fst")))(jnp.asarray(res)))
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    assert np.all(np.isfinite(got)) and len(set(got)) == 3


# ------------------------------------------------- the spectral step (ps23)

def test_grad_wrt_ic_through_spectral_step():
    """Gradient of sum(w^2) after 10 ps23 steps (32^2, dt = 5e-3) w.r.t.
    the initial field, through the half-spectrum step (complex
    intermediates, the mean mode's clone-and-assign): the directional
    derivative against FD, the field against jax.grad through JAX's
    unpacked half-spectrum step (the packed one is a TPU formulation the
    port does not have)."""
    jcfg = jax_vortex.VortexConfig(nx=32, ny=32, solver="ps23", dt=5e-3)
    cfg = interop.vortex_config_from_jax(jcfg)
    step = vortex.make_spectral_step_half(cfg, F64, "cpu")

    def loss(w0):
        hf = loop.advance(step, vortex.half_init(w0), 10, graph=False)
        return torch.sum(vortex.half_decode(hf, cfg.nx, cfg.ny) ** 2)

    jstep = jax_vortex.make_spectral_step_half(jcfg, jnp.float64)

    def jax_loss(w0):
        hf = jax_loop.run_steps(jstep, jax_vortex.half_init(w0), 10)
        return jnp.sum(jax_vortex.half_decode(hf, jcfg.ny, jnp.float64) ** 2)

    w0_np = np.asarray(jax_vortex.initial_vorticity(jcfg, jnp.float64))
    w0 = torch.tensor(w0_np, requires_grad=True)
    (g,) = torch.autograd.grad(loss(w0), w0)
    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(w0_np)))
    assert np.abs(g.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()

    v = torch.as_tensor(np.random.default_rng(11).standard_normal(w0.shape))
    h = 1e-6
    with torch.no_grad():
        fd = (float(loss(w0 + h * v)) - float(loss(w0 - h * v))) / (2 * h)
    np.testing.assert_allclose(float(torch.sum(g * v)), fd, rtol=1e-6)


# ------------------------------------------------------------ the ensemble

def test_ensemble_grad_wrt_reynolds():
    """The (B,) gradient of sum_b mean(w_b^2) after 5 fdm steps (16^2 TGV)
    w.r.t. Re 10 / 100 / 1000 in one backward pass, against jax.grad
    through JAX's vmapped sweep: three distinct values."""
    jcfg = jax_vortex.VortexConfig(nx=16, ny=16, solver="fdm", dt=0.01,
                                   t_final=0.05, ic="tgv", tgv_n=2)
    cfg = interop.vortex_config_from_jax(jcfg)
    assert cfg.nt == 5
    res = (10.0, 100.0, 1000.0)
    r = torch.tensor(res, dtype=F64, requires_grad=True)
    out = ensemble.vortex_fdm_re_sweep(cfg, r, F64, "cpu")
    (g,) = torch.autograd.grad(torch.mean(out.w ** 2, (-2, -1)).sum(), r)

    def jax_loss(rr):
        w = jax_ensemble.vortex_fdm_re_sweep(jcfg, rr, jnp.float64).w
        return jnp.sum(jnp.mean(w ** 2, axis=(1, 2)))

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(res)))
    assert g.shape == (3,)
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-9)
    assert len(set(g.tolist())) == 3


# ------------------------------------------------- the RHS's backward formulas

BACKWARD_SHAPES = [(3, 1), (2, 2), (7, 5), (33, 17), (3, 9, 5)]


def _backward_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    w, s, g = (rng.standard_normal(shape) for _ in range(3))
    re = rng.uniform(50.0, 150.0, shape[:-2]) if len(shape) > 2 else 77.0
    return w, s, g, re


def _jax_vjp(w, s, g, dx, dy, re):
    """jax.vjp of the JAX RHS, a member at a time for a batch."""
    def one(w, s, g, re):
        _, vjp = jax.vjp(lambda a, b, r: jax_arakawa.vorticity_rhs(
            a, b, dx, dy, r), w, s, re)
        return vjp(g)

    if w.ndim == 2:
        return [np.asarray(x) for x in one(w, s, g, jnp.float64(re))]
    return [np.asarray(x) for x in jax.vmap(one)(w, s, g, jnp.asarray(re))]


@pytest.mark.parametrize("shape", BACKWARD_SHAPES,
                         ids=["x".join(map(str, s)) for s in BACKWARD_SHAPES])
def test_backward_plain_matches_autograd_and_jax(shape):
    """gw, gs and gre of arakawa_rhs_backward_plain against the autograd
    of the twin and jax.vjp, within 1e-12 of each output's scale: its
    largest value, or the size of its Jacobian term (gg max|a| max|b|),
    whichever is larger; with one column the Jacobian is zero and both
    sides are roundoff."""
    w, s, g, re = _backward_inputs(shape, seed=sum(shape))
    dx, dy = 0.3, 0.7
    gg = 1.0 / (4 * dx * dy)
    wt, st, gt = (torch.as_tensor(a) for a in (w, s, g))
    ret = torch.as_tensor(re, dtype=F64)
    got = cuda_kernels.arakawa_rhs_backward_plain(wt, st, gt, dx, dy,
                                                  ret if len(shape) > 2
                                                  else re)
    leaves = [t.clone().requires_grad_() for t in (wt, st, ret)]
    auto = torch.autograd.grad(
        arakawa.vorticity_rhs(*leaves[:2], dx, dy, leaves[2]), leaves, gt)
    ref_jax = _jax_vjp(*(jnp.asarray(a) for a in (w, s, g)), dx, dy, re)
    jac = {0: gg * np.abs(s).max() * np.abs(g).max(),
           1: gg * np.abs(g).max() * np.abs(w).max(), 2: 0.0}
    for k, (mine, *refs) in enumerate(zip(got, auto, ref_jax)):
        mine = np.asarray(mine, np.float64)
        for ref in refs:
            ref = np.asarray(ref.detach() if torch.is_tensor(ref) else ref,
                             np.float64)
            assert mine.shape == ref.shape
            scale = max(np.abs(ref).max(), jac[k])
            assert np.abs(mine - ref).max() <= 1e-12 * scale, (k, scale)


def test_backward_wrapper_on_cpu_is_plain_and_uncounted():
    w, s, g, re = _backward_inputs((3, 9, 5), seed=5)
    args = [torch.as_tensor(a) for a in (w, s, g)]
    ret = torch.as_tensor(re)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.arakawa_rhs_backward(*args, 0.1, 0.2, ret)
    plain = cuda_kernels.arakawa_rhs_backward_plain(*args, 0.1, 0.2, ret)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert cuda_kernels.arakawa_rhs_backward(*args, 0.1, 0.2, ret,
                                             re_grad=False)[2] is None
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("re", ["float", "0-d", "members"])
def test_rhs_wrapper_differentiates_on_cpu(re):
    """On the CPU the wrapper is the twin, and autograd's gradient of it
    is the backward's plain version, for every form of re."""
    w, s, g, re_np = _backward_inputs((3, 9, 5), seed=6)
    r = {"float": 80.0, "0-d": torch.tensor(80.0, dtype=F64,
                                            requires_grad=True),
         "members": torch.as_tensor(re_np).requires_grad_()}[re]
    wt, st = (torch.tensor(a, requires_grad=True) for a in (w, s))
    gt = torch.as_tensor(g)
    out = cuda_kernels.arakawa_rhs_fused(wt, st, 0.1, 0.2, r)
    leaves = [wt, st] + ([r] if torch.is_tensor(r) else [])
    auto = torch.autograd.grad(out, leaves, gt)
    plain = cuda_kernels.arakawa_rhs_backward_plain(
        wt.detach(), st.detach(), gt, 0.1, 0.2,
        r.detach() if torch.is_tensor(r) else r)
    for a, b in zip(auto[:2], plain[:2]):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12 * float(
            b.abs().max()))
    if re == "members":
        assert torch.allclose(auto[2], plain[2], rtol=1e-12)
    elif re == "0-d":
        assert torch.allclose(auto[2], plain[2].sum(), rtol=1e-12)


# --------------------------------------------------------- what refuses

def test_graphed_loop_refuses_grad():
    """The graphed runner refuses a state that requires grad before it
    touches the device, and a step whose output requires grad (an Re that
    requires grad) at its warm-up, naming graph=False; the eager runner
    differentiates."""
    cfg = cavity.CavityConfig(nx=8, ny=8, dt=1e-3)
    state = cavity.initial_state(cfg, F64, "cpu")
    grad_state = (state[0].clone().requires_grad_(), *state[1:])
    plain_step = cavity.make_step_fn(cfg, F64, "cpu")
    with pytest.raises(ValueError, match="graph=False"):
        loop._Graphed(plain_step, grad_state, history=False)
    re = torch.tensor(100.0, dtype=F64, requires_grad=True)
    step = cavity.make_step_fn(cfg, F64, "cpu", re=re)
    with pytest.raises(ValueError, match="graph=False"):
        loop.refuse_grad(step(state), "the step's output")
    with torch.no_grad():
        loop.refuse_grad(step(state), "the step's output")
    final = loop.advance(step, state, 3, graph=False)
    assert final[1].requires_grad


def test_graphed_loop_checks_closed_over_tensors_every_run():
    """The tensors a step closes over, through nested closures, are
    checked at every graphed run: an Re that comes to require grad after
    the step was built (and could have been captured) is refused before
    any device work, naming graph=False."""
    cfg = cavity.CavityConfig(nx=8, ny=8, dt=1e-3)
    state = cavity.initial_state(cfg, F64, "cpu")
    re = torch.tensor(100.0, dtype=F64)
    step = cavity.make_step_fn(cfg, F64, "cpu", re=re)
    assert any(t is re for t in loop.closed_over(step))
    re.requires_grad_()
    with pytest.raises(ValueError, match="graph=False"):
        loop._Graphed(step, state, history=False)
    with torch.no_grad():
        loop.refuse_grad(loop.closed_over(step), "a closed-over tensor")


def test_reynolds_tensor_is_the_float_run():
    """A 0-d Re tensor that requires no grad steps the cavity as the float
    does, bit for bit (the twin divides by it in the same order)."""
    cfg = cavity.CavityConfig(nx=12, ny=12, dt=1e-3)
    state = cavity.initial_state(cfg, F64, "cpu")
    a = loop.advance(cavity.make_step_fn(cfg, F64, "cpu"), state, 5)
    b = loop.advance(cavity.make_step_fn(
        cfg, F64, "cpu", re=torch.tensor(cfg.re, dtype=F64)), state, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------- the packed step and the tiers

# the JAX package's dot precision of each packed formulation
_JAX_PRECISION = {"fused": "highest", "fused_bf16x3": "high",
                  "fused_bf16x1": "default"}


def _jax_fused_loss(state, cfg, steps):
    """1e6 mean(psi^2) + 1e-2 mean(w^2) of decode_state after `steps` JAX
    packed steps: it reads psi, w and the four wall vectors."""
    step = jax_cavity_fused.make_fused_step_fn(cfg,
                                               _JAX_PRECISION[cfg.poisson])
    for _ in range(steps):
        state = step(state)
    w, s = jax_cavity_fused.decode_state(cfg, state)
    return 1e6 * jnp.mean(s ** 2) + 1e-2 * jnp.mean(w ** 2)


def _fused_loss(state, cfg, steps, re=None):
    """The same functional through the port's packed step, eagerly."""
    step = cavity_fused.make_fused_step_fn(cfg, state[0].dtype, "cpu", re=re)
    final = loop.advance(step, state, steps, graph=False)
    w, s = cavity_fused.decode_state(cfg, final)
    return 1e6 * torch.mean(s ** 2) + 1e-2 * torch.mean(w ** 2)


def _developed_fused_state(bc_order):
    """The JAX package's 24^2 packed fp64 state after 10 steps from rest
    (walls and lid corners set; m = 23 < P = 24, n = 23 < Q = 128), and
    its config."""
    jcfg = jax_cavity.CavityConfig(nx=24, ny=24, dt=1e-3, poisson="fused",
                                   bc_order=bc_order)
    step = jax_cavity_fused.make_fused_step_fn(jcfg)
    state = jax_cavity_fused.init_state(jcfg, jnp.float64)
    for _ in range(10):
        state = step(state)
    return jcfg, state


@pytest.mark.parametrize("bc_order", [1, 2])
def test_fused_grad_wrt_reynolds(bc_order):
    """d loss / d Re through 3 packed fp64 steps (24^2, the padding on both
    axes) from a developed state, through the stage twin and the fp64
    products: against jax.grad of the JAX packed step with a traced
    cfg.re (rel 1e-9) and central FD (rtol 1e-4)."""
    jcfg, jstate = _developed_fused_state(bc_order)
    cfg = interop.cavity_config_from_jax(jcfg)
    state = interop.cavity_fused_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), F64)
    re = torch.tensor(100.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(_fused_loss(state, cfg, 3, re), re)
    ref = float(jax.grad(lambda r: _jax_fused_loss(
        jstate, dataclasses.replace(jcfg, re=r), 3))(100.0))
    assert np.isfinite(float(g)) and float(g) != 0.0
    np.testing.assert_allclose(float(g), ref, rtol=1e-9)
    h = 0.5
    with torch.no_grad():
        fd = (float(_fused_loss(state, cfg, 3, 100.0 + h))
              - float(_fused_loss(state, cfg, 3, 100.0 - h))) / (2 * h)
    np.testing.assert_allclose(float(g), fd, rtol=1e-4)


@pytest.mark.parametrize("bc_order", [1, 2])
def test_fused_grad_wrt_packed_state(bc_order):
    """The gradient of the loss after 3 packed fp64 steps with respect to
    the whole developed packed state (w, s, rl, rh, cl, ch), mapped
    through interop, against jax.grad of the nested JAX state: each part
    within 1e-9 of its scale.  w's padding and the wall vectors past the
    logical walls get exactly 0 (the step never reads them unmasked); s's
    padding gets 0 past its first row and column, and on that ring the
    value JAX gives (nonzero: the stage's Jacobian at rows m-1 and columns
    n-1 reads psi's buffer there, which the solve keeps at 0)."""
    jcfg, jstate = _developed_fused_state(bc_order)
    cfg = interop.cavity_config_from_jax(jcfg)
    state = interop.cavity_fused_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), F64)
    leaves = tuple(t.clone().requires_grad_() for t in state[:6])
    got = torch.autograd.grad(_fused_loss((*leaves, state[6]), cfg, 3),
                              leaves)
    ref = jax.grad(lambda s: _jax_fused_loss(s, jcfg, 3))(jstate)
    ref = [np.asarray(a) for a in (ref[0], ref[1], *ref[2])]
    for mine, want in zip(got, ref):
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(mine.numpy() - want).max() <= 1e-9 * scale
    m = n = 23
    gw, gs, *gwalls = got
    assert not gw[m:].any() and not gw[:, n:].any()
    assert not gs[m + 1:].any() and not gs[:, n + 1:].any()
    assert gs[m].any() and gs[:, n].any()
    for v, end in zip(gwalls, (n, n, m, m)):
        assert not v[end:].any() and v[:end].any()


# fp32 d loss / d Re of each tier after 3 steps from rest at 24^2, against
# JAX's CPU gradient of the same formulation in fp32 (JAX's CPU backend
# ignores the precision): (rtol, the measured rel. difference)
TIER_GRADS = {"matmul_bf16x3": (1e-3, 2.3e-7), "fused_bf16x3": (1e-3, 2.1e-6),
              "matmul_bf16x1": (0.5, 7.3e-3), "fused_bf16x1": (0.5, 7.3e-3)}


@pytest.mark.parametrize("tier", list(TIER_GRADS))
def test_tier_grad_wrt_reynolds(tier):
    """d(1e6 mean psi^2)/dRe through 3 fp32 steps from rest (24^2) of a
    bf16 tier, the products' backward the tier product of the cotangent
    (the twin on the CPU), against jax.grad of the JAX step in fp32.  An
    accuracy check: measured rel. differences 2.3e-7 (matmul_bf16x3),
    2.1e-6 (fused_bf16x3), 7.3e-3 (both bf16x1), beside the loss's own
    1.2e-5 and 1.3e-2; bf16x3 is held to 1e-3, bf16x1 (the tier that
    stalls, BASELINE.md:318-355) to a finite value of the same sign within
    0.5.  The tier backward's exactness is held by the Functions' tests."""
    rtol, _ = TIER_GRADS[tier]
    f32 = torch.float32

    def jax_loss(r):
        jcfg = jax_cavity.CavityConfig(nx=24, ny=24, dt=1e-3, poisson=tier,
                                       re=r)
        if tier.startswith("fused"):
            state = jax_cavity_fused.init_state(jcfg, jnp.float32)
            step = jax_cavity_fused.make_fused_step_fn(
                jcfg, _JAX_PRECISION[tier])
            for _ in range(3):
                state = step(state)
            psi = jax_cavity_fused.decode_state(jcfg, state)[1]
        else:
            w0 = jnp.zeros((25, 25), jnp.float32)
            step = jax_cavity.make_step_fn(jcfg, re=r)
            psi = jax_loop.run_steps(step, (w0, w0, jnp.zeros((), jnp.float32)),
                                     3)[1]
        return 1e6 * jnp.mean(psi ** 2)

    cfg = cavity.CavityConfig(nx=24, ny=24, dt=1e-3, poisson=tier)
    re = torch.tensor(100.0, dtype=f32, requires_grad=True)
    if tier.startswith("fused"):
        step = cavity_fused.make_fused_step_fn(cfg, f32, "cpu", re=re)
        final = loop.advance(step, cavity_fused.init_state(cfg, f32, "cpu"),
                             3, graph=False)
        psi = cavity_fused.decode_state(cfg, final)[1]
    else:
        step = cavity.make_step_fn(cfg, f32, "cpu", re=re)
        psi = loop.advance(step, cavity.initial_state(cfg, f32, "cpu"), 3,
                           graph=False)[1]
    (g,) = torch.autograd.grad(1e6 * torch.mean(psi ** 2), re)
    g = float(g)
    ref = float(jax.grad(jax_loss)(jnp.float32(100.0)))
    assert np.isfinite(g) and np.sign(g) == np.sign(ref) != 0
    np.testing.assert_allclose(g, ref, rtol=rtol)


def _constant(n, symmetric, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, n))
    return torch.as_tensor(c + c.T if symmetric else c, dtype=torch.float32)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("symmetric", [True, False],
                         ids=["symmetric", "general"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_tier_plan_backward_is_the_product_of_the_cotangent(side, symmetric,
                                                           passes):
    """torch.autograd.grad through a TierPlan is the tier product of the
    cotangent with the transposed constant, bit for bit: the plan itself
    for a symmetric constant (the sine matrices), a plan of C^T for
    another; the cotangent is never rounded to bf16."""
    c = _constant(13, symmetric, seed=3)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((13, 7) if side == "left"
                                            else (7, 13)),
                        dtype=torch.float32).requires_grad_()
    plan = cuda_kernels.TierPlan(c, passes, side, tuple(x.shape))
    assert plan.symmetric == symmetric
    out = plan(x)
    assert torch.equal(out, plan(x.detach()))
    g = torch.as_tensor(rng.standard_normal(tuple(out.shape)),
                        dtype=torch.float32)
    (got,) = torch.autograd.grad(out, x, g)
    want = cuda_kernels.TierPlan(c.T.contiguous(), passes, side,
                                 tuple(out.shape))(g)
    assert torch.equal(got, want)
    assert (plan.transposed() is plan) == symmetric
    if symmetric:
        assert torch.equal(got, plan(g))


@pytest.mark.parametrize("passes", [1, 3])
def test_tier_matmul_backward_is_the_product_of_the_cotangent(passes):
    """The gradients of tier_matmul(a, b) are tier_matmul(g, b^T) and
    tier_matmul(a^T, g), bit for bit, and only those asked for."""
    rng = np.random.default_rng(passes)
    a, b, g = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((9, 5), (5, 11), (9, 11)))
    a.requires_grad_()
    b.requires_grad_()
    ga, gb = torch.autograd.grad(cuda_kernels.tier_matmul(a, b, passes),
                                 (a, b), g)
    with torch.no_grad():
        assert torch.equal(ga, cuda_kernels.tier_matmul(
            g, b.T.contiguous(), passes))
        assert torch.equal(gb, cuda_kernels.tier_matmul(
            a.T.contiguous(), g, passes))
    (ga_only,) = torch.autograd.grad(
        cuda_kernels.tier_matmul(a, b.detach(), passes), a, g)
    assert torch.equal(ga_only, ga)


def test_tier_plan_refuses_a_constant_that_requires_grad():
    """A plan's constant is split once, at build: one that requires grad
    is refused there, and at a call under grad mode if it has come to
    require grad since; a field still differentiates."""
    c = _constant(6, True, seed=5)
    with pytest.raises(ValueError, match="takes no gradient"):
        cuda_kernels.TierPlan(c.clone().requires_grad_(), 3, "left", (6, 4))
    plan = cuda_kernels.TierPlan(c, 3, "left", (6, 4))
    x = torch.ones(6, 4)
    c.requires_grad_()
    with pytest.raises(ValueError, match="takes no gradient"):
        plan(x)
    with torch.no_grad():
        plan(x)


# the stage's plain backward: (nx, ny) with padding on both axes, none
# (P = m = 8, n = Q = 128), and the smallest interior (m = n = 2)
STAGE_BACKWARD_SHAPES = [(24, 24), (9, 129), (3, 3)]


def _stage_backward_inputs(nx, ny, seed):
    """Random fields and wall vectors on the whole buffer (the padding
    too: the adjoint must not rely on its zeros), cotangents g of the new
    interior and h of the next wall vectors."""
    rng = np.random.default_rng(seed)
    P, Q = cavity_fused.padded_extents(nx, ny)
    w, wt, s, g = (torch.as_tensor(rng.standard_normal((P, Q)))
                   for _ in range(4))
    walls, h = ([torch.as_tensor(rng.standard_normal(k)) for k in
                 (Q, Q, P, P)] for _ in range(2))
    return w, wt, s, tuple(walls), g, tuple(h)


@pytest.mark.parametrize("bc_order", [1, 2])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("nx,ny", STAGE_BACKWARD_SHAPES)
def test_stage_backward_plain_matches_autograd(nx, ny, stage, bc_order):
    """cavity_fused_stage_backward_plain (the gather the kernel computes)
    against torch.autograd.grad of the stage's twin in fp64: w, wt, s,
    the four wall vectors and a tensor Re, each within 1e-12 of its
    scale.  At stage 1 w and wt are one tensor (the step passes w twice),
    whose gradient is gwt (gw is None)."""
    w, wt, s, walls, g, h = _stage_backward_inputs(nx, ny, nx + 7 * stage)
    m, n = nx - 1, ny - 1
    dt, dx, dy, re = 1e-2, 1.0 / nx, 1.0 / ny, 77.0
    leaves = [t.clone().requires_grad_() for t in (w, wt, s, *walls)]
    re_t = torch.tensor(re, dtype=F64, requires_grad=True)
    lw = leaves[0]
    lwt = lw if stage == 1 else leaves[1]
    out, walls_out = cuda_kernels.cavity_fused_stage_plain(
        lw, lwt, leaves[2], tuple(leaves[3:]), stage, dt, dx, dy, re_t, m, n,
        bc_order)
    auto = torch.autograd.grad((out, *walls_out), leaves + [re_t], (g, *h),
                               allow_unused=True)
    gw, gwt, gs, gwalls, gre = cuda_kernels.cavity_fused_stage_backward_plain(
        lwt.detach(), s, walls, g, h, stage, dt, dx, dy, re, m, n, bc_order)
    if stage == 1:
        assert gw is None and auto[1] is None
        mine = [gwt, None]
    else:
        mine = [gw, gwt]
    for k, (a, b) in enumerate(zip(auto, mine + [gs, *gwalls, gre])):
        if b is None:
            continue
        scale = float(a.abs().max())
        assert scale > 0, k
        assert float((a - b).abs().max()) <= 1e-12 * scale, k


def test_stage_backward_wrapper_on_cpu_is_plain_and_uncounted():
    w, wt, s, walls, g, h = _stage_backward_inputs(9, 129, seed=2)
    args = (2, 1e-2, 1 / 9, 1 / 129, 80.0, 8, 128, 2)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.cavity_fused_stage_backward(wt, s, walls, g, h, *args)
    plain = cuda_kernels.cavity_fused_stage_backward_plain(wt, s, walls, g, h,
                                                           *args)
    flat = lambda r: [r[0], r[1], r[2], *r[3], r[4]]
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(plain)))
    assert cuda_kernels.cavity_fused_stage_backward(
        wt, s, walls, g, h, *args, re_grad=False)[4] is None
    assert cuda_kernels.LAUNCHES == before


def test_fused_reynolds_tensor_is_the_float_run():
    """A 0-d Re tensor that requires no grad steps the packed cavity as
    the float does, bit for bit; a step whose Re tensor was written in
    place after the build (which read it once) raises and names the
    rebuild."""
    cfg = cavity.CavityConfig(nx=12, ny=12, dt=1e-3, poisson="fused")
    state = cavity_fused.init_state(cfg, F64, "cpu")
    a = loop.advance(cavity_fused.make_fused_step_fn(cfg, F64, "cpu"),
                     state, 5)
    re = torch.tensor(cfg.re, dtype=F64)
    step = cavity_fused.make_fused_step_fn(cfg, F64, "cpu", re=re)
    b = loop.advance(step, state, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    re.fill_(50.0)
    with pytest.raises(ValueError, match="rebuild the step"):
        step(state)


def test_fused_graphed_loop_refuses_grad():
    """The graphed runner refuses a packed state that requires grad,
    naming graph=False; the eager runner differentiates through it."""
    cfg = cavity.CavityConfig(nx=8, ny=8, dt=1e-3, poisson="fused")
    step = cavity_fused.make_fused_step_fn(cfg, F64, "cpu")
    state = cavity_fused.init_state(cfg, F64, "cpu")
    grad_state = (state[0].clone().requires_grad_(), *state[1:])
    with pytest.raises(ValueError, match="graph=False"):
        loop._Graphed(step, grad_state, history=False)
    final = loop.advance(step, grad_state, 2, graph=False)
    assert final[1].requires_grad
