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
the scale; the graphed loop, the bf16 tiers and the packed step refuse
what they cannot differentiate.
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


@pytest.mark.parametrize("poisson", ["matmul_bf16x3", "matmul_bf16x1"])
def test_tiers_refuse_grad(poisson):
    cfg = cavity.CavityConfig(nx=8, ny=8, dt=1e-3, poisson=poisson)
    re = torch.tensor(100.0, requires_grad=True)
    w, s, rms = cavity.initial_state(cfg, torch.float32, "cpu")
    re_step = cavity.make_step_fn(cfg, torch.float32, "cpu", re=re)
    with pytest.raises(ValueError, match="no backward"):
        re_step((w, s, rms))
    step = cavity.make_step_fn(cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no backward"):
        step((w.requires_grad_(), s, rms))
    with torch.no_grad():
        step((w, s, rms))


@pytest.mark.parametrize("poisson", ["fused", "fused_bf16x3"])
def test_fused_refuses_grad(poisson):
    dtype = torch.float32
    cfg = cavity.CavityConfig(nx=8, ny=8, dt=1e-3, poisson=poisson)
    with pytest.raises(ValueError):
        cavity.make_step_fn(cfg, dtype, "cpu",
                            re=torch.tensor(100.0, requires_grad=True))
    step = cavity_fused.make_fused_step_fn(cfg, dtype, "cpu")
    state = cavity_fused.init_state(cfg, dtype, "cpu")
    grad_state = (state[0].clone().requires_grad_(), *state[1:])
    with pytest.raises(ValueError, match="no backward"):
        step(grad_state)
    with torch.no_grad():
        step(grad_state)


def test_reynolds_tensor_is_the_float_run():
    """A 0-d Re tensor that requires no grad steps the cavity as the float
    does, bit for bit (the twin divides by it in the same order)."""
    cfg = cavity.CavityConfig(nx=12, ny=12, dt=1e-3)
    state = cavity.initial_state(cfg, F64, "cpu")
    a = loop.advance(cavity.make_step_fn(cfg, F64, "cpu"), state, 5)
    b = loop.advance(cavity.make_step_fn(
        cfg, F64, "cpu", re=torch.tensor(cfg.re, dtype=F64)), state, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
