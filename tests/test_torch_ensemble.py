"""cfd_julia_torch's Reynolds ensemble (models/ensemble.py) vs cfd_julia_tpu.

The port writes the JAX package's vmap out as a leading batch axis: the
fdm state is w (B, nx, ny), and each RK stage is one call of the Arakawa
RHS for the whole batch with one Re a member.  In fp64 on the CPU:
- the sweep against the JAX package's vortex_fdm_re_sweep on
  tests/test_capabilities.py's case (32^2 TGV n=2, t=0.5, Re 10 and 100),
  within 1e-11 of max|w| (two programs of 50 steps, roundoff apart);
- each member against the port's own single-member vortex.solve, 1e-12;
- the batched twin (and kernel wrapper) against one 2-D call a member,
  bitwise: the batch changes no arithmetic.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.models import ensemble, vortex
from cfd_julia_torch.ops import arakawa, cuda_kernels
from cfd_julia_tpu.models import ensemble as jax_ensemble
from cfd_julia_tpu.models import vortex as jax_vortex

torch.set_num_threads(1)

RES = (10.0, 100.0)


def _jax_cfg(**kw):
    base = dict(nx=32, ny=32, solver="fdm", dt=0.01, t_final=0.5, ic="tgv",
                tgv_n=2)
    return jax_vortex.VortexConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def sweep():
    cfg = interop.vortex_config_from_jax(_jax_cfg())
    return cfg, ensemble.vortex_fdm_re_sweep(cfg, RES, torch.float64, "cpu")


def test_sweep_matches_jax(sweep):
    cfg, res = sweep
    ref = jax_ensemble.vortex_fdm_re_sweep(_jax_cfg(), list(RES),
                                           jnp.float64)
    ref_w = np.asarray(ref.w)
    assert res.w.shape == (2, 32, 32) and res.w.dtype == torch.float64
    assert res.res.tolist() == list(RES)
    err = np.abs(res.w.numpy() - ref_w).max()
    assert err <= 1e-11 * np.abs(ref_w).max(), err


@pytest.mark.parametrize("k", range(len(RES)))
def test_member_matches_single_solve(sweep, k):
    cfg, res = sweep
    single = vortex.solve(dataclasses.replace(cfg, re=RES[k]),
                          torch.float64, "cpu")
    err = float((res.w[k] - single.w).abs().max())
    assert err <= 1e-12 * float(single.w.abs().max()), err


@pytest.mark.parametrize("fn", ["twin", "wrapper"])
def test_batched_rhs_is_bitwise_per_member(fn):
    """(3, 9, 5) fields with three Re through one call, against three 2-D
    calls with a float Re each."""
    rng = np.random.default_rng(41)
    w, s = (torch.as_tensor(rng.standard_normal((3, 9, 5)))
            for _ in range(2))
    re = torch.tensor([10.0, 100.0, 1000.0], dtype=torch.float64)
    rhs = {"twin": arakawa.vorticity_rhs,
           "wrapper": cuda_kernels.arakawa_rhs_fused}[fn]
    got = rhs(w, s, 0.3, 0.2, re)
    for k in range(3):
        assert torch.equal(got[k], rhs(w[k], s[k], 0.3, 0.2, float(re[k])))


@pytest.mark.parametrize("case", ["too_many", "adds_an_axis", "integer",
                                  "other_device"])
def test_rhs_rejects_an_re_that_does_not_fit(case):
    """re must broadcast to the fields' batch shape, as a float tensor on
    their device: the kernel reads one value a member."""
    w = torch.zeros((3, 9, 5), dtype=torch.float64)
    fields, re = {
        "too_many": (w, torch.ones(4, dtype=torch.float64)),
        "adds_an_axis": (w[0], torch.ones(1, dtype=torch.float64)),
        "integer": (w, torch.ones(3, dtype=torch.int64)),
        "other_device": (w, torch.ones(3, dtype=torch.float64,
                                       device="meta")),
    }[case]
    with pytest.raises(ValueError, match="re"):
        cuda_kernels.arakawa_rhs_fused(fields, fields, 0.1, 0.1, re)


def test_sweep_rejects_other_solvers_and_bad_reynolds():
    cfg = vortex.VortexConfig(nx=16, ny=16, solver="ps23", t_final=0.01)
    with pytest.raises(ValueError, match="fdm"):
        ensemble.vortex_fdm_re_sweep(cfg, [10.0], torch.float64, "cpu")
    cfg = dataclasses.replace(cfg, solver="fdm")
    with pytest.raises(ValueError, match="1-D"):
        ensemble.vortex_fdm_re_sweep(cfg, 10.0, torch.float64, "cpu")
