"""Ensemble (data-parallel) simulation: a batch of fdm vortex runs, one
Reynolds number a member (counterpart of cfd_julia_tpu/models/ensemble.py).

The JAX package vmaps the solver over the viscous coefficient.  Here the
batch is a leading axis written out: the state is w (B, nx, ny), the
periodic Poisson solve transforms the last two axes of every member at
once, and each SSP-RK3 stage is one launch of the Arakawa kernel
(csrc/arakawa_rhs.cu) for the whole batch, which reads each member's Re
from a (B,) device tensor.  That tensor is built once, before the loop
captures a CUDA graph, because a graph holds its address.

Gradients: pass the Reynolds numbers as a tensor that requires grad; with
grad mode on the run is eager (a CUDA graph records no autograd graph),
and torch.autograd takes each member's d/d re through the kernel's
backward (arakawa_rhs_backward).
"""
from __future__ import annotations

import dataclasses

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.models import vortex
from cfd_julia_torch.stepping import loop, ssprk3


@dataclasses.dataclass
class EnsembleResult:
    res: torch.Tensor     # Reynolds numbers (B,)
    w: torch.Tensor       # final vorticity (B, nx, ny)


def _reynolds(reynolds, dtype, device):
    res = torch.as_tensor(reynolds, dtype=dtype, device=device)
    if res.dim() != 1 or res.shape[0] < 1:
        raise ValueError(f"reynolds must be a non-empty 1-D sequence, got "
                         f"shape {tuple(res.shape)}")
    return res.contiguous()


def make_sweep_step(cfg: vortex.VortexConfig, res, dtype=None,
                    device="cuda"):
    """(step, w0): the batched SSP-RK3 fdm step, one Re a member from the
    (B,) tensor `res` on `device` (built before any capture: the step
    reads it from there), and the initial vorticity broadcast to
    (B, nx, ny)."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    if cfg.solver != "fdm":
        raise ValueError(f"vortex_fdm_re_sweep runs the fdm solver, got "
                         f"solver={cfg.solver!r}")
    w0 = vortex.initial_vorticity(cfg, dtype, device)
    w0_b = w0.expand(res.shape[0], *w0.shape).contiguous()
    rhs = vortex.make_fdm_rhs(cfg, dtype, device, re=res)

    def step(w):
        return ssprk3.ssprk3_step(rhs, w, cfg.dt)

    return step, w0_b


def vortex_fdm_re_sweep(cfg: vortex.VortexConfig, reynolds, dtype=None,
                        device="cuda", graph: bool = True) -> EnsembleResult:
    """Run the fdm vortex solver of `cfg` (cfg.nt steps from its initial
    vorticity) for a batch of Reynolds numbers in one batched run.

    reynolds: a sequence of floats, or a (B,) tensor (moved to `device`
    and `dtype`; differentiable).  graph: run through the graphed loop
    (stepping/loop.py) on a CUDA device; the run is eager instead when
    grad mode is on and the Reynolds tensor requires grad."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    res = _reynolds(reynolds, dtype, device)
    step, w0 = make_sweep_step(cfg, res, dtype, device)
    graph = graph and not (torch.is_grad_enabled() and res.requires_grad)
    return EnsembleResult(res=res,
                          w=loop.advance(step, w0, cfg.nt, graph=graph))
