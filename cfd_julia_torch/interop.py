"""Carry configs and fields between cfd_julia_tpu and this package.

Both packages compute from the same numpy arrays, so a parity test hands
one array to each.  This module imports neither JAX nor cfd_julia_tpu: a
JAX config is read through its attributes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.models import cavity, euler1d, poisson2d, vortex
from cfd_julia_torch.ops import spectral
from cfd_julia_torch.poisson import multigrid

# JAX CavityConfig.poisson / .rhs_impl -> the port's; the other JAX variants
# (*_bf16x*, fused*, fst_mxu, ...) are not ported
_POISSON = {"auto": "auto", "matmul": "matmul", "fst": "fst",
            "fst_half": "fst_half"}
_RHS_IMPL = {"auto": "auto", "xla": "torch", "pallas": "kernel"}
# JAX MGConfig.smoother -> the port's (smoother, impl): the JAX smoother
# implementations "pallas" / "xla" are the port's kernels / plain twins
_MG_SMOOTHER = {"auto": ("auto", "auto"), "cheb": ("cheb", "auto"),
                "pallas": ("auto", "kernel"), "xla": ("auto", "torch")}
_POISSON_SOLVERS = ("fft", "fft_spectral", "fst", "jacobi", "redblack", "cg",
                    "multigrid", "mgcg")


def cavity_config_from_jax(cfg) -> cavity.CavityConfig:
    """The port's CavityConfig for a cfd_julia_tpu CavityConfig."""
    if cfg.poisson not in _POISSON:
        raise ValueError(f"poisson={cfg.poisson!r} is not ported; the port "
                         f"has {sorted(_POISSON)}")
    if cfg.rhs_impl not in _RHS_IMPL:
        raise ValueError(f"rhs_impl={cfg.rhs_impl!r} is not ported; the "
                         f"port maps {sorted(_RHS_IMPL)}")
    return cavity.CavityConfig(
        nx=cfg.nx, ny=cfg.ny, dt=cfg.dt, t_final=cfg.t_final, re=cfg.re,
        bc_order=cfg.bc_order, poisson=_POISSON[cfg.poisson],
        rhs_impl=_RHS_IMPL[cfg.rhs_impl])


def euler_config_from_jax(cfg) -> euler1d.EulerConfig:
    """The port's EulerConfig for a cfd_julia_tpu EulerConfig; its state
    is a plain (3, nx) field (field_from_numpy)."""
    if cfg.rhs_impl not in _RHS_IMPL:
        raise ValueError(f"rhs_impl={cfg.rhs_impl!r} is not ported; the "
                         f"port maps {sorted(_RHS_IMPL)}")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(euler1d.EulerConfig)}
    fields["rhs_impl"] = _RHS_IMPL[cfg.rhs_impl]
    return euler1d.EulerConfig(**fields)


def mg_config_from_jax(cfg) -> multigrid.MGConfig:
    """The port's MGConfig for a cfd_julia_tpu MGConfig."""
    if cfg.smoother not in _MG_SMOOTHER:
        raise ValueError(f"smoother={cfg.smoother!r} is not ported; the port "
                         f"maps {sorted(_MG_SMOOTHER)}")
    if cfg.cycle_dtype not in ("fp32", "mixed"):
        raise ValueError(f"cycle_dtype={cfg.cycle_dtype!r} is not ported; "
                         "the port has fp32 and mixed")
    if cfg.transfers not in ("auto", "conv", "matmul", "reshape"):
        raise ValueError(f"transfers={cfg.transfers!r} is not ported")
    smoother, impl = _MG_SMOOTHER[cfg.smoother]
    return multigrid.MGConfig(
        n_levels=cfg.n_levels, v1=cfg.v1, v2=cfg.v2, v3=cfg.v3, tol=cfg.tol,
        max_cycles=cfg.max_cycles, transfers=cfg.transfers, fused=cfg.fused,
        smoother=smoother, fmg=cfg.fmg, cycle_dtype=cfg.cycle_dtype,
        impl=impl)


def poisson_config_from_jax(cfg) -> poisson2d.PoissonConfig:
    """The port's PoissonConfig for a cfd_julia_tpu PoissonConfig."""
    if cfg.solver not in _POISSON_SOLVERS:
        raise ValueError(f"solver={cfg.solver!r} is not ported; the port "
                         f"has {list(_POISSON_SOLVERS)}")
    return poisson2d.PoissonConfig(
        nx=cfg.nx, ny=cfg.ny, solver=cfg.solver, problem=cfg.problem,
        tol=cfg.tol, max_iter=cfg.max_iter, freq=cfg.freq,
        mg=mg_config_from_jax(cfg.mg))


def vortex_config_from_jax(cfg) -> vortex.VortexConfig:
    """The port's VortexConfig for a cfd_julia_tpu VortexConfig.  The port
    has one transform path (torch.fft with irfft2), which both JAX
    pair_impl values and fft_impl auto / xla map to; the MXU matmul FFT is
    a TPU formulation and is not ported."""
    if cfg.rhs_impl not in _RHS_IMPL:
        raise ValueError(f"rhs_impl={cfg.rhs_impl!r} is not ported; the "
                         f"port maps {sorted(_RHS_IMPL)}")
    if cfg.fft_impl not in ("auto", "xla"):
        raise ValueError(f"fft_impl={cfg.fft_impl!r} is not ported; the "
                         "port's transforms are torch.fft")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(vortex.VortexConfig)}
    fields["rhs_impl"] = _RHS_IMPL[cfg.rhs_impl]
    return vortex.VortexConfig(**fields)


def field_from_numpy(a, dtype=None, device="cpu"):
    """A contiguous tensor of `dtype` on `device` from a numpy field; a
    complex array (a spectrum) takes the complex type of `dtype`'s
    precision."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    if np.iscomplexobj(a) and not dtype.is_complex:
        dtype = spectral.complex_for(dtype)
    # a copy: arrays from JAX are read-only
    return torch.as_tensor(np.array(a), dtype=dtype,
                           device=device).contiguous()


def state_from_numpy(w, s, dtype=None, device="cpu"):
    """Cavity state (w, s, rms=0) from numpy fields."""
    wt = field_from_numpy(w, dtype, device)
    return (wt, field_from_numpy(s, dtype, device),
            torch.zeros((), dtype=wt.dtype, device=wt.device))


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()
