"""Carry configs and fields between cfd_julia_tpu and this package.

Both packages compute from the same numpy arrays, so a parity test hands
one array to each.  This module imports neither JAX nor cfd_julia_tpu: a
JAX config is read through its attributes.
"""
from __future__ import annotations

import numpy as np
import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.models import cavity

# JAX CavityConfig.poisson / .rhs_impl -> the port's; the other JAX variants
# (fst, fst_half, *_bf16x*, fused*, fst_mxu, ...) are not ported yet
_POISSON = {"auto": "auto", "matmul": "matmul"}
_RHS_IMPL = {"auto": "auto", "xla": "torch", "pallas": "kernel"}


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


def state_from_numpy(w, s, dtype=None, device="cpu"):
    """Cavity state (w, s, rms=0) from numpy fields."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    wt = torch.as_tensor(np.asarray(w), dtype=dtype, device=device)
    st = torch.as_tensor(np.asarray(s), dtype=dtype, device=device)
    return (wt.contiguous(), st.contiguous(),
            torch.zeros((), dtype=dtype, device=device))


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()
