"""Precision and device policy: fp32 by default, fp64 for the parity tests.

Counterpart of cfd_julia_tpu/core/precision.py.  There is no global x64
switch in PyTorch: callers pass a dtype, and `default_dtype()` is what the
entry points use when they are given none.  The fp32 tier is full fp32,
including the Poisson solve's matrix products; TF32 is not enabled here
(torch.backends.cuda.matmul.allow_tf32 keeps its default, False).
"""
from __future__ import annotations

import torch


def default_dtype() -> torch.dtype:
    return torch.float32


def resolve_device(name) -> torch.device:
    """torch.device for `name`; a CUDA device without a usable GPU raises
    instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return device
