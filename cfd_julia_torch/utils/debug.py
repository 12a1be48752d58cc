"""Numerical-safety utilities (counterpart of cfd_julia_tpu/utils/debug.py).

* `nan_guard()` context: the counterpart of `jax_debug_nans`; the first
  torch call or hand-written kernel whose floating output holds a NaN
  raises FloatingPointError naming it.
* `check_finite(tree, where)`: an all-finite check of every tensor in
  nested tuples, lists and dicts, for checkpoint boundaries; raises naming
  the first offending leaf by the path text of `jax.tree_util.keystr`.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode, resolve_name

from cfd_julia_torch.ops import cuda_kernels

# calls that allocate and compute nothing: an uninitialised buffer may hold
# NaN bits, and a NaN fill is a sentinel (the iterative solves' histories)
_ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided",
                          "new_empty", "new_empty_strided", "full",
                          "full_like", "new_full"})


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


class _NanMode(TorchFunctionMode):
    """Checks the floating output of every torch call for NaNs, except
    allocations and views (a view holds values another call made)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = resolve_name(func) or getattr(func, "__name__", repr(func))
        if name.rsplit(".", 1)[-1] in _ALLOCATIONS:
            return out
        for t in _tensors(out):
            if (t.is_floating_point() or t.is_complex()) and \
                    not t._is_view() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {name}")
        return out


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """While active, raise FloatingPointError at the first torch call whose
    floating (or complex) output holds a NaN, naming the call, and at the
    first hand-written kernel whose output does, naming the kernel
    (ops/cuda_kernels.py checks each launch's outputs); allocations and
    views are not checked.

    Each check reads a flag from the device, a sync, and a CUDA graph
    capture forbids syncs: so under the guard stepping/loop runs its steps
    eagerly and the multigrid solve its V-cycles, as jax_debug_nans runs
    op by op.  Outside the guard the kernels' check costs one flag test on
    the host and nothing in a replayed graph."""
    if not enable:
        yield
        return
    prev = cuda_kernels.CHECK_NAN
    cuda_kernels.CHECK_NAN = True
    try:
        with _NanMode():
            yield
    finally:
        cuda_kernels.CHECK_NAN = prev


def _leaves_with_path(tree, path=""):
    """(path, leaf) in jax.tree_util's order and keystr text: tuple and
    list items as [i], dict entries by sorted key as ['k']; None is an
    empty subtree."""
    if tree is None:
        return
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def check_finite(tree, where: str = "state"):
    """Raise FloatingPointError naming the first non-finite leaf."""
    for path, leaf in _leaves_with_path(tree):
        t = torch.as_tensor(leaf)
        if (t.is_floating_point() or t.is_complex()) and \
                not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {where}{path}")
    return tree
