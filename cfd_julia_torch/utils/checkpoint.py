"""Checkpoint / resume (counterpart of cfd_julia_tpu/utils/checkpoint.py).

A solver state is a tensor or a (nested) tuple or list of tensors; it
saves to one .npz and restores exactly, and the solvers are pure step
functions, so a resume is "load the state, keep stepping".  The file
layout is the JAX package's: leaves `leaf_0`, `leaf_1`, ... in flattening
order, the structure as `__treedef__` (the same text JAX writes for
tuples and lists of arrays) and the absolute step count as `__step__`.  So
a state of the same layout written by either package loads in the other:
the cavity's (w, s, rms history) and the fdm vortex's (w, snapshots).  The
JAX spectral vortex solvers checkpoint a packed real state (`pack_c`,
which the port does not have); `load_state` refuses it on its shape and
dtype check.

`save_sharded` / `load_sharded` are the multi-device pair (the JAX
package's orbax one): torch.distributed.checkpoint, in which every rank
writes its own shards of a sharded field (a DTensor: parallel/sharded
.as_dtensor) with no gather, and a restore goes into the caller's mesh,
which may differ from the saver's.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to a path without it: normalise, so that
    save_state, exists and load_state agree on one name."""
    return path if path.endswith(".npz") else path + ".npz"


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _spec(tree) -> str:
    """The tree's structure as JAX prints it: * a leaf, (..) a tuple,
    [..] a list."""
    if isinstance(tree, tuple):
        inner = ", ".join(_spec(t) for t in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_spec(t) for t in tree) + "]"
    return "*"


def _unflatten(like, leaves):
    """`like`'s structure filled with the iterator `leaves`."""
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(item, leaves) for item in like)
    return next(leaves)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def save_state(path: str, state, step: int | None = None) -> None:
    """Save the tensors of `state` to `path` (.npz), with the step count.

    Atomic: the file is written under a temporary name in the same
    directory and os.replace()d over the target, so a crash during a save
    never destroys the previous checkpoint."""
    payload = {f"leaf_{i}": t.detach().cpu().resolve_conj().numpy()
               for i, t in enumerate(_leaves(state))}
    payload["__treedef__"] = np.asarray(f"PyTreeDef({_spec(state)})")
    if step is not None:
        payload["__step__"] = np.asarray(step)
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def exists(path: str) -> bool:
    """True if a save_state checkpoint exists at (the normalised) path."""
    return os.path.exists(_npz_path(path))


def load_state(path: str, like):
    """Restore a state saved by save_state into `like`'s structure, each
    leaf on its `like` leaf's device.  Returns (state, step); step is None
    if none was recorded.

    Every leaf must have its `like` leaf's dtype and shape, else this
    raises with the leaf's index and what the file holds; a `like` leaf
    with a leading axis of length 0 stands for a history of any length
    (its trailing shape is checked)."""
    path = _npz_path(path)
    like_leaves = _leaves(like)
    with np.load(path, allow_pickle=False) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(like_leaves):
            raise ValueError(f"checkpoint {path} holds {n} leaves, the "
                             f"state {len(like_leaves)}")
        leaves = []
        for i, ref in enumerate(like_leaves):
            a = data[f"leaf_{i}"]
            want = _numpy_dtype(ref.dtype)
            shape_ok = a.shape == tuple(ref.shape) or (
                ref.dim() > 0 and ref.shape[0] == 0 and a.ndim == ref.dim()
                and a.shape[1:] == tuple(ref.shape[1:]))
            if a.dtype != want or not shape_ok:
                raise ValueError(
                    f"checkpoint {path}: leaf {i} is {a.dtype} of shape "
                    f"{a.shape}, the state wants {want} of shape "
                    f"{tuple(ref.shape)}")
            leaves.append(torch.from_numpy(a).to(ref.device))
        step = int(data["__step__"]) if "__step__" in data.files else None
    return _unflatten(like, iter(leaves)), step


# the file torch.distributed.checkpoint writes beside the shards
_DCP_METADATA = ".metadata"


def save_sharded(path: str, state) -> None:
    """Save a state of DTensors (sharded: every rank writes its own
    shards, no host gather) and plain tensors (replicated: one copy is
    written) with torch.distributed.checkpoint, called on every rank of
    the default process group.  `path` is a checkpoint DIRECTORY; an
    existing one is overwritten."""
    import torch.distributed.checkpoint as dcp

    dcp.save({f"leaf_{i}": t for i, t in enumerate(_leaves(state))},
             storage_writer=dcp.FileSystemWriter(os.path.abspath(path),
                                                 overwrite=True))


def load_sharded(path: str, like):
    """Restore a save_sharded checkpoint into `like`'s structure, dtypes,
    shapes and shardings, on every rank: a DTensor leaf restores into its
    own mesh and placements (which may differ from the saver's, as orbax
    restores into a template's shardings), each rank reading only its
    shards; a plain tensor leaf whole on its device.  A directory in
    another format is refused."""
    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, _DCP_METADATA)):
        raise ValueError(
            f"{path} is not a save_sharded checkpoint: that format is a "
            f"torch.distributed.checkpoint directory, with a {_DCP_METADATA} "
            "file beside the ranks' shard files")
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    def blank(t):
        if isinstance(t, DTensor):
            return DTensor.from_local(torch.empty_like(t.to_local()),
                                      t.device_mesh, t.placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        return torch.empty_like(t)

    leaves = {f"leaf_{i}": blank(t) for i, t in enumerate(_leaves(like))}
    dcp.load(leaves, checkpoint_id=path)
    return _unflatten(like, iter(leaves.values()))
