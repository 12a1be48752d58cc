"""cfd_julia_torch Arakawa RHS and its CUDA kernel wrapper vs cfd_julia_tpu.

The same seeded numpy fields go through the JAX functions (the XLA form
and the Pallas kernel in interpret mode) and the port, in fp64, where the
only admissible difference is the order of floating-point operations.
The CUDA kernel itself is held against its plain twin on a GPU in
tests/test_torch_cuda.py.
"""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.ops import _cuda_build, arakawa, cuda_kernels
from cfd_julia_tpu.ops import arakawa as jax_arakawa
from cfd_julia_tpu.ops import pallas_kernels

torch.set_num_threads(1)

RE = 100.0


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _spacing(shape):
    return 1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1)


def _assert_rel(got, ref, rel):
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("fn", ["vorticity_rhs", "jacobian", "laplacian"])
@pytest.mark.parametrize("shape", [(16, 16), (24, 40), (33, 17)])
def test_matches_jax_xla(fn, shape):
    w, s = _fields(shape)
    dx, dy = _spacing(shape)
    args = {"vorticity_rhs": lambda m, a, b: m.vorticity_rhs(a, b, dx, dy, RE),
            "jacobian": lambda m, a, b: m.jacobian(a, b, dx, dy),
            "laplacian": lambda m, a, b: m.laplacian(a, dx, dy)}[fn]
    ref = np.asarray(args(jax_arakawa, jnp.asarray(w), jnp.asarray(s)))
    wt, st, _ = interop.state_from_numpy(w, s, torch.float64, "cpu")
    got = interop.to_numpy(args(arakawa, wt, st))
    _assert_rel(got, ref, 1e-12)


@pytest.mark.parametrize("shape", [(16, 16), (24, 40)])
def test_matches_pallas_kernel_interpret(shape):
    """One call of the TPU kernel in interpret mode vs the port's
    wrapper, which takes its plain twin for CPU tensors."""
    w, s = _fields(shape, seed=1)
    dx, dy = _spacing(shape)
    ref = np.asarray(pallas_kernels.arakawa_rhs_fused(
        jnp.asarray(w), jnp.asarray(s), dx, dy, RE, tile=8, interpret=True))
    wt, st, _ = interop.state_from_numpy(w, s, torch.float64, "cpu")
    got = interop.to_numpy(cuda_kernels.arakawa_rhs_fused(wt, st, dx, dy, RE))
    _assert_rel(got, ref, 1e-12)


def test_discrete_invariants():
    """Arakawa's Jacobian conserves energy, enstrophy and circulation
    exactly on a periodic grid: sum J = sum w J = sum s J = 0."""
    w, s = _fields((32, 32), seed=2)
    wt, st, _ = interop.state_from_numpy(w, s, torch.float64, "cpu")
    j = arakawa.jacobian(wt, st, 0.1, 0.1)
    scale = float(j.abs().sum())
    for weight in (torch.ones_like(wt), wt, st):
        assert abs(float((weight * j).sum())) < 1e-12 * scale


def test_wrapper_cpu_is_plain_and_uncounted():
    w, s = _fields((12, 9), seed=3)
    wt, st, _ = interop.state_from_numpy(w, s, torch.float64, "cpu")
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.arakawa_rhs_fused(wt, st, 0.1, 0.2, RE)
    plain = cuda_kernels.arakawa_rhs_fused_plain(wt, st, 0.1, 0.2, RE)
    assert torch.equal(got, plain)
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError), ("int64", TypeError), ("mixed_dtype", TypeError),
    ("1d", ValueError), ("shape_mismatch", ValueError),
    ("two_rows", ValueError), ("meta_device", ValueError),
])
def test_wrapper_rejects(case, exc):
    a = torch.zeros(8, 8, dtype=torch.float64)
    w, s = {
        "float16": (a.half(), a.half()),
        "int64": (a.long(), a.long()),
        "mixed_dtype": (a, a.float()),
        "1d": (a[0], a[0]),
        "shape_mismatch": (a, a[:7]),
        "two_rows": (a[:2], a[:2]),
        "meta_device": (a.to("meta"), a.to("meta")),
    }[case]
    with pytest.raises(exc):
        cuda_kernels.arakawa_rhs_fused(w, s, 0.1, 0.1, RE)


def _fake_nvcc(tmp_path, body):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return tmp_path / "cuda"


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build()


def test_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, 'echo "arakawa_rhs.cu(1): error: boom" >&2\n'
                                "exit 2\n")
    monkeypatch.setattr(_cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError, match="(?s)exit code 2.*error: boom"):
        _cuda_build.build()
    assert not any((tmp_path / "build").rglob("*.so"))


def test_build_flags_and_disk_cache(tmp_path, monkeypatch):
    """nvcc compiles every csrc/*.cu with the sm_90a flags into its own
    object, all started together, then links one library; a second build
    with unchanged sources reuses the library on disk."""
    log = tmp_path / "calls.log"
    home = _fake_nvcc(
        tmp_path,
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n')
    monkeypatch.setattr(_cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(home))
    first = _cuda_build.build()
    second = _cuda_build.build()
    assert first == second and first.exists()
    assert first.parent.parent == tmp_path / "build"
    assert (first.parent / _cuda_build.LOG_NAME).exists()
    calls = [c.split() for c in log.read_text().splitlines()]
    cu = sorted(str(p) for p in _cuda_build.CSRC.glob("*.cu"))
    assert len(cu) >= 2 and len(calls) == len(cu) + 1
    # the compiles run at once and log in the order they happen to start:
    # put them in source order, the order the link takes their objects in
    compiles, link = sorted(calls[:-1], key=lambda c: c[-1]), calls[-1]
    assert [c[-1] for c in compiles] == cu
    for argv in compiles:
        assert "arch=compute_90a,code=sm_90a" in argv and "-c" in argv
        assert argv[argv.index("-o") + 1].endswith(".o")
    assert "-shared" in link
    objs = [c[c.index("-o") + 1] for c in compiles]
    # the objects in source order, then the link flags: a library (cuFFT)
    # after the objects that use it, which a linker with --as-needed keeps
    flags = list(_cuda_build.LINK_FLAGS)
    assert "-lcufft" in flags
    assert link[-len(flags) - len(objs):-len(flags)] == objs
    assert link[-len(flags):] == flags
    assert os.path.basename(link[link.index("-o") + 1]).startswith(".")
    assert not any((tmp_path / "build").rglob("*.o"))

