"""cfd_julia_torch multigrid building blocks and kernel twins vs cfd_julia_tpu.

The same seeded numpy fields go through the JAX functions (the XLA forms,
and the Pallas kernels in interpret mode) and the port, in fp64, where the
only admissible difference is the order of floating-point operations
(rel 1e-12 for fields, 1e-10 for the residual sum of squares).  bf16 calls
are held to one bf16 ulp of the field scale.  On the CPU each kernel
wrapper takes its plain twin; the CUDA kernels themselves are held
against their twins on a GPU in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.ops import cuda_kernels
from cfd_julia_torch.poisson import iterative, multigrid
from cfd_julia_tpu.ops import pallas_kernels
from cfd_julia_tpu.poisson import iterative as jax_iterative
from cfd_julia_tpu.poisson import multigrid as jax_multigrid

torch.set_num_threads(1)

# one bf16 ulp at the field scale, as tests/test_pallas.py:213-217
BF16_REL = 8e-3


def _fields(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


def _coarse(shape):
    return ((shape[0] - 1) // 2 + 1, (shape[1] - 1) // 2 + 1)


def _spacing(shape):
    return 1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1)


def _t(a, dtype=torch.float64):
    return interop.field_from_numpy(a, dtype)


def _assert_rel(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ------------------------------------------------ transfers and sweeps

@pytest.mark.parametrize("form", ["conv", "matmul", "reshape"])
@pytest.mark.parametrize("shape", [(17, 17), (33, 17), (65, 129)])
def test_restriction_matches_jax(form, shape):
    """Every form on an interior-masked residual (the only MG input)."""
    (r,) = _fields(shape, seed=1, n=1)
    r[0, :] = r[-1, :] = r[:, 0] = r[:, -1] = 0.0
    jfn = {"conv": jax_multigrid.restriction,
           "matmul": jax_multigrid.restriction_matmul,
           "reshape": jax_multigrid.restriction_reshape}[form]
    tfn = multigrid._TRANSFERS[form][0]
    _assert_rel(tfn(_t(r)).numpy(), jfn(jnp.asarray(r)), 1e-12)


@pytest.mark.parametrize("form", ["conv", "matmul", "reshape"])
@pytest.mark.parametrize("shape", [(9, 9), (17, 9)])
def test_prolongation_matches_jax(form, shape):
    (uc,) = _fields(shape, seed=2, n=1)
    tfn = multigrid._TRANSFERS[form][1]
    ref = jax_multigrid.prolongation(jnp.asarray(uc))
    _assert_rel(tfn(_t(uc)).numpy(), ref, 1e-12)


def test_residual_and_sweeps_match_jax():
    """residual_full, redblack_sweep, jacobi_sweep and chebyshev_smooth on
    a non-square grid."""
    shape = (33, 17)
    nx, ny = shape[0] - 1, shape[1] - 1
    dx, dy = 1.0 / nx, 1.0 / ny
    u, f = _fields(shape, seed=3)
    ju, jf = jnp.asarray(u), jnp.asarray(f)
    tu, tf = _t(u), _t(f)
    jm = jax_iterative.interior_mask(nx, ny, ju.dtype)
    tm = iterative.interior_mask(nx, ny, tu.dtype)
    jr, jb = jax_iterative.color_masks(nx, ny, ju.dtype)
    tr, tb = iterative.color_masks(nx, ny, tu.dtype)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    pairs = [
        (iterative.residual_full(tf, tu, dx, dy, tm),
         jax_iterative.residual_full(jf, ju, dx, dy, jm)),
        (iterative.redblack_sweep(tu, tf, dx, dy, tr, tb),
         jax_iterative.redblack_sweep(ju, jf, dx, dy, jr, jb)),
        (iterative.jacobi_sweep(tu, tf, dx, dy, tm),
         jax_iterative.jacobi_sweep(ju, jf, dx, dy, jm)),
        (iterative.chebyshev_smooth(tu, tf, dx, dy, 3, tm),
         jax_iterative.chebyshev_smooth(ju, jf, dx, dy, 3, jm)),
    ]
    for got, ref in pairs:
        _assert_rel(got.numpy(), ref, 1e-12)


# ------------------------------- each kernel's twin vs the Pallas kernel

@pytest.mark.parametrize("shape,tile,iters", [
    ((33, 33), 16, 1), ((65, 65), 64, 2), ((65, 65), 64, 4),
    ((65, 65), 64, 5), ((33, 65), 16, 3), ((65, 65), 64, 0)])
def test_redblack_sweeps_matches_pallas(shape, tile, iters):
    u, f = _fields(shape, seed=4)
    dx, dy = _spacing(shape)
    ref = pallas_kernels.redblack_sweeps_fused(
        jnp.asarray(u), jnp.asarray(f), dx, dy, iters, tile=tile,
        interpret=True)
    got = cuda_kernels.redblack_sweeps_fused(_t(u), _t(f), dx, dy, iters)
    _assert_rel(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("shape,tile", [((65, 65), 8), ((33, 65), 16),
                                        ((129, 129), 64)])
def test_residual_restrict_matches_pallas(shape, tile):
    u, f = _fields(shape, seed=5)
    dx, dy = _spacing(shape)
    ref = pallas_kernels.residual_restrict_fused(
        jnp.asarray(u), jnp.asarray(f), dx, dy, tile=tile, interpret=True)
    got = cuda_kernels.residual_restrict_fused(_t(u), _t(f), dx, dy)
    _assert_rel(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("shape,tile,sweeps", [((65, 65), 8, 1),
                                               ((129, 65), 16, 2),
                                               ((129, 129), 64, 3),
                                               ((33, 65), 16, 0)])
def test_smooth_residual_restrict_matches_pallas(shape, tile, sweeps):
    u, f = _fields(shape, seed=6)
    dx, dy = _spacing(shape)
    ref_u, ref_fc = pallas_kernels.smooth_residual_restrict_fused(
        jnp.asarray(u), jnp.asarray(f), dx, dy, sweeps, tile=tile,
        interpret=True)
    got_u, got_fc = cuda_kernels.smooth_residual_restrict_fused(
        _t(u), _t(f), dx, dy, sweeps)
    _assert_rel(got_u.numpy(), ref_u, 1e-12)
    _assert_rel(got_fc.numpy(), ref_fc, 1e-12)


@pytest.mark.parametrize("shape,tile,sweeps", [((65, 65), 16, 0),
                                               ((65, 65), 16, 2),
                                               ((129, 65), 64, 3),
                                               ((129, 129), 32, 4)])
def test_prolong_correct_smooth_matches_pallas(shape, tile, sweeps):
    u, f = _fields(shape, seed=7)
    (uc,) = _fields(_coarse(shape), seed=8, n=1)
    dx, dy = _spacing(shape)
    ref = pallas_kernels.prolong_correct_smooth_fused(
        jnp.asarray(u), jnp.asarray(f), jnp.asarray(uc), dx, dy, sweeps,
        tile=tile, interpret=True)
    got = cuda_kernels.prolong_correct_smooth_fused(_t(u), _t(f), _t(uc),
                                                    dx, dy, sweeps)
    _assert_rel(got.numpy(), ref, 1e-12)


@pytest.mark.parametrize("shape", [(129, 65), (33, 65)])
def test_prolong_want_rms_matches_pallas(shape):
    """The residual sum of squares of the returned u (the V-cycle's
    convergence check): fp64, rel 1e-10 (summation order)."""
    u, f = _fields(shape, seed=9)
    (uc,) = _fields(_coarse(shape), seed=10, n=1)
    dx, dy = _spacing(shape)
    ref_u, ref_ssq = pallas_kernels.prolong_correct_smooth_fused(
        jnp.asarray(u), jnp.asarray(f), jnp.asarray(uc), dx, dy, 2, tile=16,
        interpret=True, want_rms=True)
    got_u, got_ssq = cuda_kernels.prolong_correct_smooth_fused(
        _t(u), _t(f), _t(uc), dx, dy, 2, want_rms=True)
    _assert_rel(got_u.numpy(), ref_u, 1e-12)
    assert got_ssq.dtype == torch.float64 and got_ssq.dim() == 0
    np.testing.assert_allclose(float(got_ssq), float(ref_ssq), rtol=1e-10)


@pytest.mark.parametrize("kernel", ["rb", "descend", "restrict", "ascend"])
def test_bf16_twins_match_pallas_bf16(kernel):
    """bf16 in, bf16 out, fp32 compute with one rounding at the store:
    within one bf16 ulp (8e-3 of the field scale) of the JAX bf16 kernel
    in interpret mode; bf16 elementwise rounding differs between the two
    frameworks, so the comparison is not elementwise-exact."""
    shape = (65, 65)
    dx = dy = 1.0 / 64
    u, f = _fields(shape, seed=11)
    (uc,) = _fields(_coarse(shape), seed=12, n=1)
    ju, jf, juc = (jnp.asarray(a, jnp.bfloat16) for a in (u, f, uc))
    # the same bf16-exact values on both sides
    tu, tf, tuc = (torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (ju, jf, juc))

    def close(got, ref):
        assert got.dtype == torch.bfloat16
        _assert_rel(got.float().numpy(), np.asarray(ref, np.float32),
                    BF16_REL)

    if kernel == "rb":
        close(cuda_kernels.redblack_sweeps_fused(tu, tf, dx, dy, 2),
              pallas_kernels.redblack_sweeps_fused(ju, jf, dx, dy, 2, tile=8,
                                                   interpret=True))
    elif kernel == "descend":
        got = cuda_kernels.smooth_residual_restrict_fused(tu, tf, dx, dy, 2)
        ref = pallas_kernels.smooth_residual_restrict_fused(
            ju, jf, dx, dy, 2, tile=8, interpret=True)
        close(got[0], ref[0])
        close(got[1], ref[1])
    elif kernel == "restrict":
        close(cuda_kernels.residual_restrict_fused(tu, tf, dx, dy),
              pallas_kernels.residual_restrict_fused(ju, jf, dx, dy, tile=8,
                                                     interpret=True))
    else:
        close(cuda_kernels.prolong_correct_smooth_fused(tu, tf, tuc, dx, dy,
                                                        2),
              pallas_kernels.prolong_correct_smooth_fused(
                  ju, jf, juc, dx, dy, 2, tile=16, interpret=True))


def test_bf16_twin_rounds_once():
    """The bf16 twin equals the fp32 computation rounded once at the end
    (the `_c32` contract), not a computation in bf16."""
    shape = (33, 33)
    dx = dy = 1.0 / 32
    u, f = (_t(a, torch.float32).to(torch.bfloat16)
            for a in _fields(shape, seed=13))
    got = cuda_kernels.redblack_sweeps_fused(u, f, dx, dy, 3)
    ref = cuda_kernels.redblack_sweeps_fused(u.float(), f.float(), dx, dy,
                                             3).to(torch.bfloat16)
    assert torch.equal(got, ref)


# ----------------------------------------------------- wrapper contracts

def _cpu_calls():
    u, f = (_t(a) for a in _fields((17, 9), seed=14))
    uc = _t(_fields((9, 5), seed=15, n=1)[0])
    dx, dy = 1.0 / 16, 1.0 / 8
    return {
        "redblack_sweeps": (
            lambda: cuda_kernels.redblack_sweeps_fused(u, f, dx, dy, 2),
            lambda: cuda_kernels.redblack_sweeps_fused_plain(u, f, dx, dy,
                                                             2)),
        "smooth_residual_restrict": (
            lambda: cuda_kernels.smooth_residual_restrict_fused(u, f, dx, dy,
                                                                2),
            lambda: cuda_kernels.smooth_residual_restrict_fused_plain(
                u, f, dx, dy, 2)),
        "residual_restrict": (
            lambda: cuda_kernels.residual_restrict_fused(u, f, dx, dy),
            lambda: cuda_kernels.residual_restrict_fused_plain(u, f, dx, dy)),
        "prolong_correct_smooth": (
            lambda: cuda_kernels.prolong_correct_smooth_fused(
                u, f, uc, dx, dy, 2, want_rms=True),
            lambda: cuda_kernels.prolong_correct_smooth_fused_plain(
                u, f, uc, dx, dy, 2, want_rms=True)),
    }


@pytest.mark.parametrize("name", ["redblack_sweeps",
                                  "smooth_residual_restrict",
                                  "residual_restrict",
                                  "prolong_correct_smooth"])
def test_wrapper_cpu_is_plain_and_uncounted(name):
    wrapped, plain = _cpu_calls()[name]
    before = dict(cuda_kernels.LAUNCHES)
    got, ref = wrapped(), plain()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError), ("int64", TypeError), ("mixed_dtype", TypeError),
    ("coarse_dtype", TypeError), ("1d", ValueError),
    ("shape_mismatch", ValueError), ("even_rows", ValueError),
    ("two_rows", ValueError), ("coarse_shape", ValueError),
    ("negative_sweeps", ValueError), ("meta_device", ValueError),
])
def test_wrapper_rejects(case, exc):
    a = torch.zeros(9, 9, dtype=torch.float64)
    c = torch.zeros(5, 5, dtype=torch.float64)
    u, f, uc, sweeps = {
        "float16": (a.half(), a.half(), c.half(), 1),
        "int64": (a.long(), a.long(), c.long(), 1),
        "mixed_dtype": (a, a.float(), c, 1),
        "coarse_dtype": (a, a, c.float(), 1),
        "1d": (a[0], a[0], c, 1),
        "shape_mismatch": (a, a[:7], c, 1),
        "even_rows": (a[:8], a[:8], c, 1),
        "two_rows": (a[:2], a[:2], c, 1),
        "coarse_shape": (a, a, c[:4], 1),
        "negative_sweeps": (a, a, c, -1),
        "meta_device": (a.to("meta"), a.to("meta"), c.to("meta"), 1),
    }[case]
    with pytest.raises(exc):
        cuda_kernels.prolong_correct_smooth_fused(u, f, uc, 0.1, 0.1, sweeps)
    if case not in ("coarse_dtype", "coarse_shape"):
        with pytest.raises(exc):
            cuda_kernels.smooth_residual_restrict_fused(u, f, 0.1, 0.1,
                                                        sweeps)


def test_redblack_wrapper_takes_any_extent():
    """The smoother, like the TPU kernel, takes even extents too."""
    u, f = (_t(a) for a in _fields((10, 12), seed=16))
    got = cuda_kernels.redblack_sweeps_fused(u, f, 0.1, 0.1, 1)
    mr, mb = iterative.color_masks(9, 11, u.dtype)
    ref = iterative.redblack_sweep(u, f, 0.1, 0.1, mr, mb)
    _assert_rel(got.numpy(), ref.numpy(), 1e-15)

