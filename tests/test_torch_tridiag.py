"""cfd_julia_torch tridiagonal engine, CRWENO-5, grids and stencils vs
cfd_julia_tpu, in fp64.

The same seeded numpy systems and lines go through both packages; the only
admissible difference is the order of floating-point operations, so each
result is held within 1e-12 of its scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch.core import grid
from cfd_julia_torch.ops import crweno, stencil, tridiag
from cfd_julia_tpu.core import grid as jax_grid
from cfd_julia_tpu.ops import crweno as jax_crweno
from cfd_julia_tpu.ops import stencil as jax_stencil
from cfd_julia_tpu.ops import tridiag as jax_tridiag

torch.set_num_threads(1)

REL = 1e-12
BATCH = 3


def _close(got, ref, rel=REL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _system(n, seed, batch=BATCH, cyclic=False):
    """Diagonally dominant batched rows (a[..., 0] = c[..., -1] = 0 unless
    cyclic, where they are the corner couplings)."""
    rng = np.random.default_rng(seed)
    a, b, c, d = (rng.standard_normal((batch, n)) for _ in range(4))
    b = 3.0 + np.abs(a) + np.abs(c) + np.abs(b)
    if not cyclic:
        a[:, 0] = 0.0
        c[:, -1] = 0.0
    else:
        a[:, 0] *= 0.3
        c[:, -1] *= 0.3
    return a, b, c, d


def _both(fn_t, fn_j, arrays, **kw):
    got = fn_t(*(torch.as_tensor(x) for x in arrays), **kw)
    ref = fn_j(*(jnp.asarray(x) for x in arrays), **kw)
    return got, ref


def _solvers(lib, abcd, cyc):
    """pcr, thomas, and solve_cyclic by both methods, of one package."""
    out = [lib.pcr(*abcd), lib.thomas(*abcd)]
    if cyc is not None:
        out += [lib.solve_cyclic(*cyc, method=m) for m in ("pcr", "thomas")]
    return out


# JAX's four solves of one length as one program: one compile a length
_jax_solvers = jax.jit(lambda abcd, cyc: _solvers(jax_tridiag, abcd, cyc))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32,
                               33, 63, 64, 65])
def test_solvers_match_jax(n):
    """pcr, thomas and solve_cyclic (both methods; n >= 3) on batched
    systems of lengths from 1 to 65, on both sides of each power of two,
    where PCR's rounds change."""
    abcd = _system(n, seed=n)
    cyc = _system(n, seed=1000 + n, cyclic=True) if n >= 3 else None
    got = _solvers(tridiag, [torch.as_tensor(x) for x in abcd],
                   cyc and [torch.as_tensor(x) for x in cyc])
    ref = _jax_solvers([jnp.asarray(x) for x in abcd],
                       cyc and [jnp.asarray(x) for x in cyc])
    assert len(got) == len(ref) == (4 if cyc else 2)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("method", ["pcr", "thomas"])
def test_solve_broadcasts_one_matrix_over_rhs(method):
    """One set of rows against four right-hand sides (the heat solvers'
    layout), and the residual of the dense system."""
    a, b, c, _ = (x[0] for x in _system(33, seed=5))
    d = np.random.default_rng(6).standard_normal((4, 33))
    got, ref = _both(tridiag.solve, jax_tridiag.solve, (a, b, c, d),
                     method=method)
    _close(got, ref)
    m = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    np.testing.assert_allclose(got.numpy() @ m.T, d, atol=1e-12)


def test_solve_cyclic_leaves_inputs_alone():
    """The corner edits go to copies: a captured step never overwrites its
    state."""
    arrays = [torch.as_tensor(x) for x in _system(16, seed=9, cyclic=True)]
    before = [x.clone() for x in arrays]
    tridiag.solve_cyclic(*arrays)
    assert all(torch.equal(x, y) for x, y in zip(arrays, before))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="tridiagonal method"):
        tridiag.solve(*(torch.ones(4) for _ in range(4)), method="lu")


def _line(shape, seed):
    """A smooth periodic wave with 5% noise: CRWENO's rows stay diagonally
    dominant (on uniform noise they need not be, and Thomas without
    pivoting then amplifies the two packages' roundoff)."""
    rng = np.random.default_rng(seed)
    x = np.arange(shape[-1]) / shape[-1]
    phase = rng.uniform(0.0, 2 * np.pi, shape[:-1] + (1,))
    return np.sin(2 * np.pi * x + phase) + 0.05 * rng.standard_normal(shape)


@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("direction", ["L", "R"])
@pytest.mark.parametrize("shape", [(16,), (65,), (3, 40)], ids=str)
def test_crweno_periodic_matches_jax(shape, direction, method):
    u = _line(shape, seed=shape[-1])
    got = crweno.reconstruct_periodic(torch.as_tensor(u), direction,
                                      method=method)
    ref = jax_crweno.reconstruct_periodic(jnp.asarray(u), direction,
                                          method=method)
    _close(got, ref)


@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("shape", [(17,), (66,), (3, 41)], ids=str)
def test_crweno_dirichlet_matches_jax(shape, side, method):
    u = _line(shape, seed=7 * shape[-1])
    name = f"reconstruct_dirichlet_{side}"
    got = getattr(crweno, name)(torch.as_tensor(u), method=method)
    ref = getattr(jax_crweno, name)(jnp.asarray(u), method=method)
    _close(got, ref)


@pytest.mark.parametrize("name", ["crwc_L", "crwc_R"])
def test_crweno_coefficients_match_jax(name):
    vs = [_line((32,), seed) for seed in range(5)]
    got = getattr(crweno, name)(*(torch.as_tensor(v) for v in vs))
    ref = getattr(jax_crweno, name)(*(jnp.asarray(v) for v in vs))
    for g, r in zip(got, ref):
        _close(g, r)


def test_stencils_match_jax():
    u1 = _line((33,), seed=1)
    u2 = _line((17, 12), seed=2)
    t1, t2 = torch.as_tensor(u1), torch.as_tensor(u2)
    j1, j2 = jnp.asarray(u1), jnp.asarray(u2)
    for k in (-2, -1, 1, 3):
        _close(stencil.shift(t1, k), jax_stencil.shift(j1, k))
        _close(stencil.shift(t2, k, 0), jax_stencil.shift(j2, k, 0))
    _close(stencil.laplacian_1d(t1, 0.1), jax_stencil.laplacian_1d(j1, 0.1))
    _close(stencil.laplacian_2d(t2, 0.1, 0.2),
           jax_stencil.laplacian_2d(j2, 0.1, 0.2))
    _close(stencil.laplacian_periodic(t2, 0.1, 0.2),
           jax_stencil.laplacian_periodic(j2, 0.1, 0.2))
    _close(stencil.central_diff_1d_periodic(t1, 0.1),
           jax_stencil.central_diff_1d_periodic(j1, 0.1))


def test_grids_match_jax():
    g1, j1 = grid.Grid1D(nx=40, x0=-1.0), jax_grid.Grid1D(nx=40, x0=-1.0)
    assert g1.dx == j1.dx
    _close(g1.nodes(torch.float64), j1.nodes(jnp.float64))
    _close(g1.centers(torch.float64), j1.centers(jnp.float64))
    g2 = grid.Grid2D(nx=16, ny=8, y1=2.0)
    j2 = jax_grid.Grid2D(nx=16, ny=8, y1=2.0)
    assert (g2.dx, g2.dy) == (j2.dx, j2.dy)
    for g, r in zip(g2.mesh(torch.float64), j2.mesh(jnp.float64)):
        _close(g, r)
    for g, r in zip(g2.periodic_nodes(torch.float64),
                    j2.periodic_nodes(jnp.float64)):
        _close(g, r)
    assert g2.coarsen() == grid.Grid2D(nx=8, ny=4, y1=2.0)
    with pytest.raises(ValueError, match="coarsenable"):
        grid.Grid2D(nx=3, ny=4).coarsen()
