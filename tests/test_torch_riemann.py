"""cfd_julia_torch Riemann fluxes vs cfd_julia_tpu, in fp64.

The same seeded numpy interface states go through both packages (rtol
1e-12; only the order of floating-point operations differs).  The HLLC
states reach all four branches of its flux select: supersonic flow to the
right (SL >= 0) and to the left (SR <= 0), and subsonic flow on either
side of the contact (SP >= 0, SP < 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_julia_torch import interop
from cfd_julia_torch.ops import riemann
from cfd_julia_tpu.ops import riemann as jax_riemann

torch.set_num_threads(1)

GAMMA = 1.4
RTOL = 1e-12


def _cons(rho, u, p):
    return np.stack([rho, rho * u, p / (GAMMA - 1) + 0.5 * rho * u**2])


def _states(n=48, seed=0):
    """(qL, qR) of n interfaces: random subsonic states plus a quarter
    supersonic to the right and a quarter to the left."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.1, 2.0, (2, n))
    p = rng.uniform(0.1, 2.0, (2, n))
    u = rng.uniform(-0.5, 0.5, (2, n))
    q = n // 4
    u[:, :q] = rng.uniform(4.0, 6.0, (2, q))          # SL >= 0
    u[:, q:2 * q] = rng.uniform(-6.0, -4.0, (2, q))   # SR <= 0
    return _cons(rho[0], u[0], p[0]), _cons(rho[1], u[1], p[1])


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(ref),
                               rtol=rtol, atol=1e-13)


def _both(qL, qR):
    tL, tR = torch.tensor(qL), torch.tensor(qR)
    jL, jR = jnp.asarray(qL), jnp.asarray(qR)
    return (tL, tR, riemann.flux(tL, GAMMA), riemann.flux(tR, GAMMA)), \
           (jL, jR, jax_riemann.flux(jL, GAMMA), jax_riemann.flux(jR, GAMMA))


def test_primitives_and_flux_match_jax():
    qL, _ = _states()
    for got, ref in zip(riemann.primitives(torch.tensor(qL), GAMMA),
                        jax_riemann.primitives(jnp.asarray(qL), GAMMA)):
        _close(got, ref)
    _close(riemann.flux(torch.tensor(qL), GAMMA),
           jax_riemann.flux(jnp.asarray(qL), GAMMA))


def test_hllc_states_reach_every_branch():
    qL, qR = _states()
    rhoL, uL, _, pL, _ = riemann.primitives(torch.tensor(qL), GAMMA)
    rhoR, uR, _, pR, _ = riemann.primitives(torch.tensor(qR), GAMMA)
    aL, aR = torch.sqrt(GAMMA * pL / rhoL), torch.sqrt(GAMMA * pR / rhoR)
    SL = torch.minimum(uL, uR) - torch.maximum(aL, aR)
    SR = torch.maximum(uL, uR) + torch.maximum(aL, aR)
    SP = (pR - pL + rhoL * uL * (SL - uL) - rhoR * uR * (SR - uR)) / (
        rhoL * (SL - uL) - rhoR * (SR - uR))
    sub = (SL < 0) & (SR > 0)
    assert bool((SL >= 0).any()) and bool((SR <= 0).any())
    assert bool((sub & (SP >= 0)).any()) and bool((sub & (SP < 0)).any())


@pytest.mark.parametrize("solver", ["roe", "hllc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flux_matches_jax(solver, seed):
    mine, ref = _both(*_states(seed=seed))
    _close(getattr(riemann, solver)(*mine, GAMMA),
           getattr(jax_riemann, solver)(*ref, GAMMA))


@pytest.mark.parametrize("wavespeed", ["roe", "spectral"])
def test_rusanov_matches_jax(wavespeed):
    mine, ref = _both(*_states(seed=3))
    _close(riemann.rusanov(*mine, GAMMA, wavespeed=wavespeed),
           jax_riemann.rusanov(*ref, GAMMA, wavespeed=wavespeed))


def test_rusanov_explicit_ps_matches_jax():
    mine, ref = _both(*_states(seed=4))
    ps = np.random.default_rng(9).uniform(0.5, 3.0, mine[0].shape[1])
    _close(riemann.rusanov(*mine, GAMMA, ps=torch.tensor(ps)),
           jax_riemann.rusanov(*ref, GAMMA, ps=jnp.asarray(ps)))


def test_rusanov_unknown_wavespeed_raises():
    mine, _ = _both(*_states())
    with pytest.raises(ValueError, match="wavespeed"):
        riemann.rusanov(*mine, GAMMA, wavespeed="bogus")


@pytest.mark.parametrize("n", [3, 16, 64])
def test_wavespeed2_matches_jax(n):
    q, _ = _states(n=n, seed=n)
    _close(riemann.rusanov_wavespeed2(torch.tensor(q), GAMMA),
           jax_riemann.rusanov_wavespeed2(jnp.asarray(q), GAMMA))


def test_rusanov_wavespeed2_reference_parity():
    """rusanov_wavespeed2 vs a literal port of the reference's wavespeed2
    (euler_rusanov.jl:122-139): cell-centred spectral radius,
    neighbour-max interfaces, copied ends (tests/test_euler1d.py)."""
    rng = np.random.default_rng(5)
    nx, gamma = 64, 1.4
    rho = rng.uniform(0.1, 2.0, nx)
    u = rng.uniform(-1.5, 1.5, nx)
    p = rng.uniform(0.1, 2.0, nx)
    q = np.stack([rho, rho * u, p / (gamma - 1) + 0.5 * rho * u**2])

    rad = np.empty(nx)
    for i in range(nx):
        a = np.sqrt(gamma * ((gamma - 1.0) *
                             (q[2, i] - 0.5 * q[1, i]**2 / q[0, i]))
                    / q[0, i])
        rad[i] = max(abs(q[1, i] / q[0, i]),
                     abs(q[1, i] / q[0, i] + a),
                     abs(q[1, i] / q[0, i] - a))
    ps = np.empty(nx + 1)
    ps[1:nx] = np.maximum(rad[:-1], rad[1:])
    ps[0] = ps[1]
    ps[nx] = ps[nx - 1]

    mine = riemann.rusanov_wavespeed2(torch.tensor(q), gamma)
    np.testing.assert_allclose(interop.to_numpy(mine), ps, rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("solver", ["roe", "hllc", "rusanov"])
def test_consistency_equal_states_give_euler_flux(solver):
    """F(q, q) = F(q) for every solver (the consistency of a flux)."""
    q, _ = _states(seed=8)
    t = torch.tensor(q)
    f = riemann.flux(t, GAMMA)
    _close(getattr(riemann, solver)(t, t, f, f, GAMMA), interop.to_numpy(f))
