"""Explicit SSP-RK3 (Shu–Osher) stage combination (counterpart of
cfd_julia_tpu/stepping/ssprk3.py):

    u1 = u  + dt * L(u)
    u2 = 3/4 u + 1/4 u1 + 1/4 dt * L(u1)
    u  = 1/3 u + 2/3 u2 + 2/3 dt * L(u2)

(e.g. 02_Heat_Equation_RK3/rk3.jl:32-47, 09_Euler_1D_Roe/euler_roe.jl:53-71).
The state is a tensor or a tuple of tensors, where JAX takes a pytree;
each stage combine runs eagerly, one elementwise kernel per operation,
in the JAX package's operation order.
"""
from __future__ import annotations


def _map(fn, *states):
    """fn over matching leaves of tensors or tuples of tensors."""
    if isinstance(states[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*states))
    return fn(*states)


def ssprk3_step(rhs, u, dt):
    """One SSP-RK3 step.  `rhs(u) -> du/dt` maps a state to a matching
    state."""
    u1 = _map(lambda x, r: x + dt * r, u, rhs(u))
    u2 = _map(lambda x, x1, r: 0.75 * x + 0.25 * x1 + 0.25 * dt * r,
              u, u1, rhs(u1))
    return _map(lambda x, x2, r: (x + 2.0 * x2 + 2.0 * dt * r) / 3.0,
                u, u2, rhs(u2))


def ssprk3_step_with_post(rhs, post, u, dt):
    """SSP-RK3 with a per-stage post-processor (e.g. boundary-condition
    enforcement after each stage, as the cavity applies its wall
    vorticity — lid_driven_cavity.jl:78-107)."""
    u1 = post(_map(lambda x, r: x + dt * r, u, rhs(u)))
    u2 = post(_map(lambda x, x1, r: 0.75 * x + 0.25 * x1 + 0.25 * dt * r,
                   u, u1, rhs(u1)))
    return post(_map(lambda x, x2, r: (x + 2.0 * x2 + 2.0 * dt * r) / 3.0,
                     u, u2, rhs(u2)))
