"""Pointwise Riemann fluxes for the 1D Euler system — Roe, HLLC, Rusanov
(counterpart of cfd_julia_tpu/ops/riemann.py; same names and arithmetic).

Vectorized over interface arrays: the reference's per-interface scalar
loops (roe: 09_Euler_1D_Roe/euler_roe.jl:107-167, hllc:
10_Euler_1D_HLLC/euler_hllc.jl:105-152, rusanov + wavespeeds:
11_Euler_1D_Rusanov/euler_rusanov.jl:107-168) become branchless
elementwise arithmetic (`torch.where` chains) over all interfaces at once.

State layout: component-major (3, n_interfaces) conservative variables
(rho, rho u, rho E).  Every flux takes left/right interface states qL/qR
and their fluxes fL/fR and returns the interface flux (3, n_interfaces).
"""
from __future__ import annotations

import torch


def primitives(q, gamma: float):
    """(rho, u, e=E, p, H) from conservative (3, n) state."""
    rho = q[0]
    u = q[1] / rho
    e = q[2] / rho
    p = (gamma - 1.0) * (q[2] - 0.5 * q[1] * u)
    h = e + p / rho
    return rho, u, e, p, h


def flux(q, gamma: float):
    """Euler flux F(q), component-major (Common.jl:634-641)."""
    rho, u, _, p, _ = primitives(q, gamma)
    return torch.stack([q[1], q[1] * u + p, (q[2] + p) * u])


def _roe_average(qL, qR, gamma: float):
    rhoL, uL, _, _, hL = primitives(qL, gamma)
    rhoR, uR, _, _, hR = primitives(qR, gamma)
    sL = torch.sqrt(torch.abs(rhoL))
    sR = torch.sqrt(torch.abs(rhoR))
    alpha = 1.0 / (sL + sR)
    uu = (sL * uL + sR * uR) * alpha
    hh = (sL * hL + sR * hR) * alpha
    aa = torch.sqrt(torch.abs((gamma - 1.0) * (hh - 0.5 * uu**2)))
    return uu, hh, aa


def roe(qL, qR, fL, fR, gamma: float):
    """Roe's approximate Riemann solver with full eigen-decomposition
    (euler_roe.jl:107-167)."""
    gm = gamma - 1.0
    uu, hh, aa = _roe_average(qL, qR, gamma)

    D11 = torch.abs(uu)
    D22 = torch.abs(uu + aa)
    D33 = torch.abs(uu - aa)

    beta = 0.5 / aa**2
    phi2 = 0.5 * gm * uu**2

    V = 0.5 * (qR - qL)
    # left eigenvector rows applied to V
    dd1 = D11 * (
        (1.0 - phi2 / aa**2) * V[0] + (gm * uu / aa**2) * V[1] - (gm / aa**2) * V[2]
    )
    dd2 = D22 * ((phi2 - uu * aa) * V[0] + (aa - gm * uu) * V[1] + gm * V[2])
    dd3 = D33 * ((phi2 + uu * aa) * V[0] + (-aa - gm * uu) * V[1] + gm * V[2])

    # right eigenvector columns
    dF = torch.stack(
        [
            dd1 + beta * dd2 + beta * dd3,
            uu * dd1 + beta * (uu + aa) * dd2 + beta * (uu - aa) * dd3,
            (phi2 / gm) * dd1
            + beta * (hh + uu * aa) * dd2
            + beta * (hh - uu * aa) * dd3,
        ]
    )
    return 0.5 * (fR + fL) - dF


def hllc(qL, qR, fL, fR, gamma: float):
    """HLLC solver: SL/SR estimates, contact speed SP, compound pressure
    PLR, 4-branch flux select (euler_hllc.jl:105-152)."""
    rhoL, uL, _, pL, _ = primitives(qL, gamma)
    rhoR, uR, _, pR, _ = primitives(qR, gamma)
    aL = torch.sqrt(torch.abs(gamma * pL / rhoL))
    aR = torch.sqrt(torch.abs(gamma * pR / rhoR))

    SL = torch.minimum(uL, uR) - torch.maximum(aL, aR)
    SR = torch.maximum(uL, uR) + torch.maximum(aL, aR)
    SP = (
        pR - pL + rhoL * uL * (SL - uL) - rhoR * uR * (SR - uR)
    ) / (rhoL * (SL - uL) - rhoR * (SR - uR))
    PLR = 0.5 * (
        pL + pR + rhoL * (SL - uL) * (SP - uL) + rhoR * (SR - uR) * (SP - uR)
    )

    Ds = torch.stack([torch.zeros_like(SP), torch.ones_like(SP), SP])
    f_starL = (SP * (SL * qL - fL) + SL * PLR * Ds) / (SL - SP)
    f_starR = (SP * (SR * qR - fR) + SR * PLR * Ds) / (SR - SP)

    return torch.where(
        SL >= 0.0,
        fL,
        torch.where(SR <= 0.0, fR, torch.where(SP >= 0.0, f_starL, f_starR)),
    )


def rusanov_wavespeed2(q, gamma: float):
    """The reference's alternative propagation speed `wavespeed2`
    (euler_rusanov.jl:122-139): spectral radius |u| + a at the CELL
    centres of q (max(|u|, |u±a|) = |u|+a), interface speed = max of the
    two adjacent cells, end interfaces copied from their neighbours.
    q: (3, n) cells -> ps: (n+1,) interfaces."""
    rho, u, _, p, _ = primitives(q, gamma)
    rad = torch.abs(u) + torch.sqrt(torch.abs(gamma * p / rho))
    inner = torch.maximum(rad[:-1], rad[1:])           # interfaces 1..n-1
    return torch.cat([inner[:1], inner, inner[-1:]])


def rusanov(qL, qR, fL, fR, gamma: float, wavespeed: str = "roe",
            ps=None):
    """Rusanov (local Lax-Friedrichs) flux.

    wavespeed="roe": ps = |u_roe + a_roe| (euler_rusanov.jl:166).  For the
    reference's `wavespeed2`, pass ps=rusanov_wavespeed2(q_cells, gamma):
    that speed lives on CELL-centred states, which the interface states
    alone cannot reproduce.  A bare wavespeed="spectral" (no ps) takes
    max(|u|+a) of the two reconstructed interface states — a valid Rusanov
    bound, not wavespeed2 near shocks."""
    if ps is None:
        if wavespeed == "roe":
            uu, _, aa = _roe_average(qL, qR, gamma)
            ps = torch.abs(aa + uu)
        elif wavespeed == "spectral":
            rhoL, uL, _, pL, _ = primitives(qL, gamma)
            rhoR, uR, _, pR, _ = primitives(qR, gamma)
            radL = torch.abs(uL) + torch.sqrt(torch.abs(gamma * pL / rhoL))
            radR = torch.abs(uR) + torch.sqrt(torch.abs(gamma * pR / rhoR))
            ps = torch.maximum(radL, radR)
        else:
            raise ValueError(f"unknown wavespeed {wavespeed!r}")
    return 0.5 * (fR + fL) - 0.5 * ps * (qR - qL)
