"""CRWENO-5 compact reconstruction (counterpart of
cfd_julia_tpu/ops/crweno.py).

The interface values solve a tridiagonal system whose coefficients
(a1, a2, a3 | b1, b2, b3) are nonlinear functions of the local smoothness
(`crwcL` / `crwcR`, Common.jl:344-393).  The reference assembles the system
row by row and solves it with serial Thomas or cyclic Thomas
(06_Inviscid_Burgers_CRWENO/crweno_dirichlet.jl:79-152,
crweno_periodic.jl:101-192); here the coefficients are whole-line
arithmetic and the solve is batched PCR (ops.tridiag), cyclic through
Sherman-Morrison for periodic lines.

Output convention as ops.weno: periodic, L[j] at x_{j+1/2} centred u_j and
R[j] at x_{j-1/2} centred u_j (n nodes -> n values each); dirichlet, N+1
nodes -> N values at x_{j+1/2}, L centred u_j and R centred u_{j+1}, with
the reference's one-sided compact closures in the end rows.
"""
from __future__ import annotations

import torch

from cfd_julia_torch.ops import tridiag
from cfd_julia_torch.ops.weno import EPS_WENO, _smoothness, _stencils


def crwc_L(v1, v2, v3, v4, v5, eps: float = EPS_WENO):
    """Upwind CRWENO coefficients (Common.jl:344-366): (a1, a2, a3, b1, b2,
    b3), the tridiagonal row and the right-hand side's stencil weights."""
    s1, s2, s3 = _smoothness(v1, v2, v3, v4, v5)
    c1 = 0.2 / (eps + s1) ** 2
    c2 = 0.5 / (eps + s2) ** 2
    c3 = 0.3 / (eps + s3) ** 2
    t = c1 + c2 + c3
    w1, w2, w3 = c1 / t, c2 / t, c3 / t
    a1 = (2 * w1 + w2) / 3.0
    a2 = (w1 + 2 * w2 + 2 * w3) / 3.0
    a3 = w3 / 3.0
    b1 = w1 / 6.0
    b2 = (5 * w1 + 5 * w2 + w3) / 6.0
    b3 = (w2 + 5 * w3) / 6.0
    return a1, a2, a3, b1, b2, b3


def crwc_R(v1, v2, v3, v4, v5, eps: float = EPS_WENO):
    """Downwind CRWENO coefficients (Common.jl:371-393)."""
    s1, s2, s3 = _smoothness(v1, v2, v3, v4, v5)
    c1 = 0.3 / (eps + s1) ** 2
    c2 = 0.5 / (eps + s2) ** 2
    c3 = 0.2 / (eps + s3) ** 2
    t = c1 + c2 + c3
    w1, w2, w3 = c1 / t, c2 / t, c3 / t
    a1 = w1 / 3.0
    a2 = (w3 + 2 * w2 + 2 * w1) / 3.0
    a3 = (2 * w3 + w2) / 3.0
    b1 = (w2 + 5 * w1) / 6.0
    b2 = (5 * w3 + 5 * w2 + w1) / 6.0
    b3 = w3 / 6.0
    return a1, a2, a3, b1, b2, b3


def reconstruct_periodic(u, direction: str, eps: float = EPS_WENO,
                         method: str = "pcr"):
    """Cyclic CRWENO reconstruction; u: (..., n) periodic nodes."""
    n = u.shape[-1]
    up = torch.cat([u[..., -2:], u, u[..., :2]], dim=-1)
    wc = crwc_L if direction == "L" else crwc_R
    a1, a2, a3, b1, b2, b3 = wc(*_stencils(up, n), eps)
    d = b1 * up[..., 1:n + 1] + b2 * u + b3 * up[..., 3:n + 3]
    return tridiag.solve_cyclic(a1, a2, a3, d, method=method)


def _close_ends(a1, a2, a3, d, u):
    """The reference's one-sided compact rows i = 1 and i = n
    (crweno_dirichlet.jl:79-152), on copies."""
    ends = tridiag._with
    a1 = ends(ends(a1, 0, 0.0), -1, 1.0 / 3.0)
    a2 = ends(ends(a2, 0, 2.0 / 3.0), -1, 2.0 / 3.0)
    a3 = ends(ends(a3, 0, 1.0 / 3.0), -1, 0.0)
    d = ends(d, 0, (u[..., 0] + 5 * u[..., 1]) / 6.0)
    d = ends(d, -1, (5 * u[..., -2] + u[..., -1]) / 6.0)
    return a1, a2, a3, d


def reconstruct_dirichlet_L(u, eps: float = EPS_WENO, method: str = "pcr"):
    """Upwind compact reconstruction on N+1 Dirichlet nodes -> N interface
    values at x_{j+1/2} centred u_j (crweno_dirichlet.jl:79-112)."""
    n_out = u.shape[-1] - 1
    g_l = 2 * u[..., :1] - u[..., 1:2]      # ghost u_{-1} for row j = 1
    up = torch.cat([g_l, g_l, u, u[..., -1:]], dim=-1)
    a1, a2, a3, b1, b2, b3 = crwc_L(*_stencils(up, n_out), eps)
    d = b1 * up[..., 1:n_out + 1] + b2 * u[..., :n_out] + b3 * u[..., 1:]
    return tridiag.solve(*_close_ends(a1, a2, a3, d, u), method=method)


def reconstruct_dirichlet_R(u, eps: float = EPS_WENO, method: str = "pcr"):
    """Downwind compact reconstruction -> N values at x_{j+1/2} centred
    u_{j+1} (crweno_dirichlet.jl:119-152)."""
    n_out = u.shape[-1] - 1
    g_r = 2 * u[..., -1:] - u[..., -2:-1]   # ghost u_{N+1} for row n-2
    # output m is centred u_{m+1}: it reads u_{m-1}..u_{m+3}
    up = torch.cat([u[..., :1], u, g_r, g_r], dim=-1)
    a1, a2, a3, b1, b2, b3 = crwc_R(*_stencils(up, n_out), eps)
    d = b1 * u[..., :n_out] + b2 * u[..., 1:] + b3 * up[..., 3:n_out + 3]
    return tridiag.solve(*_close_ends(a1, a2, a3, d, u), method=method)
