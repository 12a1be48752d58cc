"""WENO-5 reconstruction over whole lines (counterpart of
cfd_julia_tpu/ops/weno.py; same names, closures and output convention).

A reconstruction is one padded line + five shifted slices + elementwise
arithmetic, batched over leading axes (e.g. the three Euler components).

Boundary closures:
* ``periodic``    wrap-around stencils              (Common.jl wenoL/wenoR)
* ``extrapolate`` linear-extrapolated ghost values  (weno_dirichlet.jl)
* ``mirror``      reflection about the boundary interfaces (wenoL_roe/wenoR_roe)

Output convention (0-based):
* ``periodic`` (n nodes -> n outputs) and ``extrapolate`` (N+1 nodes -> N
  outputs): L output j is the left-biased state at x_{j+1/2} centred on
  u_j; periodic R[j] sits at x_{j-1/2} centred u_j; extrapolate R[j] sits
  at x_{j+1/2} centred u_{j+1}.
* ``mirror`` (n cells -> n+1 interface outputs j=0..n, boundary faces
  included): L[j] centred u_{j-1} and R[j] centred u_j, both at x_{j-1/2}
  — the Euler layout of wenoL_roe/wenoR_roe.  Its ghosts are one index
  map: cell i < 0 reads u_{-i-1}, cell i >= n reads u_{2n-1-i}.
"""
from __future__ import annotations

import torch

EPS_WENO = 1e-6


def _smoothness(v1, v2, v3, v4, v5):
    s1 = (13.0 / 12.0) * (v1 - 2 * v2 + v3) ** 2 + 0.25 * (v1 - 4 * v2 + 3 * v3) ** 2
    s2 = (13.0 / 12.0) * (v2 - 2 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    s3 = (13.0 / 12.0) * (v3 - 2 * v4 + v5) ** 2 + 0.25 * (3 * v3 - 4 * v4 + v5) ** 2
    return s1, s2, s3


def weno5_L(v1, v2, v3, v4, v5, eps: float = EPS_WENO):
    """Upwind (left-biased) WENO-5 value at the right face of the v3 cell
    (Common.jl:292-314, linear weights .1/.6/.3)."""
    s1, s2, s3 = _smoothness(v1, v2, v3, v4, v5)
    c1 = 0.1 / (eps + s1) ** 2
    c2 = 0.6 / (eps + s2) ** 2
    c3 = 0.3 / (eps + s3) ** 2
    wsum = c1 + c2 + c3
    q1 = v1 / 3.0 - (7.0 / 6.0) * v2 + (11.0 / 6.0) * v3
    q2 = -v2 / 6.0 + (5.0 / 6.0) * v3 + v4 / 3.0
    q3 = v3 / 3.0 + (5.0 / 6.0) * v4 - v5 / 6.0
    return (c1 * q1 + c2 * q2 + c3 * q3) / wsum


def weno5_R(v1, v2, v3, v4, v5, eps: float = EPS_WENO):
    """Downwind (right-biased) WENO-5 value at the left face of the v3 cell
    (Common.jl:319-339, linear weights .3/.6/.1)."""
    s1, s2, s3 = _smoothness(v1, v2, v3, v4, v5)
    c1 = 0.3 / (eps + s1) ** 2
    c2 = 0.6 / (eps + s2) ** 2
    c3 = 0.1 / (eps + s3) ** 2
    wsum = c1 + c2 + c3
    q1 = -v1 / 6.0 + (5.0 / 6.0) * v2 + v3 / 3.0
    q2 = v2 / 3.0 + (5.0 / 6.0) * v3 - v4 / 6.0
    q3 = (11.0 / 6.0) * v3 - (7.0 / 6.0) * v4 + v5 / 3.0
    return (c1 * q1 + c2 * q2 + c3 * q3) / wsum


def _stencils(u_ghost, n_out: int):
    """Five shifted length-n_out slices of a ghost-padded line (last axis)."""
    return tuple(u_ghost[..., k : k + n_out] for k in range(5))


# ------------------------------------------------------------------ padding
# Each pad returns (u_ghost, n_out) such that output j uses
# u_ghost[..., j:j+5] with v3 centred per the module docstring.

def _pad_periodic(u):
    # output j = 0..n-1 uses u_{j-2}..u_{j+2} (wrap), centred on u_j
    n = u.shape[-1]
    return torch.cat([u[..., -2:], u, u[..., :2]], dim=-1), n


def _pad_extrap_L(u):
    # nodes u_0..u_N; uL[j] at x_{j+1/2}, j = 0..N-1 (weno_dirichlet.jl:77-112)
    g1 = 2 * u[..., :1] - u[..., 1:2]      # u_{-1}
    g2 = 3 * u[..., :1] - 2 * u[..., 1:2]  # u_{-2}
    gr = 2 * u[..., -1:] - u[..., -2:-1]   # u_{N+1}
    return torch.cat([g2, g1, u, gr], dim=-1), u.shape[-1] - 1


def _pad_extrap_R(u):
    # uR[j] at x_{j-1/2}, j = 1..N (weno_dirichlet.jl:119-155)
    g1 = 2 * u[..., :1] - u[..., 1:2]          # u_{-1}
    gr1 = 2 * u[..., -1:] - u[..., -2:-1]      # u_{N+1}
    gr2 = 3 * u[..., -1:] - 2 * u[..., -2:-1]  # u_{N+2}
    return torch.cat([g1, u, gr1, gr2], dim=-1), u.shape[-1] - 1


def _pad_mirror_L(u):
    # n+1 interfaces, stencil centred u_{j-1}: ghosts u_2, u_1, u_0 | u_{n-1},
    # u_{n-2} (Common.jl:516-569 wenoL_roe)
    n = u.shape[-1]
    left = torch.flip(u[..., :3], dims=(-1,))
    right = torch.flip(u[..., -2:], dims=(-1,))
    return torch.cat([left, u, right], dim=-1), n + 1


def _pad_mirror_R(u):
    # n+1 interfaces, stencil centred u_j: ghosts u_1, u_0 | u_{n-1}, u_{n-2},
    # u_{n-3} (Common.jl:576-629 wenoR_roe)
    n = u.shape[-1]
    left = torch.flip(u[..., :2], dims=(-1,))
    right = torch.flip(u[..., -3:], dims=(-1,))
    return torch.cat([left, u, right], dim=-1), n + 1


_PADS = {
    ("periodic", "L"): _pad_periodic,
    ("periodic", "R"): _pad_periodic,
    ("extrapolate", "L"): _pad_extrap_L,
    ("extrapolate", "R"): _pad_extrap_R,
    ("mirror", "L"): _pad_mirror_L,
    ("mirror", "R"): _pad_mirror_R,
}


def reconstruct_left(u, bc: str, eps: float = EPS_WENO):
    """Left-biased (upwind) WENO-5 interface states along the last axis."""
    u_ghost, n_out = _PADS[(bc, "L")](u)
    return weno5_L(*_stencils(u_ghost, n_out), eps)


def reconstruct_right(u, bc: str, eps: float = EPS_WENO):
    """Right-biased (downwind) WENO-5 interface states along the last axis."""
    u_ghost, n_out = _PADS[(bc, "R")](u)
    return weno5_R(*_stencils(u_ghost, n_out), eps)
