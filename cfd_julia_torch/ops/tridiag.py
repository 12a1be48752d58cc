"""Batched tridiagonal solvers (counterpart of cfd_julia_tpu/ops/tridiag.py):
the engine behind Crank-Nicolson, the implicit compact Pade scheme and
CRWENO-5.

The reference sweeps serial Thomas recurrences (`tdms` Common.jl:257-271,
`tdma` Common.jl:276-287) and wraps them in Sherman-Morrison for cyclic
systems (`ctdms`, 06_Inviscid_Burgers_CRWENO/crweno_periodic.jl:74-93).
The default here is parallel cyclic reduction (PCR): ceil(log2 n) rounds of
whole-line shifted arithmetic, about 20 elementwise launches a round, the
same for any number of lines.  `thomas` is the sequential cross-check: a
Python loop over the rows, O(n) launches a solve on a GPU.

All solvers work along the last axis and broadcast over leading batch axes.
Nothing writes into its inputs: the corner edits of `solve_cyclic` go to
copies, so a step captured in a CUDA graph never overwrites its state.
"""
from __future__ import annotations

import math

import torch


def _shift_last(x, k: int, fill: float):
    """x[..., i-k] with constant `fill` outside the range (k may be
    negative): a concatenation, never a roll."""
    if k == 0:
        return x
    pad = x.new_full((*x.shape[:-1], abs(k)), fill)
    if k > 0:
        return torch.cat([pad, x[..., :-k]], dim=-1)
    return torch.cat([x[..., -k:], pad], dim=-1)


def pcr(a, b, c, d):
    """Solve tridiagonal systems by parallel cyclic reduction.

    a: sub-diagonal (a[..., 0] ignored / 0); b: main diagonal; c:
    super-diagonal (c[..., -1] ignored / 0); d: right-hand sides; all
    broadcast together.  Returns x of the broadcast shape.  Each round
    combines row i with rows i-s and i+s, out-of-range rows acting as
    identity rows (a=0, b=1, c=0, d=0), and doubles the stride s.  Stable
    for the diagonally dominant systems this engine serves."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    n = d.shape[-1]
    steps = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    s = 1
    for _ in range(steps):
        a_m = _shift_last(a, s, 0.0)
        b_m = _shift_last(b, s, 1.0)
        c_m = _shift_last(c, s, 0.0)
        d_m = _shift_last(d, s, 0.0)
        a_p = _shift_last(a, -s, 0.0)
        b_p = _shift_last(b, -s, 1.0)
        c_p = _shift_last(c, -s, 0.0)
        d_p = _shift_last(d, -s, 0.0)
        alpha = -a / b_m
        gamma = -c / b_p
        b = b + alpha * c_m + gamma * a_p
        d = d + alpha * d_m + gamma * d_p
        a = alpha * a_m
        c = gamma * c_p
        s *= 2
    return d / b


def thomas(a, b, c, d):
    """Sequential Thomas solve (Common.jl:257-271), batched over the leading
    axes: forward elimination, then back substitution, one row at a time."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    n = d.shape[-1]
    beta = b[..., 0]
    xs = [d[..., 0] / beta]
    zs = [None]
    for i in range(1, n):
        z = c[..., i - 1] / beta
        beta = b[..., i] - a[..., i] * z
        xs.append((d[..., i] - a[..., i] * xs[-1]) / beta)
        zs.append(z)
    for i in range(n - 2, -1, -1):
        xs[i] = xs[i] - zs[i + 1] * xs[i + 1]
    return torch.stack(xs, dim=-1)


def solve(a, b, c, d, method: str = "pcr"):
    """Solve (batched) tridiagonal systems along the last axis."""
    if method == "pcr":
        return pcr(a, b, c, d)
    if method == "thomas":
        return thomas(a, b, c, d)
    raise ValueError(f"unknown tridiagonal method {method!r}")


def _with(x, index: int, value):
    """A copy of x with x[..., index] = value (a tensor, or a number
    written by a fill: no host-to-device copy, which a CUDA graph's capture
    refuses)."""
    out = x.clone(memory_format=torch.contiguous_format)
    if isinstance(value, torch.Tensor):
        out[..., index] = value
    else:
        out[..., index].fill_(value)
    return out


def solve_cyclic(a, b, c, d, method: str = "pcr"):
    """Solve a cyclic (periodic) tridiagonal system by Sherman-Morrison.

    The corner couplings are a[..., 0] (row 0 -> x_{n-1}) and c[..., -1]
    (row n-1 -> x_0), the layout of the reference's `ctdms`
    (crweno_periodic.jl:74-93).  Solves the rank-1-corrected acyclic system
    for two right-hand sides at once and combines them."""
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    alpha = a[..., 0]    # A[0, n-1]
    beta = c[..., -1]    # A[n-1, 0]
    gamma = -b[..., 0]

    # A = T + u v^T with u = (gamma, 0..0, beta), v = (1, 0..0, alpha/gamma)
    b_mod = _with(b, 0, b[..., 0] + (-gamma))
    b_mod = _with(b_mod, -1, b_mod[..., -1] + (-alpha * beta / gamma))
    a_mod = _with(a, 0, 0.0)
    c_mod = _with(c, -1, 0.0)
    u = _with(_with(torch.zeros_like(d), 0, gamma), -1, beta)

    yz = solve(a_mod[None], b_mod[None], c_mod[None],
               torch.stack([d, u], dim=0), method=method)
    y, z = yz[0], yz[1]
    fact = (y[..., 0] + alpha * y[..., -1] / gamma) / (
        1.0 + z[..., 0] + alpha * z[..., -1] / gamma)
    return y - fact[..., None] * z
