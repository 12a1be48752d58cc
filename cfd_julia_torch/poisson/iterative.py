"""Iterative Poisson solvers: Jacobi, red-black Gauss-Seidel, conjugate
gradient and multigrid-preconditioned flexible CG (counterpart of
cfd_julia_tpu/poisson/iterative.py).

Reference parity notes:
* ch. 15's `gauss_seidel` (gauss_seidel.jl:8-54) is **point Jacobi** despite
  its name (the residual of the whole field is computed before any update);
  `jacobi` here is the exact equivalent.
* The reference's true Gauss-Seidel (`gauss_seidel_mg`, Common.jl:78-92) is
  lexicographic and order-dependent; `redblack` is the data-parallel
  replacement: two half-sweeps with the same smoothing behaviour.
* `cg` follows conjugate_gradient.jl:7-79 update-for-update.
* Residual histories: the reference streams "(it, rms, rms/rms0)" lines to
  text files every `freq` iterations (gauss_seidel.jl:41-47); here a
  preallocated NaN-padded (max_records, 3) tensor is filled at the same
  cadence on the solve's device and returned.

Each JAX `lax.while_loop` is a Python loop of eager tensor operations.  The
convergence test reads rms/rms0 on the host once per check (every `freq`
sweeps for the relaxations, every iteration for CG and MG-CG), so a solve
synchronises with the device once per check; capturing the loop body in a
CUDA graph is later work.  Every sweep is shift + mask arithmetic on the
full (nx+1, ny+1) array; the interior mask keeps Dirichlet boundary values
exactly.
"""
from __future__ import annotations

import dataclasses

import torch

from cfd_julia_torch.ops import arakawa


@dataclasses.dataclass
class IterativeResult:
    """Solve result; the tensors stay on the solve's device, the two
    counters are host ints because the loop runs on the host."""
    u: torch.Tensor
    iterations: int
    rms: torch.Tensor           # final residual L2 norm
    rms0: torch.Tensor          # initial residual L2 norm
    history: torch.Tensor       # (max_records, 3): it, rms, rms/rms0 (NaN pad)
    n_records: int


def interior_mask(nx: int, ny: int, dtype, device="cpu"):
    """1 on interior nodes of an (nx+1, ny+1) grid, 0 on the boundary."""
    m = torch.zeros((nx + 1, ny + 1), dtype=dtype, device=device)
    m[1:-1, 1:-1] = 1
    return m


def color_masks(nx: int, ny: int, dtype, device="cpu"):
    """(red, black) interior checkerboard masks, full (nx+1, ny+1) size;
    red is (i + j) even."""
    i = torch.arange(nx + 1, device=device)
    j = torch.arange(ny + 1, device=device)
    par = (i[:, None] + j[None, :]) % 2
    inter = interior_mask(nx, ny, dtype, device)
    return inter * (par == 0), inter * (par == 1)


def residual_full(f, u, dx, dy, mask):
    """r = (f - lap u) on the interior, 0 on the boundary ring.  The
    Laplacian is ops.arakawa.laplacian, one stencil for Poisson residuals
    and the NS diffusion term, as in the JAX package."""
    return (f - arakawa.laplacian(u, dx, dy)) * mask


def _rms_from_full(r_full, nx, ny):
    """Matches compute_l2norm over interior nodes (Common.jl:229-232)."""
    return torch.sqrt(torch.sum(r_full**2) / ((nx - 1) * (ny - 1)))


def jacobi_sweep(u, f, dx: float, dy: float, mask):
    """One point-Jacobi update (gauss_seidel.jl:33-39)."""
    r = residual_full(f, u, dx, dy, mask)
    return u + r / (-2.0 / dx**2 - 2.0 / dy**2)


def chebyshev_smooth(u, f, dx: float, dy: float, iters: int, imask,
                     lmax: float = 2.0, lmin_frac: float = 0.25,
                     residual=residual_full):
    """Degree-`iters` Chebyshev-accelerated Jacobi smoother: damps the
    upper eigenvalue band [lmin_frac*lmax, lmax] of the
    Jacobi-preconditioned 5-point Laplacian (Saad, Iterative Methods,
    alg. 12.1).  Each degree is one unmasked residual and two axpys.
    residual: residual_full's signature; the mesh multigrid passes one
    that takes the stencil's halo from the neighbouring ranks."""
    if iters <= 0:
        return u
    diag = -2.0 / dx**2 - 2.0 / dy**2
    b = lmax
    a = lmax * lmin_frac
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    r = residual(f, u, dx, dy, imask)
    d = (r / diag) / theta
    u = u + d
    # a fill, not torch.tensor: a CUDA graph capture forbids host copies
    rho = u.new_full((), 1.0 / sigma1)
    for _ in range(iters - 1):
        z = residual(f, u, dx, dy, imask) / diag
        rho_n = 1.0 / (2.0 * sigma1 - rho)
        d = rho_n * rho * d + (2.0 * rho_n / delta) * z
        u = u + d
        rho = rho_n.to(u.dtype)
    return u


def redblack_sweep(u, f, dx: float, dy: float, mask_red, mask_black):
    """One red-black Gauss-Seidel sweep: two masked half-updates; the black
    half sees the freshly updated red values (data-parallel true GS)."""
    diag = -2.0 / dx**2 - 2.0 / dy**2
    u = u + residual_full(f, u, dx, dy, mask_red) / diag
    return u + residual_full(f, u, dx, dy, mask_black) / diag


def _record(hist, nrec: int, it: int, rms, rel):
    """Row nrec of a (max_records, 3) history: it, rms, rms/rms0."""
    hist[nrec, 0] = it
    hist[nrec, 1] = rms
    hist[nrec, 2] = rel


def relax_solve(f, u0, dx: float, dy: float, tol: float = 1e-9,
                max_iter: int = 100_000, freq: int = 100,
                method: str = "jacobi") -> IterativeResult:
    """Relaxation solve (Jacobi or red-black GS) until rms/rms0 <= tol.

    Runs `freq` sweeps per convergence check, exactly the reference cadence
    (gauss_seidel.jl:41-47 with freq=10_000); one host sync per check."""
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    mask = interior_mask(nx, ny, f.dtype, f.device)
    if method == "jacobi":
        def sweep(u):
            return jacobi_sweep(u, f, dx, dy, mask)
    elif method == "redblack":
        mr, mb = color_masks(nx, ny, f.dtype, f.device)

        def sweep(u):
            return redblack_sweep(u, f, dx, dy, mr, mb)
    else:
        raise ValueError(f"unknown relaxation {method!r}")

    max_records = max(1, max_iter // freq) + 1
    rms0 = _rms_from_full(residual_full(f, u0, dx, dy, mask), nx, ny)
    hist = torch.full((max_records, 3), float("nan"), dtype=f.dtype,
                      device=f.device)
    u, it, rms, rel, nrec = u0, 0, rms0, rms0 / rms0, 0
    while it < max_iter and float(rel) > tol:
        for _ in range(freq):
            u = sweep(u)
        it += freq
        rms = _rms_from_full(residual_full(f, u, dx, dy, mask), nx, ny)
        rel = rms / rms0
        _record(hist, nrec, it, rms, rel)
        nrec += 1
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)


def cg_solve(f, u0, dx: float, dy: float, tol: float = 1e-9,
             max_iter: int = 100_000, freq: int = 100) -> IterativeResult:
    """Matrix-free conjugate gradient (conjugate_gradient.jl:7-79): the
    5-point Laplacian is applied as a stencil, convergence on rms/rms0
    (one host sync per iteration), history recorded every `freq`
    iterations."""
    eps = 1e-16
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    mask = interior_mask(nx, ny, f.dtype, f.device)
    r = residual_full(f, u0, dx, dy, mask)
    rms0 = _rms_from_full(r, nx, ny)
    max_records = max(1, max_iter // freq) + 1
    hist = torch.full((max_records, 3), float("nan"), dtype=f.dtype,
                      device=f.device)
    u, p, it, rms, rel, nrec = u0, r, 0, rms0, rms0 / rms0, 0
    while it < max_iter and float(rel) > tol:
        it += 1
        ap = arakawa.laplacian(p, dx, dy) * mask
        rr = torch.sum(r**2)
        alpha = rr / (torch.sum(ap * p) + eps)
        u = u + alpha * p          # p is 0 on the boundary ring
        r = r - alpha * ap
        rr_new = torch.sum(r**2)
        beta = rr_new / (rr + eps)
        p = r + beta * p
        rms = torch.sqrt(rr_new / ((nx - 1) * (ny - 1)))
        rel = rms / rms0
        if it % freq == 0:
            _record(hist, nrec, it, rms, rel)
            nrec += 1
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)


def mgcg_solve(f, u0, dx: float, dy: float, tol: float = 1e-9,
               max_iter: int = 200, mg_cfg=None) -> IterativeResult:
    """Multigrid-preconditioned flexible CG, a solver the reference does
    not have: one V-cycle (from zero) as the preconditioner M^-1 inside
    CG, with the Polak-Ribiere beta = <z, r - r_prev> / <z_prev, r_prev>
    (the red-black V-cycle is linear but not symmetric, so standard PCG's
    beta can stall).  History is recorded every iteration; one host sync
    per iteration."""
    from cfd_julia_torch.poisson import multigrid

    mg_cfg = mg_cfg or multigrid.MGConfig()
    multigrid.check_config(mg_cfg)
    impl = multigrid.impl_choice(mg_cfg.impl, f.device)
    eps = 1e-300 if f.dtype == torch.float64 else 1e-30
    nx, ny = f.shape[0] - 1, f.shape[1] - 1
    mask = interior_mask(nx, ny, f.dtype, f.device)
    levels = multigrid._build_levels(nx, ny, dx, dy, mg_cfg.n_levels)
    imasks = [interior_mask(l[0], l[1], f.dtype, f.device) for l in levels]

    def precond(res):
        return multigrid.v_cycle(torch.zeros_like(res), res, levels, imasks,
                                 mg_cfg, impl) * mask

    r = residual_full(f, u0, dx, dy, mask)
    rms0 = _rms_from_full(r, nx, ny)
    z = precond(r)
    hist = torch.full((max_iter + 1, 3), float("nan"), dtype=f.dtype,
                      device=f.device)
    u, p, it, rms, rel, nrec = u0, z, 0, rms0, rms0 / rms0, 0
    while it < max_iter and float(rel) > tol:
        it += 1
        ap = arakawa.laplacian(p, dx, dy) * mask
        rz = torch.sum(r * z)
        alpha = rz / (torch.sum(ap * p) + eps)
        u = u + alpha * p
        r_new = r - alpha * ap
        z_new = precond(r_new)
        # Polak-Ribiere (flexible) beta
        beta = torch.sum(z_new * (r_new - r)) / (rz + eps)
        p = z_new + beta * p
        r, z = r_new, z_new
        rms = _rms_from_full(r, nx, ny)
        rel = rms / rms0
        _record(hist, nrec, it, rms, rel)
        nrec += 1
    return IterativeResult(u=u, iterations=it, rms=rms, rms0=rms0,
                           history=hist, n_records=nrec)
