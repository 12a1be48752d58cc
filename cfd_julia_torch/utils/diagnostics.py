"""Flow diagnostics for the periodic 2D solvers (beyond the reference,
which only writes raw fields; counterpart of
cfd_julia_tpu/utils/diagnostics.py): kinetic-energy spectrum E(k) and the
integral invariants (energy, enstrophy, palinstrophy) — the standard
quantities for 2D-turbulence studies like the vortex merger (reference
ch. 19-22 problems).

Everything stays on the input's device.  The radial binning is a
scatter-add (`index_add_`), which on a CUDA device adds with atomics in no
fixed order: the fp32 bins agree from run to run only to roundoff
(~1e-6 of a bin), not bit for bit.
"""
from __future__ import annotations

import math

import torch


def _wavenumber_grid(nx: int, ny: int, dtype, device):
    """Integer wavenumber components on the rfft2 half grid (nx, ny//2+1)
    and the multiplicity weights that make half-spectrum sums equal full
    ones (interior columns count twice)."""
    i = torch.arange(nx, device=device)
    kx = torch.where(i < nx // 2, i, i - nx)[:, None]
    ky = torch.arange(ny // 2 + 1, device=device)[None, :]
    edge = ky == 0
    if ny % 2 == 0:
        edge = edge | (ky == ny // 2)
    mult = torch.where(edge, 1.0, 2.0).to(dtype)
    shape = (nx, ny // 2 + 1)
    return (kx.to(dtype).expand(shape), ky.to(dtype).expand(shape),
            mult.expand(shape))


def energy_spectrum(w, ny: int | None = None):
    """Radially binned kinetic-energy spectrum E(k) of a periodic 2D
    vorticity field w (nx, ny): E(k) = sum_{|k'| in [k-1/2,k+1/2)}
    |w_hat|^2 / (2 |k'|^2) with Parseval normalization 1/(nx ny)^2.

    Returns (k_bins, E) with k_bins = 1..min(nx,ny)//2.  A complex `w` is
    taken as the rfft2 half spectrum (nx, ny//2+1) instead of the physical
    field (the spectral solvers' state — no extra transform); its ny is
    2(hy-1) unless given.

    The integer-|k| radial binning assumes equal physical domain lengths
    (nx dx == ny dy, e.g. the reference's [0,2pi]^2 with any nx == ny);
    for anisotropic domains bin on physical |k| instead."""
    if w.is_complex():
        H = w
        nx, hy = H.shape
        if ny is None:
            # the half width hy = ny//2+1 is ambiguous: both ny=2(hy-1)
            # (even) and ny=2hy-1 (odd) map to it — assume even, as the
            # solver grids are, and require the explicit ny otherwise
            ny = 2 * (hy - 1)
        elif ny // 2 + 1 != hy:
            raise ValueError(f"ny={ny} inconsistent with half width {hy}")
    else:
        nx, ny = w.shape
        H = torch.fft.rfft2(w)
    kx, ky, mult = _wavenumber_grid(nx, ny, H.real.dtype, H.device)
    kmag = torch.sqrt(kx**2 + ky**2)
    k2 = torch.clamp(kmag**2, min=1e-12)
    dens = mult * H.abs() ** 2 / (2.0 * k2) / (nx * ny) ** 2
    nbins = min(nx, ny) // 2
    kb = torch.arange(1, nbins + 1, device=H.device)
    # scatter-add binning: a one-hot product would materialize an
    # (nbins, nx, ny/2+1) tensor, ~8.6 GB at 2048^2
    r = torch.round(kmag).long()
    r = torch.where((r >= 1) & (r <= nbins), r, nbins + 1)
    e = dens.new_zeros(nbins + 2).index_add_(0, r.reshape(-1),
                                             dens.reshape(-1))
    return kb, e[1 : nbins + 1]


def invariants(w, dx: float, dy: float):
    """(energy, enstrophy, palinstrophy) integrals of a periodic 2D
    vorticity field: E = 1/2 int |u|^2, Z = 1/2 int w^2,
    P = 1/2 int |grad w|^2.  For decaying 2D NS: dE/dt = -2 nu Z,
    dZ/dt = -2 nu P (the enstrophy-budget identity used as a solver
    diagnostic).  Correct for anisotropic domains: |k|^2 is built from
    per-axis physical wavenumber spacings 2 pi/(n d)."""
    nx, ny = w.shape
    H = torch.fft.rfft2(w)
    kx, ky, mult = _wavenumber_grid(nx, ny, w.dtype, w.device)
    sx = 2.0 * math.pi / (nx * dx)       # physical wavenumber spacings,
    sy = 2.0 * math.pi / (ny * dy)       # per axis
    k2phys = (kx * sx) ** 2 + (ky * sy) ** 2
    mult = mult.clone()
    mult[0, 0] = 0.0                     # gauge: the mean mode carries no
    k2phys[0, 0] = 1.0                   # velocity/enstrophy (k2 guarded)
    area = (nx * dx) * (ny * dy)
    cell = area / (nx * ny) ** 2
    # spectral integrals (exact for band-limited fields)
    p2 = mult * H.abs() ** 2
    e = 0.5 * torch.sum(p2 / k2phys) * cell
    z = 0.5 * torch.sum(p2) * cell
    p = 0.5 * torch.sum(k2phys * p2) * cell
    return e, z, p
