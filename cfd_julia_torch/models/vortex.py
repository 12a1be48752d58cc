"""Periodic 2D NS (vorticity-streamfunction): vortex merger and
Taylor-Green vortex — four solver formulations (reference ch. 19-22;
counterpart of cfd_julia_tpu/models/vortex.py).

* ``fdm``     Arakawa + FFT Poisson + SSP-RK3, all physical space
              (19_.../vm.jl + Common.vm_rhs). State: vorticity w (nx, ny).
              On a CUDA device the Arakawa + Laplacian RHS is the kernel
              csrc/arakawa_rhs.cu, whose periodic wrap is this case.
* ``hybrid``  Arakawa Jacobian in physical space via FFT round trips,
              diffusion integrated semi-implicitly in Fourier space with a
              3-stage low-storage RK3/CN scheme (20_.../hybrid.jl).
* ``ps32``    fully pseudospectral Jacobian with 3/2-rule zero-padding
              dealiasing (21_.../pseudospectral_32_rule.jl).
* ``ps23``    same with 2/3-rule truncation (22_.../pseudospectral_23_rule.jl).

The spectral solvers carry the rfft2 HALF spectrum (nx, ny//2+1) of the
real vorticity across the whole run (`make_spectral_step_half`, what
`solve` runs); `make_spectral_step` is the same scheme on the full (nx, ny)
spectrum.  All transforms are torch.fft (cuFFT on a CUDA device).  No ghost
arrays — periodicity is torch.roll or the kernel's wrap; snapshots stack on
the device (the reference ifft's to write text snapshots mid-loop,
vm.jl:78-86).

PyTorch runs eagerly, so the wavenumber, Crank-Nicolson and Jacobian
constants are built once, on the device, when a step is made, and reused
by every step (the JAX package rebuilds them inside its traced step).

Reference run config: 128^2, [0, 2pi]^2, Re=1000, dt=0.01, t=20 (vm);
TGV validation: 64^2, Re=10, dt=0.01, t=1 (tgv.jl:92-146).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import arakawa, cuda_kernels, spectral
from cfd_julia_torch.stepping import loop, ssprk3

TWO_PI = 2.0 * math.pi

# low-storage RK3/CN coefficients (hybrid.jl:30-32)
ALPHAS = (8.0 / 15.0, 2.0 / 15.0, 1.0 / 3.0)
GAMMAS = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RHOS = (0.0, -17.0 / 60.0, -5.0 / 12.0)


@dataclasses.dataclass(frozen=True)
class VortexConfig:
    nx: int = 128
    ny: int = 128
    solver: str = "fdm"      # fdm | hybrid | ps32 | ps23
    dt: float = 0.01
    t_final: float = 20.0
    re: float = 1000.0
    ns: int = 10             # snapshots
    ic: str = "vm"           # vm | tgv
    tgv_n: int = 4
    rhs_impl: str = "auto"   # the fdm Arakawa RHS: auto (kernel on a CUDA
                             # device, torch on the CPU) | kernel
                             # (csrc/arakawa_rhs.cu; CUDA only) | torch
                             # (ops.arakawa, any device)

    @property
    def dx(self) -> float:
        return TWO_PI / self.nx

    @property
    def dy(self) -> float:
        return TWO_PI / self.ny

    @property
    def nt(self) -> int:
        return round(self.t_final / self.dt)

    def __post_init__(self):
        # a typo'd variant selector must never silently run (and get
        # benchmarked as) the default implementation
        _check = (("solver", ("fdm", "hybrid", "ps32", "ps23")),
                  ("ic", ("vm", "tgv")),
                  ("rhs_impl", ("auto", "kernel", "torch")))
        for name, allowed in _check:
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} "
                                 f"{getattr(self, name)!r} (one of "
                                 f"{' | '.join(allowed)})")
        if self.ns < 1:
            raise ValueError("ns (snapshot count) must be >= 1")


@dataclasses.dataclass
class VortexResult:
    x: torch.Tensor           # nx+1 nodes (periodic wrap included)
    y: torch.Tensor
    w: torch.Tensor           # final vorticity (nx, ny) unique nodes
    snapshots: torch.Tensor   # (nt//every + 1, nx, ny) incl. the IC,
                              # every = max(1, nt//ns): ns+1 rows when
                              # ns divides nt


# ------------------------------------------------------------------- ICs

def vm_ic(X, Y):
    """Two co-rotating Gaussian vortices (Common.jl:208-219)."""
    sigma = math.pi
    xc1, yc1 = math.pi - math.pi / 4.0, math.pi
    xc2, yc2 = math.pi + math.pi / 4.0, math.pi
    return torch.exp(-sigma * ((X - xc1) ** 2 + (Y - yc1) ** 2)) + torch.exp(
        -sigma * ((X - xc2) ** 2 + (Y - yc2) ** 2)
    )


def tgv_exact(X, Y, t, re: float, n: int = 4):
    """Analytic Taylor-Green vorticity (tgv.jl:82-90)."""
    return (
        2.0 * n * torch.cos(n * X) * torch.cos(n * Y)
        * math.exp(-2.0 * n**2 * t / re)
    )


def _unique_nodes(cfg: VortexConfig, dtype, device):
    x = torch.arange(cfg.nx, dtype=dtype, device=device) * cfg.dx
    y = torch.arange(cfg.ny, dtype=dtype, device=device) * cfg.dy
    return torch.meshgrid(x, y, indexing="ij")


def initial_vorticity(cfg: VortexConfig, dtype=None, device="cuda"):
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    X, Y = _unique_nodes(cfg, dtype, device)
    if cfg.ic == "vm":
        return vm_ic(X, Y)
    return tgv_exact(X, Y, 0.0, cfg.re, cfg.tgv_n)


# ----------------------------------------------------------------- FDM

def fdm_rhs(w, dx, dy, re, impl: str = "torch", poisson=None):
    """vm_rhs: psi from FFT Poisson (FDM eigenvalues), Arakawa + viscous
    Laplacian (Common.jl:132-182).  impl="kernel" runs the fused
    Jacobian+Laplacian CUDA kernel (ops.cuda_kernels), "torch" its plain
    twin ops.arakawa.vorticity_rhs.  `poisson`: a solve built once by
    spectral.make_fft_poisson_periodic for w's grid; built for this call
    when not given."""
    if impl not in ("kernel", "torch"):
        raise ValueError(f"unknown fdm rhs impl {impl!r} (kernel | torch)")
    if poisson is None:
        s = spectral.fft_poisson_periodic(-w, dx, dy, eigen="fdm")
    else:
        s = poisson(-w)
    if impl == "kernel":
        return cuda_kernels.arakawa_rhs_fused(w, s, dx, dy, re)
    return arakawa.vorticity_rhs(w, s, dx, dy, re)


def make_fdm_rhs(cfg: VortexConfig, dtype=None, device="cuda"):
    """w (nx, ny) -> dw/dt on `device` for the fdm solver, with the Poisson
    eigenvalues built once and cfg.rhs_impl resolved against the device."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    impl = precision.resolve_rhs_impl(cfg.rhs_impl, device)
    poisson = spectral.make_fft_poisson_periodic(
        cfg.nx, cfg.ny, cfg.dx, cfg.dy, dtype, device, eigen="fdm")
    return lambda w: fdm_rhs(w, cfg.dx, cfg.dy, cfg.re, impl, poisson)


# ------------------------------------------------- spectral formulations

def _spectral_consts(cfg: VortexConfig, dtype, device=None):
    """(k2, kx, ky) of the full spectrum from the numpy-built wavenumbers
    of ops.spectral (fp64, cast to `dtype`)."""
    k2 = spectral.wavespace(cfg.nx, cfg.ny, cfg.dx, cfg.dy, dtype, device)
    kx = spectral.fft_wavenumber_index(cfg.nx, cfg.dx, dtype, device)
    ky = spectral.fft_wavenumber_index(cfg.ny, cfg.dy, dtype, device)
    return k2, kx, ky


def _kvec(n: int, d: float, dtype, device, eps: float):
    """eps-guarded FFT wavenumber vector computed in the working dtype (the
    JAX steps' `_kvec_traced` rule; spectral.fft_wavenumber_index computes
    in fp64 and casts)."""
    h = 2.0 * math.pi / (n * d)
    i = torch.arange(n, device=device)
    k = h * torch.where(i < n // 2, i, i - n).to(dtype)
    k[0] = eps
    return k


def _step_consts(cfg: VortexConfig, dtype, device, eps: float = 1e-6):
    """(k2, kx, ky) of the full spectrum in the working dtype, as the steps
    use them (`_spectral_consts_traced` in the JAX package)."""
    kx = _kvec(cfg.nx, cfg.dx, dtype, device, eps)
    ky = _kvec(cfg.ny, cfg.dy, dtype, device, eps)
    return kx[:, None] ** 2 + ky[None, :] ** 2, kx, ky


def jacobian_hybrid(wf, k2, dx, dy):
    """-J(w, psi) computed in physical space with the Arakawa scheme, psi
    from the spectrum (hybrid.jl:92-152)."""
    w = spectral.ifft2(wf).real
    s = spectral.ifft2(wf / k2).real
    return spectral.fft2(-arakawa.jacobian(w, s, dx, dy))


def _deriv_spectra(wf, k2, kx, ky):
    """psi_x, w_y, psi_y, w_x spectra (pseudospectral_32_rule.jl:113-122).

    Unlike the reference, the *multiplicative* wavenumbers zero (a) the
    k=0 entry — the reference's eps=1e-6 guard there breaks exact Hermitian
    symmetry and injects O(eps) noise (the guard is only needed for the
    1/k^2 division, where k2 keeps it) — and (b) the Nyquist mode, whose
    first derivative is not representable as a Hermitian (real-field)
    spectrum; zeroing it is the standard pseudospectral convention."""
    nx_, ny_ = kx.shape[0], ky.shape[0]
    kx0 = kx.clone()
    kx0[0] = 0.0
    ky0 = ky.clone()
    ky0[0] = 0.0
    # drop the Nyquist row/column entirely: its placement under the 3/2-rule
    # pad (one-sided negative block, pad_32) cannot be Hermitian
    wf = wf * _nyquist_mask(nx_, ny_, wf.device)
    ikx = 1j * kx0[:, None]
    iky = 1j * ky0[None, :]
    return ikx * wf / k2, iky * wf, iky * wf / k2, ikx * wf


def _nyquist_mask(nx: int, ny: int, device=None, hy: int | None = None):
    """False on the Nyquist row and column of an even-sized (nx, ny)
    spectrum; hy = ny//2+1 gives the mask of the half spectrum."""
    ix = torch.arange(nx, device=device)[:, None]
    iy = torch.arange(ny if hy is None else hy, device=device)[None, :]
    keep_x = torch.ones_like(ix, dtype=torch.bool) if nx % 2 \
        else ix != nx // 2
    keep_y = torch.ones_like(iy, dtype=torch.bool) if ny % 2 \
        else iy != ny // 2
    return keep_x & keep_y


def jacobian_ps32(wf, k2, kx, ky, nx, ny):
    """Pseudospectral Jacobian, 3/2-rule zero-padding dealiasing
    (pseudospectral_32_rule.jl:95-177): jf = fft(psi_x w_y - psi_y w_x)
    evaluated on the 1.5x grid, truncated back.

    Deviation: the truncated spectrum's Nyquist row/column are zeroed.
    The reference's truncation keeps the fine grid's -n/2 modes without
    their +n/2 partners (truncate_32's one-sided negative block), leaving
    non-Hermitian content on the coarse Nyquist line — unrepresentable for
    a real field and inert anyway (_deriv_spectra masks it before every
    jacobian).  Zeroing it keeps the state exactly Hermitian so the
    half-spectrum path computes the same step."""
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    scale = (nxe * nye) / (nx * ny)
    specs = torch.stack(_deriv_spectra(wf, k2, kx, ky))
    j1, j2, j3, j4 = spectral.ifft2(
        spectral.pad_32(specs, nxe, nye) * scale).real
    jacpf = spectral.fft2(j1 * j2 - j3 * j4)
    return (spectral.truncate_32(jacpf, nx, ny) / scale) \
        * _nyquist_mask(nx, ny, wf.device)


def jacobian_ps23(wf, k2, kx, ky, nx, ny):
    """Pseudospectral Jacobian, 2/3-rule truncation
    (pseudospectral_23_rule.jl:93-144): derivative spectra are masked
    before the physical product; the product spectrum is NOT re-masked
    (reference behaviour).  The band is spectral.dealias_mask_23's
    symmetric |k| < ne//2."""
    mask = spectral.dealias_mask_23(nx, ny, wf.device)
    specs = torch.stack(_deriv_spectra(wf, k2, kx, ky)) * mask
    j1, j2, j3, j4 = spectral.ifft2(specs).real
    return spectral.fft2(j1 * j2 - j3 * j4)


def make_spectral_step(cfg: VortexConfig, dtype=None, device="cuda"):
    """3-stage low-storage RK3/CN step over the full vorticity spectrum
    (hybrid.jl:34-69, identical stepper in ch. 21/22): wf (nx, ny) complex
    -> wf after dt."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    dt, re = cfg.dt, cfg.re
    k2, kx, ky = _step_consts(cfg, dtype, device)
    if cfg.solver == "hybrid":
        jac = lambda wf: jacobian_hybrid(wf, k2, cfg.dx, cfg.dy)
    elif cfg.solver == "ps32":
        jac = lambda wf: jacobian_ps32(wf, k2, kx, ky, cfg.nx, cfg.ny)
    elif cfg.solver == "ps23":
        jac = lambda wf: jacobian_ps23(wf, k2, kx, ky, cfg.nx, cfg.ny)
    else:
        raise ValueError(f"solver {cfg.solver!r} has no spectral step")
    ds = [a * 0.5 * dt * k2 / re for a in ALPHAS]

    def step(wf):
        jn = jac(wf)
        w1 = ((1.0 - ds[0]) / (1.0 + ds[0])) * wf + (
            GAMMAS[0] * dt * jn
        ) / (1.0 + ds[0])
        w1 = spectral.zero_mean_mode(w1)
        j1 = jac(w1)
        w2 = ((1.0 - ds[1]) / (1.0 + ds[1])) * w1 + (
            RHOS[1] * dt * jn + GAMMAS[1] * dt * j1
        ) / (1.0 + ds[1])
        w2 = spectral.zero_mean_mode(w2)
        j2 = jac(w2)
        wn = ((1.0 - ds[2]) / (1.0 + ds[2])) * w2 + (
            RHOS[2] * dt * j1 + GAMMAS[2] * dt * j2
        ) / (1.0 + ds[2])
        return spectral.zero_mean_mode(wn)

    return step


# ------------------------------------------- half-spectrum path
#
# The state is the rfft2 HALF spectrum H (nx, ny//2+1) of the real
# vorticity — half the memory traffic of the full spectrum for every
# elementwise op in the step.  The four derivative spectra (psi_x, w_y,
# psi_y, w_x) are CONSTANT real multiples of i*H, so a stage builds them
# with one broadcast multiply, takes them to physical space with one
# batched irfft2, and brings the real Jacobian back with one rfft2, whose
# output *is* the state's layout.  FFT work: 2.5 c2c-equivalents a stage.

def _half_consts(cfg: VortexConfig, dtype, device, eps: float = 1e-6):
    """(kx0, ky0, k2h, nyq) on the half grid, in the working dtype
    (`_half_consts_traced` in the JAX package): the multiplicative
    wavenumbers with k=0 zeroed, the eps-guarded k^2 for the 1/k^2
    division, and the Nyquist row/column mask as 0/1."""
    nx, ny = cfg.nx, cfg.ny
    hy = 2.0 * math.pi / (ny * cfg.dy)
    iy = torch.arange(ny // 2 + 1, device=device)[None, :]
    kx = _kvec(nx, cfg.dx, dtype, device, eps)[:, None]
    kyh = hy * iy.to(dtype)
    kyg = kyh.clone()
    kyg[0, 0] = eps
    k2h = kx**2 + kyg**2
    kx0 = kx.clone()
    kx0[0, 0] = 0.0
    nyq = _nyquist_mask(nx, ny, device, ny // 2 + 1).to(dtype)
    return kx0, kyh, k2h, nyq


def _cn_consts(cfg: VortexConfig, k2h):
    """Per stage (a, b, r): the Crank-Nicolson diffusion factor of the
    state and the weights of the new and the previous Jacobian, each with
    the mean mode zeroed (`_cn_consts_traced` in the JAX package)."""
    dt, re = cfg.dt, cfg.re
    mean = torch.ones_like(k2h)
    mean[0, 0] = 0.0
    out = []
    for s in range(3):
        d = ALPHAS[s] * 0.5 * dt * k2h / re
        out.append((mean * (1.0 - d) / (1.0 + d),
                    mean * GAMMAS[s] * dt / (1.0 + d),
                    mean * RHOS[s] * dt / (1.0 + d)))
    return out


def _band_mask_23_half(cfg: VortexConfig, device=None):
    """spectral.dealias_mask_23 on the half grid: the symmetric row band,
    and the columns iy < nye//2 only."""
    nxe, nye = (2 * cfg.nx) // 3, (2 * cfg.ny) // 3
    ix = torch.arange(cfg.nx, device=device)[:, None]
    iy = torch.arange(cfg.ny // 2 + 1, device=device)[None, :]
    keep_x = (ix < nxe // 2) | (ix > cfg.nx - nxe // 2)
    return keep_x & (iy < nye // 2)


def _deriv_consts_half(cfg: VortexConfig, dtype, device, band_mask=None):
    """(4, nx, ny//2+1) real g with g * (i H) the half spectra of psi_x,
    w_y, psi_y, w_x: kx0/k2, ky0, ky0/k2, kx0, each times the Nyquist (and
    band) mask.  The JAX package holds the same four as two packed
    Hermitian pairs (`_packed_jacobian_consts_traced`)."""
    kx0, ky0, k2h, nyq = _half_consts(cfg, dtype, device)
    m = nyq if band_mask is None else nyq * band_mask.to(dtype)
    return torch.stack([(kx0 / k2h) * m, ky0 * m, (ky0 / k2h) * m, kx0 * m])


def make_spectral_step_half(cfg: VortexConfig, dtype=None, device="cuda"):
    """3-stage RK3/CN step over the rfft2 half spectrum: H (nx, ny//2+1)
    complex -> H after dt.

    The same operations as make_spectral_step on the representation with
    the Hermitian redundancy removed; tests/test_torch_vortex.py holds the
    two together and both against the JAX package."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    nx, ny = cfg.nx, cfg.ny
    _, _, k2h, nyq = _half_consts(cfg, dtype, device)
    (a1, b1, _), (a2, b2, r2), (a3, b3, r3) = _cn_consts(cfg, k2h)

    def product(phys):
        return phys[0] * phys[1] - phys[2] * phys[3]

    if cfg.solver == "hybrid":
        inv_k2h = 1.0 / k2h

        def jac(H):
            w, s = spectral.irfft2(torch.stack([H, H * inv_k2h]), nx, ny)
            return spectral.rfft2(-arakawa.jacobian(w, s, cfg.dx, cfg.dy))
    elif cfg.solver == "ps23":
        g = _deriv_consts_half(cfg, dtype, device,
                               _band_mask_23_half(cfg, device))

        def jac(H):
            return spectral.rfft2(product(
                spectral.irfft2(g * (1j * H), nx, ny)))
    elif cfg.solver == "ps32":
        nxe, nye = 3 * nx // 2, 3 * ny // 2
        scale = (nxe * nye) / (nx * ny)
        # the Parseval rescale of the padded spectra is folded into g, and
        # the one of the truncated product into the Nyquist zeroing (see
        # jacobian_ps32)
        g = _deriv_consts_half(cfg, dtype, device) * scale
        nyq_over_scale = nyq / scale

        def jac(H):
            pads = spectral.pad_32_half(g * (1j * H), ny, nxe, nye)
            jf = spectral.rfft2(product(spectral.irfft2(pads, nxe, nye)))
            return spectral.truncate_32_half(jf, nx, ny) * nyq_over_scale
    else:
        raise ValueError(f"solver {cfg.solver!r} has no spectral step")

    def step(H):
        jn = jac(H)
        H1 = a1 * H + b1 * jn
        j1 = jac(H1)
        H2 = a2 * H1 + r2 * jn + b2 * j1
        j2 = jac(H2)
        return a3 * H2 + r3 * j1 + b3 * j2

    return step


def half_init(w0):
    """rfft2 half-spectrum state with the mean mode projected out."""
    return spectral.zero_mean_mode(spectral.rfft2(w0))


def half_decode(H, nx: int, ny: int):
    """Real vorticity (nx, ny) from the half spectrum."""
    return spectral.irfft2(H, nx, ny)


# -------------------------------------------------------------- the solve

def make_step(cfg: VortexConfig, dtype=None, device="cuda"):
    """The step `solve` runs for cfg.solver: SSP-RK3 over the fdm RHS on
    the vorticity field, or the half-spectrum RK3/CN step."""
    if cfg.solver == "fdm":
        rhs = make_fdm_rhs(cfg, dtype, device)
        return lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
    return make_spectral_step_half(cfg, dtype, device)


def solve(cfg: VortexConfig, dtype=None, device="cuda") -> VortexResult:
    """Integrate nt steps collecting cfg.ns snapshots (vm.jl:60-88); every
    tensor of the result stays on `device`."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    w0 = initial_vorticity(cfg, dtype, device)
    x = torch.arange(cfg.nx + 1, dtype=dtype, device=device) * cfg.dx
    y = torch.arange(cfg.ny + 1, dtype=dtype, device=device) * cfg.dy
    every = max(1, cfg.nt // cfg.ns)
    step = make_step(cfg, dtype, device)

    if cfg.solver == "fdm":
        state0, observe, decode = w0, None, lambda s: s
    else:
        state0 = half_init(w0)
        observe = decode = lambda H: half_decode(H, cfg.nx, cfg.ny)

    state, snaps = loop.run_steps_with_snapshots(
        step, state0, cfg.nt, every, observe=observe)
    return VortexResult(x=x, y=y, w=decode(state),
                        snapshots=torch.cat([w0[None], snaps]))


def tgv_error(cfg: VortexConfig, res: VortexResult):
    """L2/max error vs the analytic TGV decay (tgv.jl:129-139), evaluated
    at the time actually integrated, nt*dt — when dt does not divide
    t_final evenly, comparing at t_final would charge the solver a
    spurious decay mismatch that is not a discretization error."""
    X, Y = _unique_nodes(cfg, res.w.dtype, res.w.device)
    ue = tgv_exact(X, Y, cfg.nt * cfg.dt, cfg.re, cfg.tgv_n)
    err = res.w - ue
    return torch.sqrt(torch.mean(err**2)), torch.max(torch.abs(err))
