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
`solve` runs; on a CUDA device its stage math is three kernels,
csrc/vortex_stage.cu); `make_spectral_step` is the same scheme on the full
(nx, ny) spectrum.  All transforms are torch.fft (cuFFT on a CUDA device).
No ghost arrays — periodicity is torch.roll or the kernel's wrap;
snapshots stack on the device (the reference ifft's to write text
snapshots mid-loop, vm.jl:78-86).

PyTorch runs eagerly, so the wavenumber, Crank-Nicolson and Jacobian
constants are built once, on the device, when a step is made, and reused
by every step (the JAX package rebuilds them inside its traced step).

Mesh forms (`mesh=`, the JAX package's `mesh=`; one process a rank, each
running the same step on its part of the state, parallel/sharded.py): the
fdm vorticity and the full spectrum in 2D blocks, the half spectrum in row
slabs (kx split over all ranks).  Every 2D transform is the pencil form of
ops/spectral.py, the 3/2-rule pads and cuts each axis where it is whole,
and the physical Arakawa terms take their halos from the ring neighbours
(parallel/halo.py): kernel 1 on each rank's framed block for fdm, the
plain Jacobian on each row slab for hybrid.  nx and ny must divide over
the ranks.

Reference run config: 128^2, [0, 2pi]^2, Re=1000, dt=0.01, t=20 (vm);
TGV validation: 64^2, Re=10, dt=0.01, t=1 (tgv.jl:92-146).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import arakawa, cuda_kernels, fft_plans, spectral
from cfd_julia_torch.parallel import halo
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.parallel import transpose
from cfd_julia_torch.stepping import loop, ssprk3
from cfd_julia_torch.utils import checkpoint

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
    rhs_impl: str = "auto"   # the fdm Arakawa RHS and the spectral
                             # steps' stage passes: auto (kernels on a
                             # CUDA device, torch on the CPU) | kernel
                             # (csrc/arakawa_rhs.cu, csrc/vortex_stage.cu;
                             # CUDA only) | torch (ops.arakawa and the
                             # passes' plain twins, any device)

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

def _check_mesh_grid(nx: int, ny: int, mesh) -> None:
    """Raise unless the periodic grid divides over the mesh's ranks."""
    world = mesh_lib.world_size(mesh)
    if nx % world or ny % world:
        raise ValueError(f"a periodic {nx}x{ny} grid on a mesh needs nx and "
                         f"ny divisible by its {world} ranks")


def make_block_poisson(nx: int, ny: int, dx: float, dy: float, dtype,
                       device, mesh):
    """The fdm Poisson solve lap(psi) = f on 2D blocks: the block moves to
    its row slab, the pencil rfft2 / irfft2 solve runs, and psi moves
    back; the moves are planned here, once."""
    inner = spectral.make_fft_poisson_periodic(nx, ny, dx, dy, dtype, device,
                                               eigen="fdm", mesh=mesh)
    to_rows = transpose.block_to_rows(mesh, (nx, ny))
    to_block = transpose.rows_to_block(mesh, (nx, ny))
    return lambda f: transpose.move(inner(transpose.move(f, to_rows)),
                                    to_block)


def fdm_rhs(w, dx, dy, re, impl: str = "torch", poisson=None, mesh=None):
    """vm_rhs: psi from FFT Poisson (FDM eigenvalues), Arakawa + viscous
    Laplacian (Common.jl:132-182).  impl="kernel" runs the fused
    Jacobian+Laplacian CUDA kernel (ops.cuda_kernels), "torch" its plain
    twin ops.arakawa.vorticity_rhs.  `poisson`: a solve built once by
    spectral.make_fft_poisson_periodic for w's grid; built for this call
    when not given.  w: (nx, ny), or (B, nx, ny) for a batch of members
    (one kernel launch for all); re: a float, or a tensor with one Re a
    member (ops.arakawa.members), which may require grad.

    With a mesh: w is this rank's block, psi comes from the pencil solve
    (`make_block_poisson`, the `poisson` to pass), and the RHS is kernel 1
    (or its twin) on the block framed by one node from the ring neighbours
    (halo.make_distributed_vorticity_rhs), where the JAX package's mesh
    form runs its XLA RHS."""
    if impl not in ("kernel", "torch"):
        raise ValueError(f"unknown fdm rhs impl {impl!r} (kernel | torch)")
    if mesh is not None:
        if poisson is None:
            px, py = mesh.shape
            nx, ny = w.shape[-2] * px, w.shape[-1] * py
            poisson = make_block_poisson(nx, ny, dx, dy, w.dtype, w.device,
                                         mesh)
        s = poisson(-w)
        return halo.make_distributed_vorticity_rhs(mesh, dx, dy, re,
                                                   impl)(w, s)
    if poisson is None:
        s = spectral.fft_poisson_periodic(-w, dx, dy, eigen="fdm")
    else:
        s = poisson(-w)
    if impl == "kernel":
        return cuda_kernels.arakawa_rhs_fused(w, s, dx, dy, re)
    return arakawa.vorticity_rhs(w, s, dx, dy, re)


def make_fdm_rhs(cfg: VortexConfig, dtype=None, device="cuda", re=None,
                 mesh=None):
    """w (nx, ny), or (B, nx, ny), -> dw/dt on `device` for the fdm
    solver, with the Poisson eigenvalues built once and cfg.rhs_impl
    resolved against the device.  `re` overrides cfg.re: a float or a
    tensor on `device` of one Re a member (models/ensemble.py).  With a
    mesh: this rank's block of w -> its block of dw/dt (fdm_rhs), and a
    tensor re is every rank's alike, differentiable through
    halo.replicate."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    impl = precision.resolve_rhs_impl(cfg.rhs_impl, device)
    re = cfg.re if re is None else re
    if mesh is not None:
        _check_mesh_grid(cfg.nx, cfg.ny, mesh)
        poisson = make_block_poisson(cfg.nx, cfg.ny, cfg.dx, cfg.dy, dtype,
                                     device, mesh)
    else:
        poisson = spectral.make_fft_poisson_periodic(
            cfg.nx, cfg.ny, cfg.dx, cfg.dy, dtype, device, eigen="fdm")
    return lambda w: fdm_rhs(w, cfg.dx, cfg.dy, re, impl, poisson, mesh)


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


def jacobian_hybrid(wf, k2, dx, dy, mesh=None):
    """-J(w, psi) computed in physical space with the Arakawa scheme, psi
    from the spectrum (hybrid.jl:92-152).  With a mesh: wf is this rank's
    block and k2 the global (nx, ny) constant (_make_jacobian_hybrid_mesh,
    built for this call)."""
    if mesh is not None:
        return _make_jacobian_hybrid_mesh(k2, dx, dy, mesh)(wf)
    w = spectral.ifft2(wf).real
    s = spectral.ifft2(wf / k2).real
    return spectral.fft2(-arakawa.jacobian(w, s, dx, dy))


def _make_jacobian_hybrid_mesh(k2, dx, dy, mesh):
    """jacobian_hybrid on this rank's block, its moves planned here: w and
    psi come to row slabs by the pencil ifft2, J runs there with a ring
    halo over mesh.flat_line, and the fft2 takes it back to the block."""
    shape = tuple(k2.shape)
    k2 = k2[mesh_lib.block_slices(shape, mesh)]
    line = mesh_lib.flat_line(mesh)
    pencil = transpose.pencil(mesh, shape)
    to_cols = transpose.block_to_cols(mesh, shape)
    to_block = transpose.cols_to_block(mesh, shape)

    def jac(wf):
        z = transpose.move(torch.stack([wf, wf / k2]), to_cols)
        w, s = spectral.ifft2(z, pencil).real
        j = -halo.slab_jacobian(w, s, dx, dy, line)
        return transpose.move(spectral.fft2(j, pencil), to_block)

    return jac


def _deriv_spectra(wf, k2, kx, ky, block=None):
    """psi_x, w_y, psi_y, w_x spectra (pseudospectral_32_rule.jl:113-122).

    Unlike the reference, the *multiplicative* wavenumbers zero (a) the
    k=0 entry — the reference's eps=1e-6 guard there breaks exact Hermitian
    symmetry and injects O(eps) noise (the guard is only needed for the
    1/k^2 division, where k2 keeps it) — and (b) the Nyquist mode, whose
    first derivative is not representable as a Hermitian (real-field)
    spectrum; zeroing it is the standard pseudospectral convention.
    block: (rows, cols) slices of a rank's block of the global constants,
    where wf is that block."""
    nx_, ny_ = kx.shape[0], ky.shape[0]
    kx0 = kx.clone()
    kx0[0] = 0.0
    ky0 = ky.clone()
    ky0[0] = 0.0
    rows, cols = block or (slice(None), slice(None))
    # drop the Nyquist row/column entirely: its placement under the 3/2-rule
    # pad (one-sided negative block, pad_32) cannot be Hermitian
    wf = wf * _nyquist_mask(nx_, ny_, wf.device)[rows, cols]
    ikx = 1j * kx0[rows, None]
    iky = 1j * ky0[None, cols]
    k2 = k2[rows, cols]
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


def jacobian_ps32(wf, k2, kx, ky, nx, ny, mesh=None):
    """Pseudospectral Jacobian, 3/2-rule zero-padding dealiasing
    (pseudospectral_32_rule.jl:95-177): jf = fft(psi_x w_y - psi_y w_x)
    evaluated on the 1.5x grid, truncated back.

    Deviation: the truncated spectrum's Nyquist row/column are zeroed.
    The reference's truncation keeps the fine grid's -n/2 modes without
    their +n/2 partners (truncate_32's one-sided negative block), leaving
    non-Hermitian content on the coarse Nyquist line — unrepresentable for
    a real field and inert anyway (_deriv_spectra masks it before every
    jacobian).  Zeroing it keeps the state exactly Hermitian so the
    half-spectrum path computes the same step.  With a mesh: wf is this
    rank's block and k2, kx, ky the global constants
    (_make_jacobian_ps32_mesh, built for this call)."""
    if mesh is not None:
        return _make_jacobian_ps32_mesh(k2, kx, ky, mesh)(wf)
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    scale = (nxe * nye) / (nx * ny)
    specs = torch.stack(_deriv_spectra(wf, k2, kx, ky))
    j1, j2, j3, j4 = spectral.ifft2(
        spectral.pad_32(specs, nxe, nye) * scale).real
    jacpf = spectral.fft2(j1 * j2 - j3 * j4)
    return (spectral.truncate_32(jacpf, nx, ny) / scale) \
        * _nyquist_mask(nx, ny, wf.device)


def _make_jacobian_ps32_mesh(k2, kx, ky, mesh):
    """jacobian_ps32 on this rank's block, its moves planned here: each
    axis of the 3/2 grid is padded and cut where it is whole: the ky pad
    on the row slab, the kx pad on the column slab, the transforms of the
    padded grid as pencils, the kx cut on the column slab, the ky cut on
    the row slab."""
    nx, ny = k2.shape
    nxe, nye = 3 * nx // 2, 3 * ny // 2
    hx, hy = nx // 2, ny // 2
    scale = (nxe * nye) / (nx * ny)
    block = mesh_lib.block_slices((nx, ny), mesh)
    nyq = _nyquist_mask(nx, ny, k2.device)[block]
    to_rows = transpose.block_to_rows(mesh, (nx, ny))
    wide = transpose.pencil(mesh, (nx, nye))
    fine = transpose.pencil(mesh, (nxe, nye))
    to_block = transpose.rows_to_block(mesh, (nx, ny))

    def jac(wf):
        specs = transpose.move(
            torch.stack(_deriv_spectra(wf, k2, kx, ky, block)), to_rows)
        zc = specs.new_zeros((*specs.shape[:-1], nye - ny))
        specs = torch.cat([specs[..., :hy], zc, specs[..., hy:]], dim=-1)
        specs = transpose.move(specs, wide.to_cols)
        specs = spectral._pad_rows_32(specs, nx, nxe) * scale
        j1, j2, j3, j4 = spectral.ifft2(specs, fine).real
        jacpf = spectral.fft2(j1 * j2 - j3 * j4, fine)
        jacpf = torch.cat([jacpf[..., :hx, :], jacpf[..., nxe - hx:, :]],
                          dim=-2)
        jacpf = transpose.move(jacpf, wide.to_rows)
        jacpf = torch.cat([jacpf[..., :hy], jacpf[..., nye - hy:]], dim=-1)
        jacpf = transpose.move(jacpf, to_block)
        return (jacpf / scale) * nyq

    return jac


def jacobian_ps23(wf, k2, kx, ky, nx, ny, mesh=None):
    """Pseudospectral Jacobian, 2/3-rule truncation
    (pseudospectral_23_rule.jl:93-144): derivative spectra are masked
    before the physical product; the product spectrum is NOT re-masked
    (reference behaviour).  The band is spectral.dealias_mask_23's
    symmetric |k| < ne//2.  With a mesh: wf is this rank's block and k2,
    kx, ky the global constants (_make_jacobian_ps23_mesh, built for this
    call)."""
    if mesh is not None:
        return _make_jacobian_ps23_mesh(k2, kx, ky, mesh)(wf)
    mask = spectral.dealias_mask_23(nx, ny, wf.device)
    specs = torch.stack(_deriv_spectra(wf, k2, kx, ky)) * mask
    j1, j2, j3, j4 = spectral.ifft2(specs).real
    return spectral.fft2(j1 * j2 - j3 * j4)


def _make_jacobian_ps23_mesh(k2, kx, ky, mesh):
    """jacobian_ps23 on this rank's block, its moves planned here: the
    block goes to the column slab, the pencil ifft2 brings the four fields
    to row slabs, the fft2 their product back to the column slab, and
    that returns to the block."""
    shape = tuple(k2.shape)
    block = mesh_lib.block_slices(shape, mesh)
    mask = spectral.dealias_mask_23(*shape, k2.device)[block]
    pencil = transpose.pencil(mesh, shape)
    to_cols = transpose.block_to_cols(mesh, shape)
    to_block = transpose.cols_to_block(mesh, shape)

    def jac(wf):
        specs = torch.stack(_deriv_spectra(wf, k2, kx, ky, block)) * mask
        j1, j2, j3, j4 = spectral.ifft2(transpose.move(specs, to_cols),
                                        pencil).real
        return transpose.move(spectral.fft2(j1 * j2 - j3 * j4, pencil),
                              to_block)

    return jac


def make_spectral_step(cfg: VortexConfig, dtype=None, device="cuda",
                       mesh=None):
    """3-stage low-storage RK3/CN step over the full vorticity spectrum
    (hybrid.jl:34-69, identical stepper in ch. 21/22): wf (nx, ny) complex
    -> wf after dt.  With a mesh: this rank's block of wf -> its block
    after dt (the jacobians' mesh forms; the stage math on the block)."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    dt, re = cfg.dt, cfg.re
    k2, kx, ky = _step_consts(cfg, dtype, device)
    if mesh is not None:
        _check_mesh_grid(cfg.nx, cfg.ny, mesh)
    if cfg.solver == "hybrid":
        jac = (lambda wf: jacobian_hybrid(wf, k2, cfg.dx, cfg.dy)) \
            if mesh is None else _make_jacobian_hybrid_mesh(k2, cfg.dx,
                                                           cfg.dy, mesh)
    elif cfg.solver == "ps32":
        jac = (lambda wf: jacobian_ps32(wf, k2, kx, ky, cfg.nx, cfg.ny)) \
            if mesh is None else _make_jacobian_ps32_mesh(k2, kx, ky, mesh)
    elif cfg.solver == "ps23":
        jac = (lambda wf: jacobian_ps23(wf, k2, kx, ky, cfg.nx, cfg.ny)) \
            if mesh is None else _make_jacobian_ps23_mesh(k2, kx, ky, mesh)
    else:
        raise ValueError(f"solver {cfg.solver!r} has no spectral step")
    zero_mean_mode, k2_state = spectral.zero_mean_mode, k2
    if mesh is not None:
        # the k = (0, 0) mode is on the block at the mesh's origin
        block = mesh_lib.block_slices((cfg.nx, cfg.ny), mesh)
        keep = torch.ones_like(k2, dtype=torch.bool)
        keep[0, 0] = False
        keep, k2_state = keep[block], k2[block]
        zero_mean_mode = lambda e: torch.where(keep, e, 0)  # noqa: E731
    ds = [a * 0.5 * dt * k2_state / re for a in ALPHAS]

    def step(wf):
        jn = jac(wf)
        w1 = ((1.0 - ds[0]) / (1.0 + ds[0])) * wf + (
            GAMMAS[0] * dt * jn
        ) / (1.0 + ds[0])
        w1 = zero_mean_mode(w1)
        j1 = jac(w1)
        w2 = ((1.0 - ds[1]) / (1.0 + ds[1])) * w1 + (
            RHOS[1] * dt * jn + GAMMAS[1] * dt * j1
        ) / (1.0 + ds[1])
        w2 = zero_mean_mode(w2)
        j2 = jac(w2)
        wn = ((1.0 - ds[2]) / (1.0 + ds[2])) * w2 + (
            RHOS[2] * dt * j1 + GAMMAS[2] * dt * j2
        ) / (1.0 + ds[2])
        return zero_mean_mode(wn)

    return step


# ------------------------------------------- half-spectrum path
#
# The state is the rfft2 HALF spectrum H (nx, ny//2+1) of the real
# vorticity — half the memory traffic of the full spectrum for every
# elementwise op in the step.  The four derivative spectra (psi_x, w_y,
# psi_y, w_x) are CONSTANT real multiples of i*H, so a stage builds them
# in one pass (vortex_derivs_half), takes them to physical space with one
# batched irfft2, forms the product in one pass (vortex_product) and
# brings the real Jacobian back with one rfft2, whose output *is* the
# state's layout; one more pass (vortex_cn_combine) updates the state.
# FFT work: 2.5 c2c-equivalents a stage.

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


def _band_23_half(cfg: VortexConfig, device=None):
    """(rows (nx,), columns (ny//2+1,)) kept by the 2/3 rule on the half
    grid: the symmetric row band, and the columns iy < nye//2 only."""
    nxe, nye = (2 * cfg.nx) // 3, (2 * cfg.ny) // 3
    ix = torch.arange(cfg.nx, device=device)
    iy = torch.arange(cfg.ny // 2 + 1, device=device)
    return (ix < nxe // 2) | (ix > cfg.nx - nxe // 2), iy < nye // 2


def _band_mask_23_half(cfg: VortexConfig, device=None):
    """spectral.dealias_mask_23 on the half grid (_band_23_half)."""
    keep_x, keep_y = _band_23_half(cfg, device)
    return keep_x[:, None] & keep_y[None, :]


def _deriv_tables(cfg: VortexConfig, dtype, device, band: bool = False,
                  eps: float = 1e-6):
    """(rowk (nx, 3), colk (ny//2+1, 3)): the row vectors (kx, kx0, rm) and
    the column vectors (ky, kyg, cm) from which the derivative pass
    (ops.cuda_kernels.vortex_derivs_half) builds its g = kx0/k2, ky,
    ky/k2, kx0 times rm cm, k2 = kx^2 + kyg^2: _half_consts's wavenumbers
    (kx and kyg eps-guarded, kx0 with k = 0 zeroed) and the Nyquist masks
    as 0/1, with `band` also _band_23_half's.  The JAX package holds
    the same four g as two packed Hermitian pairs
    (`_packed_jacobian_consts_traced`)."""
    nx, ny = cfg.nx, cfg.ny
    hy = ny // 2 + 1
    kx = _kvec(nx, cfg.dx, dtype, device, eps)
    kx0 = kx.clone()
    kx0[0] = 0.0
    ky = (2.0 * math.pi / (ny * cfg.dy)) * \
        torch.arange(hy, device=device).to(dtype)
    kyg = ky.clone()
    kyg[0] = eps
    ix = torch.arange(nx, device=device)
    iy = torch.arange(hy, device=device)
    rm = (ix != nx // 2) | (nx % 2 == 1)
    cm = (iy != ny // 2) | (ny % 2 == 1)
    if band:
        keep_x, keep_y = _band_23_half(cfg, device)
        rm, cm = rm & keep_x, cm & keep_y
    return (torch.stack([kx, kx0, rm.to(dtype)], 1),
            torch.stack([ky, kyg, cm.to(dtype)], 1))


def _truncate_32_half_slab(h_e, nx: int, ny: int, cols):
    """spectral.truncate_32_half on the column slab of the (nxe, nye//2+1)
    half spectrum, whose global column indices are `cols` ((1, t)): the kx
    cut of every column, and column ny/2 the conjugate of its kx mirror,
    as truncate_32_half builds the coarse Nyquist column.  The columns
    past ny/2 are cut by the caller on the row slab."""
    nxe = h_e.shape[-2]
    hx, hy = nx // 2, ny // 2

    def cut(a):
        return torch.cat([a[..., :hx, :], a[..., nxe - hx:, :]], dim=-2)

    mirror = torch.conj(torch.cat(
        [h_e[..., :1, :], torch.flip(h_e[..., 1:, :], (-2,))], dim=-2))
    return torch.where(cols == hy, cut(mirror), cut(h_e))


def make_spectral_step_half(cfg: VortexConfig, dtype=None, device="cuda",
                            mesh=None):
    """3-stage RK3/CN step over the rfft2 half spectrum: H (nx, ny//2+1)
    complex -> H after dt.

    The same operations as make_spectral_step on the representation with
    the Hermitian redundancy removed; tests/test_torch_vortex.py holds the
    two together and both against the JAX package.  The stage math is
    three passes of ops.cuda_kernels: vortex_derivs_half (the four
    derivative spectra from H), vortex_product (the physical Jacobian) and
    vortex_cn_combine (a stage's update); cfg.rhs_impl picks their CUDA
    kernels ("kernel", and "auto" on a CUDA device) or their plain twins
    ("torch", and "auto" on the CPU).  ps23 on one device inverts its 2/3
    band's columns alone.

    On one device with the kernels, ps23 and ps32 run their inverse
    transforms on the port's own cuFFT plans (ops/fft_plans.HalfInverse,
    made here with their buffers): the derivative pass writes the spectra
    into the plans' layout, ps32's 3/2 pad included, and ps32's Jacobian
    comes back through the truncation pass (vortex_truncate_32) in H's
    memory order, so no copy lies between the passes and the transforms.
    With the twins the inverse is torch.fft's (spectral.irfft2_band;
    pad_32_half, irfft2, truncate_32_half).

    With a mesh: H is this rank's row slab (kx split over all ranks, the
    JAX package's packed_half_sharding) and the constants are the rank's
    row slabs of the single-device ones.  A Jacobian moves its spectra to
    column slabs, the pencil irfft2 brings the fields to row slabs, the
    pencil rfft2 their product back, and that returns to the row slab;
    the moves are planned here, once."""
    dtype = dtype or precision.default_dtype()
    device = precision.resolve_device(device)
    kernels = precision.resolve_rhs_impl(cfg.rhs_impl, device) == "kernel"
    if kernels:
        derivs, product, combine = (cuda_kernels.vortex_derivs_half,
                                    cuda_kernels.vortex_product,
                                    cuda_kernels.vortex_cn_combine)
    else:
        derivs, product, combine = (cuda_kernels.vortex_derivs_half_plain,
                                    cuda_kernels.vortex_product_plain,
                                    cuda_kernels.vortex_cn_combine_plain)
    # the inverse on the port's cuFFT plans (ps23, ps32 on one device)
    planned = kernels and mesh is None and cfg.solver in ("ps23", "ps32")
    nx, ny = cfg.nx, cfg.ny
    hy = ny // 2 + 1
    rows = slice(None)
    if mesh is not None:
        _check_mesh_grid(nx, ny, mesh)
        rows, _ = mesh_lib.slab_slices((nx, hy), mesh, -2)
    _, _, k2h, nyq = _half_consts(cfg, dtype, device)
    # each stage's (a, b, r), stage 1 without r, in the memory orders the
    # spectra come in (_is_kx_major): row by row, and column by column from
    # the first use
    cn = {False: [(a, b, None if s == 0 else r) for s, (a, b, r) in
                  enumerate(tuple(c[rows] for c in stage)
                            for stage in _cn_consts(cfg, k2h))]}

    if mesh is None:
        def inverse(h):
            return spectral.irfft2(h, nx, ny)

        forward = spectral.rfft2

        def physical_jacobian(w, s):
            return arakawa.jacobian(w, s, cfg.dx, cfg.dy)
    else:
        half = transpose.pencil(mesh, (nx, hy))

        def inverse(h):
            """Row slab of a half spectrum -> row slab of its field."""
            return spectral.irfft2(transpose.move(h, half.to_cols), nx, ny,
                                   half)

        def forward(phys):
            """Row slab of a real field -> row slab of its half spectrum."""
            return transpose.move(spectral.rfft2(phys, half), half.to_rows)

        if cfg.solver == "hybrid":
            line = mesh_lib.flat_line(mesh)

            def physical_jacobian(w, s):
                return halo.slab_jacobian(w, s, cfg.dx, cfg.dy, line)

    if cfg.solver == "hybrid":
        inv_k2h = (1.0 / k2h)[rows]

        def jac(H):
            w, s = inverse(torch.stack([H, H * inv_k2h]))
            return forward(-physical_jacobian(w, s))
    elif cfg.solver == "ps23":
        rowk, colk = _deriv_tables(cfg, dtype, device, band=True)
        rowk = rowk[rows]
        if mesh is None:
            # the 2/3 band keeps the columns iy < nye//2 alone, and the
            # inverse's 1/(nx ny) is folded into g
            nb, scale = ((2 * ny) // 3) // 2, 1.0 / (nx * ny)

            def band_inverse(h):
                return spectral.irfft2_band(h, nx, ny, norm="forward")
        else:
            nb, scale, band_inverse = hy, 1.0, inverse

        if planned:
            # ky fastest, rows padded to an aligned pitch: at 2048^2 the
            # strided kx transform and the contiguous c2r beat the other
            # layout (chip_smoke.py phase 2 times both)
            inv = fft_plans.HalfInverse(4, nx, ny, nb, dtype, device,
                                        ky_fastest=True)
            pitch = inv.buffer.shape[-1]

            def jac(H):
                return forward(product(inv(derivs(
                    H, rowk, colk, nb, scale, cols=pitch, ky_fastest=True,
                    out=_buffer_for(inv, H)))))
        else:
            def jac(H):
                return forward(product(band_inverse(derivs(H, rowk, colk, nb,
                                                           scale))))
    elif cfg.solver == "ps32":
        nxe, nye = 3 * nx // 2, 3 * ny // 2
        scale = (nxe * nye) / (nx * ny)
        # the Parseval rescale of the padded spectra is folded into g (on
        # one device with the inverse's 1/(nxe nye)), and the one of the
        # truncated product into the Nyquist zeroing (see jacobian_ps32)
        rowk, colk = _deriv_tables(cfg, dtype, device)
        rowk = rowk[rows]
        nyq_over_scale = (nyq / scale)[rows]
        if planned:
            hye = nye // 2 + 1
            # kx fastest: at 3072^2 the contiguous kx transform and the
            # strided c2r beat the other layout (chip_smoke.py phase 2)
            inv = fft_plans.HalfInverse(4, nxe, nye, ny // 2, dtype, device)
            # the table in each memory order H may come in (_is_kx_major):
            # the truncation writes the Jacobian in the table's
            tables = {kx: _in_order(nyq_over_scale, kx)
                      for kx in (False, True)}

            def jac(H):
                p = derivs(H, rowk, colk, ny // 2, scale / (nxe * nye),
                           cols=hye, pad_rows=nxe - nx,
                           out=_buffer_for(inv, H))
                jf = spectral.rfft2(product(inv(p)))
                return cuda_kernels.vortex_truncate_32(
                    jf, tables[_is_kx_major(H)])
        elif mesh is None:
            def jac(H):
                pads = spectral.pad_32_half(
                    derivs(H, rowk, colk, hy, scale / (nxe * nye)), ny, nxe,
                    nye)
                jf = spectral.rfft2(product(spectral.irfft2(
                    pads, nxe, nye, norm="forward")))
                return spectral.truncate_32_half(jf, nx, ny) * nyq_over_scale
        else:
            hye = nye // 2 + 1
            wide = transpose.pencil(mesh, (nx, hye))
            fine = transpose.pencil(mesh, (nxe, hye))
            _, cols = mesh_lib.slab_slices((nxe, hye), mesh, -1)
            cols = torch.arange(cols.start, cols.stop, device=device)[None, :]

            def jac(H):
                # pad_32_half: the ky pad here, where ky is whole, the kx
                # pad on the column slab
                p = derivs(H, rowk, colk, hy, scale)
                p = torch.cat([p[..., :ny // 2],
                               p.new_zeros((*p.shape[:-1], hye - ny // 2))],
                              -1)
                p = transpose.move(p, wide.to_cols)
                p = spectral._pad_rows_32(p, nx, nxe)
                jf = spectral.rfft2(product(spectral.irfft2(p, nxe, nye,
                                                            fine)), fine)
                jf = _truncate_32_half_slab(jf, nx, ny, cols)
                jf = transpose.move(jf, wide.to_rows)[..., :hy]
                return jf * nyq_over_scale
    else:
        raise ValueError(f"solver {cfg.solver!r} has no spectral step")

    def update(stage, H, j0, j1):
        """The stage's CN update a H + r j0 + b j1 (stage 0: a H + b j1),
        every operand in the memory order of j1, the new Jacobian: a copy
        of H or j0 only where theirs differs (the twins' truncated ps32
        Jacobian against rfft2's state; the truncation pass writes H's)."""
        kx = _is_kx_major(j1)
        if kx not in cn:
            cn[kx] = [tuple(None if t is None else _in_order(t, kx)
                            for t in tabs) for tabs in cn[False]]
        a, b, r = cn[kx][stage]
        H, j1 = _in_order(H, kx), _in_order(j1, kx)
        return combine(a, H, r, None if j0 is None else _in_order(j0, kx),
                       b, j1)

    def step(H):
        H = _in_order(H, _is_kx_major(H))
        jn = jac(H)
        H1 = update(0, H, None, jn)
        j1 = jac(H1)
        H2 = update(1, H1, jn, j1)
        j2 = jac(H2)
        return update(2, H2, j1, j2)

    return step


def _buffer_for(inv, H):
    """The derivative pass's buffer: the inverse's own, or a new one where
    autograd tracks H (the passes' Functions write new tensors)."""
    return None if torch.is_grad_enabled() and H.requires_grad \
        else inv.buffer


def _is_kx_major(t) -> bool:
    """A 2-D spectrum stored column by column (strides (1, rows): what
    torch.fft.rfft2 returns on the GPU), not row by row."""
    return not t.is_contiguous() and t.mT.is_contiguous()


def _in_order(t, kx_major: bool):
    """t stored column by column (kx_major) or row by row: t itself, or a
    copy."""
    if kx_major:
        return t if t.mT.is_contiguous() else t.mT.contiguous().mT
    return t.contiguous()


def half_init(w0, mesh=None):
    """rfft2 half-spectrum state with the mean mode projected out.  With a
    mesh: w0 is this rank's row slab of the vorticity (nx divides over the
    ranks) and the result its row slab of the half spectrum."""
    if mesh is None:
        return spectral.zero_mean_mode(spectral.rfft2(w0))
    nx, ny = w0.shape[-2] * mesh_lib.world_size(mesh), w0.shape[-1]
    half = transpose.pencil(mesh, (nx, ny // 2 + 1))
    h = transpose.move(spectral.rfft2(w0, half), half.to_rows)
    # the mean mode is row 0 of the first slab, rank 0's
    return spectral.zero_mean_mode(h) if mesh.get_rank() == 0 else h


def half_decode(H, nx: int, ny: int, mesh=None):
    """Real vorticity (nx, ny) from the half spectrum.  With a mesh: the
    rank's row slab of H -> its row slab of the vorticity."""
    if mesh is None:
        return spectral.irfft2(H, nx, ny)
    half = transpose.pencil(mesh, (nx, ny // 2 + 1))
    return spectral.irfft2(transpose.move(H, half.to_cols), nx, ny, half)


# -------------------------------------------------------------- the solve

def make_step(cfg: VortexConfig, dtype=None, device="cuda"):
    """The step `solve` runs for cfg.solver: SSP-RK3 over the fdm RHS on
    the vorticity field, or the half-spectrum RK3/CN step."""
    if cfg.solver == "fdm":
        rhs = make_fdm_rhs(cfg, dtype, device)
        return lambda w: ssprk3.ssprk3_step(rhs, w, cfg.dt)
    return make_spectral_step_half(cfg, dtype, device)


def solve(cfg: VortexConfig, dtype=None, device="cuda",
          checkpoint_every: int = 0, checkpoint_path: str | None = None,
          resume: bool = False) -> VortexResult:
    """Integrate nt steps collecting cfg.ns snapshots (vm.jl:60-88); every
    tensor of the result stays on `device`.

    checkpoint_every/checkpoint_path/resume: resumable checkpoints (the
    state, the snapshots so far, the absolute step count), the cadence
    rounded up to the snapshot interval; a resumed run reproduces the
    uninterrupted one bit for bit, snapshots included."""
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

    if not (checkpoint_every or resume):
        state, snaps = loop.run_steps_with_snapshots(
            step, state0, cfg.nt, every, observe=observe)
        return VortexResult(x=x, y=y, w=decode(state),
                            snapshots=torch.cat([w0[None], snaps]))

    if not checkpoint_path:
        raise ValueError("checkpointing requires checkpoint_path")
    n_chunks = cfg.nt // every
    state, done, parts = state0, 0, []
    if resume and checkpoint.exists(checkpoint_path):
        # the checkpoint records the ABSOLUTE step count, so a resume under
        # another snapshot cadence or a shorter run is refused, not
        # misread as a chunk count
        (state, prev), step_ct = checkpoint.load_state(
            checkpoint_path, (state0, w0.new_empty((0, *w0.shape))))
        if step_ct is None:
            raise ValueError(f"checkpoint {checkpoint_path} has no step "
                             "record")
        if step_ct % every:
            raise ValueError(
                f"checkpoint at step {step_ct} is incompatible with the "
                f"current snapshot interval {every} (= nt//ns — snapshot "
                f"times would not line up); rerun with the original "
                f"nt/ns or restart without --resume")
        if step_ct > cfg.nt:
            raise ValueError(
                f"checkpoint at step {step_ct} is beyond this run's "
                f"nt={cfg.nt}; restart without --resume")
        done = step_ct // every
        if prev.shape[0] != done:
            raise ValueError(
                f"checkpoint snapshot count {prev.shape[0]} does not "
                f"match its step count {step_ct} at interval {every}")
        parts = [prev]
    per_ckpt = max(1, -(-checkpoint_every // every)) if checkpoint_every \
        else n_chunks
    while done < n_chunks:
        # the snapshot intervals up to the next checkpoint
        k = min(per_ckpt - done % per_ckpt, n_chunks - done)
        state, snaps = loop.run_steps_with_snapshots(
            step, state, k * every, every, observe=observe)
        parts.append(snaps)
        done += k
        checkpoint.save_state(checkpoint_path, (state, torch.cat(parts)),
                              step=done * every)
    rem = cfg.nt - n_chunks * every
    if rem:
        state = loop.advance(step, state, rem)
    return VortexResult(x=x, y=y, w=decode(state),
                        snapshots=torch.cat([w0[None], *parts]))


def tgv_error(cfg: VortexConfig, res: VortexResult):
    """L2/max error vs the analytic TGV decay (tgv.jl:129-139), evaluated
    at the time actually integrated, nt*dt — when dt does not divide
    t_final evenly, comparing at t_final would charge the solver a
    spurious decay mismatch that is not a discretization error."""
    X, Y = _unique_nodes(cfg, res.w.dtype, res.w.device)
    ue = tgv_exact(X, Y, cfg.nt * cfg.dt, cfg.re, cfg.tgv_n)
    err = res.w - ue
    return torch.sqrt(torch.mean(err**2)), torch.max(torch.abs(err))
