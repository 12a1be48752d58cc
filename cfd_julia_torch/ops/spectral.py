"""Spectral primitives: FFT Poisson eigenvalue solves, DST-I (fast sine
transform), wavenumber arrays, dealiasing masks (counterpart of
cfd_julia_tpu/ops/spectral.py).

Every transform is `torch.fft` (cuFFT on a CUDA device); there is no
hand-written kernel here, as the JAX package has none either.

* torch.fft has no real-to-real transforms, so DST-I (FFTW RODFT00, used by
  the reference for Dirichlet Poisson and the cavity solver, fft_d.jl:13,
  lid_driven_cavity.jl:11-21) is built from an odd extension + rfft:
  for v of length m, the odd extension y = [0, v, 0, -reverse(v)] of length
  2(m+1) satisfies FFT(y)_k = -i * DST1(v)_k, so DST1(v) = -Im rfft(y)[1:m+1].
  DST-I is its own inverse up to the factor 2(m+1).
* Periodic Poisson eigenvalue solves follow fps (Common.jl:97-125) /
  ps_fft (fft_p.jl:8-42) / ps_spectral (fft_s.jl:8-37): forward FFT of the
  source, divide by (FDM or spectral) eigenvalues, zero the mean mode,
  inverse FFT.
* Two real fields come back from their half spectra through `irfft2`
  (always with the physical size given: an odd last axis is not recoverable
  from the half width), where the JAX package packs a Hermitian pair into
  one complex inverse.

Tensors are real or complex of one precision; wavenumber constants are
built in fp64 with numpy and cast, so their fp32 values are the JAX
package's bit for bit.

Mesh forms (each rank runs the same call on its own slab): the pencil
decomposition of the JAX package's `_constrain` / `_pencil_specs` pairs.
Each 1D transform runs where its axis is whole, and parallel/transpose.py
moves the field between a row slab (rows split over all ranks,
P(flat, None)) and a column slab (P(None, flat)) in between.  The
transforms take a `pencil` (transpose.pencil of the mesh and the field's
global shape, built once by the caller, as its moves depend only on
those): the forward transforms (fft2, rfft2, dst1_2d) take a row slab and
return a column slab; the inverses (ifft2, irfft2, idst1_2d) take a
column slab and return a row slab.  The solves take `mesh=` and map row
slabs to row slabs, their pencils and constants built with them.  No
pencil or mesh is the single-device code, unchanged.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cfd_julia_torch.core import precision
from cfd_julia_torch.parallel import mesh as mesh_lib
from cfd_julia_torch.parallel import transpose

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# ------------------------------------------------------------- transforms

def _global_shape(shape):
    """The (n, m) a one-off mesh solve needs: a slab does not carry it."""
    if shape is None:
        raise ValueError("with a mesh, give the field's global shape: a "
                         "rank's slab does not carry it")
    return tuple(shape)[-2:]


def fft2(x, pencil=None):
    """2D FFT over the last two axes.  With a pencil: x is the row slab of
    the pencil's global field and the result its column slab (fft along
    y, the transpose, fft along x)."""
    if pencil is None:
        return torch.fft.fft2(x)
    x = transpose.move(torch.fft.fft(x, dim=-1), pencil.to_cols)
    return torch.fft.fft(x, dim=-2)


def ifft2(x, pencil=None):
    """Inverse 2D FFT.  With a pencil: x is the column slab of the
    pencil's global field and the result its row slab."""
    if pencil is None:
        return torch.fft.ifft2(x)
    x = transpose.move(torch.fft.ifft(x, dim=-2), pencil.to_rows)
    return torch.fft.ifft(x, dim=-1)


def rfft2(x, pencil=None):
    """Half spectrum (.., nx, ny//2+1) of a real field (.., nx, ny).  With a
    pencil of the half spectrum's global (nx, ny//2+1): x is the row slab
    of the real field and the result the column slab of its half spectrum
    (rfft along the local y, the transpose, a complex fft along x)."""
    if pencil is None:
        return torch.fft.rfft2(x)
    h = transpose.move(torch.fft.rfft(x, dim=-1), pencil.to_cols)
    return torch.fft.fft(h, dim=-2)


def irfft2(h, nx: int, ny: int, pencil=None, norm: str = "backward"):
    """Real field (.., nx, ny) from its half spectrum (.., nx, ny//2+1).
    The c2r transform along the last axis ignores the imaginary part of
    the ky = 0 column and, for even ny, of the Nyquist column.  norm:
    torch.fft's ("forward" leaves out the 1/(nx ny), for a caller that
    has folded it into the spectrum).  With a pencil of the half spectrum:
    h is its column slab and the result the row slab of the field (ifft
    along kx where kx is whole, the transpose, c2r along ky where ky is
    whole)."""
    if pencil is None:
        return torch.fft.irfft2(h, s=(nx, ny), norm=norm)
    h = transpose.move(torch.fft.ifft(h, dim=-2, norm=norm), pencil.to_rows)
    return torch.fft.irfft(h, n=ny, dim=-1, norm=norm)


def irfft2_band(h, nx: int, ny: int, norm: str = "backward"):
    """Real field (.., nx, ny) from the first nb columns h (.., nx, nb) of
    a half spectrum whose columns nb..ny//2 are zero (ps23's 2/3 band): the
    kx transform of the nb columns alone, then the c2r transform along ky,
    which zero-pads its input to ny//2+1 columns; irfft2 of the padded
    spectrum (the JAX package's rowsfirst inverse with active_cols,
    cfd_julia_tpu/ops/spectral.py:102).  norm as irfft2's.  On the GPU the
    kx transform reads h without a copy when h is stored column by column
    (each (nx, nb) plane's kx contiguous)."""
    return torch.fft.irfft(torch.fft.ifft(h, n=nx, dim=-2, norm=norm), n=ny,
                           dim=-1, norm=norm)


def complex_for(real_dtype):
    return precision.complex_dtype(real_dtype)


def zero_mean_mode(e):
    """A copy of `e` with the k=(0,0) Fourier mode zeroed."""
    out = e.clone()
    out[..., 0, 0] = 0
    return out


# ------------------------------------------------------------ wavenumbers

def fft_wavenumber_index(n: int, dx: float, dtype, device=None,
                         eps: float = 1e-6):
    """k_i = hx * [0, 1, .., n/2-1, -n/2, .., -1] with hx = 2 pi/(n dx) and
    the k_0 = eps guard (wavespace, Common.jl:184-204).  Built in fp64 with
    numpy, then cast to `dtype`."""
    hx = 2 * np.pi / (n * dx)
    i = np.arange(n)
    k = hx * np.where(i < n // 2, i, i - n)
    k[0] = eps
    return torch.as_tensor(k.astype(_NUMPY_DTYPE[dtype]), device=device)


def rfft_wavenumber_index(n: int, dx: float, dtype, device=None):
    """Half-axis wavenumbers k_j = hx * j, j = 0..n/2 (the rfft layout),
    with no eps guard — callers fold their own k=0 handling."""
    hx = 2 * np.pi / (n * dx)
    k = (hx * np.arange(n // 2 + 1)).astype(_NUMPY_DTYPE[dtype])
    return torch.as_tensor(k, device=device)


def wavespace(nx: int, ny: int, dx: float, dy: float, dtype, device=None,
              eps: float = 1e-6):
    """k^2 = kx_i^2 + ky_j^2 (Common.jl:184-204)."""
    kx = fft_wavenumber_index(nx, dx, dtype, device, eps)
    ky = fft_wavenumber_index(ny, dy, dtype, device, eps)
    return kx[:, None] ** 2 + ky[None, :] ** 2


# ------------------------------------------------------- periodic Poisson

def make_fft_poisson_periodic(nx: int, ny: int, dx: float, dy: float,
                              dtype, device=None, eigen: str = "fdm",
                              eps: float = 1e-6, mesh=None):
    """Build the periodic solve laplacian(u) = f on an nx x ny grid of
    unique nodes; returns solve(f) -> u.  The eigenvalue denominator is
    built here, once, on the rfft2 half grid: f is real, so the half
    spectrum carries the whole solve at half the transform work.  With a
    mesh, solve maps this rank's row slab of f to its row slab of u (the
    pencil rfft2 / irfft2; the denominator kept as the rank's column
    slab).

    eigen="fdm": second-order FDM eigenvalues aa + bb cos(kx) + cc cos(ky)
    with the *index-space* wavenumbers kx = 2 pi i / n (fft_p.jl:8-42,
    identical to fps Common.jl:97-125).
    eigen="spectral": exact eigenvalues -(kx^2 + ky^2) with physical
    wavenumbers (fft_s.jl:8-37).
    The mean mode is zeroed (solvability / gauge fixing)."""
    if eigen == "fdm":
        # index-space wavenumbers 2 pi i / n = fft_wavenumber_index at dx=1
        kx = fft_wavenumber_index(nx, 1.0, dtype, device, eps)
        ky = fft_wavenumber_index(ny, 1.0, dtype, device, eps)
        aa = -2.0 / dx**2 - 2.0 / dy**2
        bb = 2.0 / dx**2
        cc = 2.0 / dy**2
        den = aa + bb * torch.cos(kx)[:, None] + cc * torch.cos(ky)[None, :]
    elif eigen == "spectral":
        kx = fft_wavenumber_index(nx, dx, dtype, device, eps)
        ky = fft_wavenumber_index(ny, dy, dtype, device, eps)
        den = -(kx[:, None] ** 2) - ky[None, :] ** 2
    else:
        raise ValueError(f"unknown eigenvalue mode {eigen!r}")
    # Explicit mean-mode guard: the reference's eps trick keeps den[0,0]
    # nonzero only in fp64 (cos(1e-6) == 1.0 exactly in fp32, giving
    # 0/0 = NaN that the inverse transform spreads everywhere); e[0,0] is
    # zeroed, so den[0,0] is arbitrary — pin it to 1.  The zeroing is
    # folded into the reciprocal.
    den[0, 0] = 1.0
    inv_den = 1.0 / den
    inv_den[0, 0] = 0.0
    # The real part of the full complex inverse of e / den is the solve
    # with the mean of 1/den over k and -k.  The two differ only at odd
    # sizes with eigen="spectral", where the wavenumber rule i < n//2
    # gives index (n-1)/2 the frequency -(n+1)/2; the half grid keeps that
    # mean, so odd sizes solve as the JAX package does.
    mirror = torch.roll(torch.flip(inv_den, (0, 1)), (1, 1), (0, 1))
    inv_den = (0.5 * (inv_den + mirror))[:, : ny // 2 + 1].contiguous()
    if mesh is not None:
        inv_den = mesh_lib.place_slab(inv_den, mesh, -1)
        rows = mesh_lib.slab_extent(nx, mesh)
        half = transpose.pencil(mesh, (nx, ny // 2 + 1))

        def solve(f):
            if f.shape[-2:] != (rows, ny):
                raise ValueError(f"solve was built for row slabs {(rows, ny)}"
                                 f" of {(nx, ny)}, got {tuple(f.shape[-2:])}")
            return irfft2(rfft2(f, half) * inv_den, nx, ny, half)

        return solve

    def solve(f):
        if f.shape[-2:] != (nx, ny):
            raise ValueError(f"solve was built for {(nx, ny)}, got "
                             f"{tuple(f.shape[-2:])}")
        return irfft2(rfft2(f) * inv_den, nx, ny)

    return solve


def fft_poisson_periodic(f, dx: float, dy: float, eigen: str = "fdm",
                         eps: float = 1e-6, mesh=None, shape=None):
    """One-off form of make_fft_poisson_periodic (builds the eigenvalues
    for this call); f: (nx, ny) real, unique periodic nodes, or with a mesh
    the rank's row slab of a field of global `shape`."""
    nx, ny = (f.shape[-2], f.shape[-1]) if mesh is None \
        else _global_shape(shape)
    return make_fft_poisson_periodic(nx, ny, dx, dy, f.dtype, f.device,
                                     eigen, eps, mesh)(f)


# ----------------------------------------------------------------- DST-I

def dst1_half_weights(m: int, dtype, device=None):
    """sin(pi j / (m+1)), j = 1..m: the pre-processing weights of
    _dst1_half_last for a transform of length m."""
    n = m + 1
    jj = torch.arange(1, n, dtype=dtype, device=device)
    return torch.sin(math.pi * jj / n)


def _dst1_half_last(v, weights=None):
    """DST-I along the last axis via a length-(m+1) rfft — HALF the
    odd-extension transform length (FFTPACK RODFT00 pre/post processing,
    Swarztrauber 1982; verified to roundoff vs scipy.fft.dst type 1).

    With N = m+1:  y_0 = 0,
        y_j = sin(pi j/N) (x_j + x_{N-j}) + (x_j - x_{N-j})/2,  j=1..N-1
        Y = rfft(y)
        S_{2r}   = -Im Y_r                       (r = 1 .. m//2)
        S_{2r+1} = S_{2r-1} + Re Y_r,  S_1 = Re Y_0 / 2
                 = cumsum(Re Y)_r - Re Y_0 / 2   (r = 0 .. ceil(m/2)-1)

    Returns the UNSCALED sine sum S_k = sum_j x_j sin(pi j k / N); dst1
    doubles it for FFTW-RODFT00 parity.  `weights`: dst1_half_weights(m),
    built here when not given.  The cumulative sum's order of additions is
    the library's (a parallel scan on a CUDA device)."""
    m = v.shape[-1]
    s = dst1_half_weights(m, v.dtype, v.device) if weights is None \
        else weights
    b = torch.flip(v, (-1,))                     # x[N-j], j = 1..N-1
    y1 = s * (v + b) + 0.5 * (v - b)
    y = torch.cat([v.new_zeros(v.shape[:-1] + (1,)), y1], dim=-1)
    Y = torch.fft.rfft(y, dim=-1)                # (..., N//2+1)
    re, im = Y.real, Y.imag
    odd = torch.cumsum(re, dim=-1) - 0.5 * re[..., :1]   # k = 1, 3, 5, ...
    n_odd = (m + 1) // 2
    n_even = m // 2
    odd = odd[..., :n_odd]
    even = -im[..., 1 : n_even + 1]                      # k = 2, 4, 6, ...
    if n_even < n_odd:   # pad so the interleave stays a pure reshape
        even = torch.cat(
            [even, v.new_zeros(v.shape[:-1] + (n_odd - n_even,))], dim=-1)
    inter = torch.stack([odd, even], dim=-1).reshape(
        v.shape[:-1] + (2 * n_odd,))
    return inter[..., :m]


def dst1(v, axis: int = -1, impl: str = "rfft", weights=None, mesh=None):
    """DST-I along `axis`: X_k = 2 sum_j v_j sin(pi (j+1)(k+1) / (m+1)),
    matching FFTW's unnormalized RODFT00 on m interior points.

    impl="rfft": odd extension + rfft.
    impl="half": length-(m+1) rfft + pre/post passes (_dst1_half_last) —
    half the transform length of the odd extension; `weights` are its
    dst1_half_weights, for a caller that transforms many times.

    With a mesh, v is this rank's slab in which `axis` is whole: a row
    slab for axis -1, a column slab for axis -2 (the layout the JAX
    package's pencil constraint gives the transform), and the result keeps
    it.  The rows are independent, so the transform is the rank's own and
    the slab's zero padding stays zero."""
    if impl not in ("rfft", "half"):
        # a typo'd variant name must never silently run (and get
        # benchmarked as) the default odd-extension path
        raise ValueError(f"unknown DST impl {impl!r} (rfft | half)")
    if mesh is not None and axis not in (-1, -2, v.dim() - 1, v.dim() - 2):
        raise ValueError(f"dst1 with a mesh transforms one of a slab's two "
                         f"axes, -2 or -1; got axis {axis}")
    v = torch.movedim(v, axis, -1)
    m = v.shape[-1]
    if impl == "half":
        X = 2.0 * _dst1_half_last(v, weights)
    else:
        z = v.new_zeros(v.shape[:-1] + (1,))
        y = torch.cat([z, v, z, -torch.flip(v, (-1,))], dim=-1)  # 2(m+1)
        X = -torch.fft.rfft(y, dim=-1).imag[..., 1 : m + 1]
    return torch.movedim(X, -1, axis)


def dst1_2d(v, impl: str = "rfft", pencil=None):
    """2D DST-I over the last two axes (= FFTW.r2r(..., RODFT00)).  With a
    pencil: v is the row slab of the pencil's global field and the result
    its column slab."""
    if pencil is None:
        return dst1(dst1(v, axis=-1, impl=impl), axis=-2, impl=impl)
    v = transpose.move(dst1(v, -1, impl), pencil.to_cols)
    return dst1(v, -2, impl)


def idst1_2d(v, norm_nx: int, norm_ny: int, impl: str = "rfft",
             pencil=None):
    """Inverse 2D DST-I with the reference normalization /(2 nx * 2 ny)
    (fft_d.jl:22): the forward pair applied twice scales by 4 nx ny.  With
    a pencil: v is the column slab of the pencil's global field and the
    result its row slab (the x transform first: the axes commute)."""
    if pencil is None:
        return dst1_2d(v, impl) / (4.0 * norm_nx * norm_ny)
    v = transpose.move(dst1(v, -2, impl), pencil.to_rows)
    return dst1(v, -1, impl) / (4.0 * norm_nx * norm_ny)


def make_fst_poisson_dirichlet(mx: int, my: int, dx: float, dy: float,
                               dtype, device=None, impl: str = "rfft",
                               mesh=None):
    """Build the homogeneous-Dirichlet solve laplacian(u) = f on the
    (mx, my) interior nodes of an (mx+2, my+2) grid via DST-I; returns
    solve(f_interior) -> u_interior.  The eigenvalues of the DST
    diagonalization of the 5-point Laplacian (fft_d.jl:7-23), and the half
    transform's weights, are built here, once.  With a mesh, solve maps
    this rank's row slab of f to its row slab of u: the y transforms on
    the row slab, the x transforms and the division on the column slab."""
    if impl not in ("rfft", "half"):
        raise ValueError(f"unknown DST impl {impl!r} (rfft | half)")
    nx, ny = mx + 1, my + 1
    i = torch.arange(1, nx, dtype=dtype, device=device)
    j = torch.arange(1, ny, dtype=dtype, device=device)
    den = (2.0 / dx**2) * (torch.cos(math.pi * i / nx) - 1.0)[:, None] + (
        2.0 / dy**2
    ) * (torch.cos(math.pi * j / ny) - 1.0)[None, :]
    wx = wy = None
    if impl == "half":
        wx = dst1_half_weights(mx, dtype, device)
        wy = dst1_half_weights(my, dtype, device)

    if mesh is not None:
        den = mesh_lib.place_slab(den, mesh, -1, 1.0)
        rows = mesh_lib.slab_extent(mx, mesh)
        moves = transpose.pencil(mesh, (mx, my))

        def solve(f_interior):
            if f_interior.shape[-2:] != (rows, my):
                raise ValueError(f"solve was built for row slabs {(rows, my)}"
                                 f" of {(mx, my)} interior nodes, got "
                                 f"{tuple(f_interior.shape[-2:])}")
            e = dst1(f_interior, -1, impl, wy)
            e = dst1(transpose.move(e, moves.to_cols), -2, impl, wx)
            u = dst1(e / den, -2, impl, wx)
            u = dst1(transpose.move(u, moves.to_rows), -1, impl, wy)
            return u / (4.0 * nx * ny)

        return solve

    def solve(f_interior):
        if f_interior.shape[-2:] != (mx, my):
            raise ValueError(f"solve was built for {(mx, my)} interior "
                             f"nodes, got {tuple(f_interior.shape[-2:])}")
        # Transform order: rows, cols | divide | cols, rows, as the JAX
        # package (1D DSTs on different axes commute, so this equals
        # dst1_2d + idst1_2d)
        e = dst1(dst1(f_interior, -1, impl, wy), -2, impl, wx)
        u = dst1(dst1(e / den, -2, impl, wx), -1, impl, wy)
        return u / (4.0 * nx * ny)

    return solve


def fst_poisson_dirichlet(f_interior, dx: float, dy: float,
                          impl: str = "rfft", mesh=None, shape=None):
    """One-off form of make_fst_poisson_dirichlet.  f_interior: (nx-1,
    ny-1) interior nodes of an (nx+1, ny+1) grid; returns the interior
    solution of the same shape.  With a mesh: the rank's row slab of the
    interior, of global `shape` (nx-1, ny-1)."""
    mx, my = (f_interior.shape[-2], f_interior.shape[-1]) if mesh is None \
        else _global_shape(shape)
    return make_fst_poisson_dirichlet(
        mx, my, dx, dy, f_interior.dtype, f_interior.device, impl,
        mesh)(f_interior)


# ------------------------------------------------------------- dealiasing

def dealias_mask_23(nx: int, ny: int, device=None):
    """Symmetric 2/3-rule mask: with ne = floor(2n/3), keep |k| < ne//2.
    (The reference's index range, pseudospectral_23_rule.jl:124-133, keeps
    one extra negative mode, which breaks Hermitian symmetry of real-field
    spectra; the symmetric band is the standard rule.)"""
    nxe, nye = (2 * nx) // 3, (2 * ny) // 3
    ix = torch.arange(nx, device=device)
    iy = torch.arange(ny, device=device)
    keep_x = (ix < nxe // 2) | (ix > nx - nxe // 2)
    keep_y = (iy < nye // 2) | (iy > ny - nye // 2)
    return keep_x[:, None] & keep_y[None, :]


def _require_even_32(nx: int, ny: int):
    """The 3/2-rule block moves assume even nx/ny: odd sizes would split
    a frequency row across the positive/negative blocks and come back
    one row short (shape (nx-1, ...)) — fail loudly, not downstream."""
    if nx % 2 or ny % 2:
        raise ValueError(
            f"3/2-rule dealiasing requires even grid sizes, got "
            f"({nx}, {ny}); use the 2/3-rule solver for odd grids")


def _pad_rows_32(cols, nx: int, nxe: int):
    """Zero rows between the positive- and negative-frequency row blocks."""
    hx = nx // 2
    zr = cols.new_zeros(cols.shape[:-2] + (nxe - nx, cols.shape[-1]))
    return torch.cat([cols[..., :hx, :], zr, cols[..., hx:, :]], dim=-2)


def pad_32(fhat, nxe: int, nye: int):
    """Zero-pad an (nx, ny) spectrum into an (nxe, nye) spectrum (3/2-rule
    dealiasing, pseudospectral_32_rule.jl:124-153), preserving Parseval
    scaling for the round trip (scale by (nxe nye)/(nx ny) on ifft)."""
    nx, ny = fhat.shape[-2], fhat.shape[-1]
    _require_even_32(nx, ny)
    hy = ny // 2
    zc = fhat.new_zeros(fhat.shape[:-1] + (nye - ny,))
    cols = torch.cat([fhat[..., :, :hy], zc, fhat[..., :, hy:]], dim=-1)
    return _pad_rows_32(cols, nx, nxe)


def pad_32_half(h, ny: int, nxe: int, nye: int):
    """pad_32 for rfft2 HALF spectra: an (nx, ny//2+1) half spectrum into
    the (nxe, nye//2+1) half spectrum of the 3/2 grid.

    Columns 0..ny/2-1 keep their frequencies.  The coarse Nyquist column
    (j = ny/2) is dropped: pad_32 moves it to the fine grid's -ny/2 alone,
    with no +ny/2 partner, which no half spectrum of a real field holds.
    The callers zero that column first (vortex._nyquist_mask), and then
    this equals the half of pad_32 of the mirrored full spectrum."""
    nx = h.shape[-2]
    _require_even_32(nx, ny)
    hy = ny // 2
    zc = h.new_zeros(h.shape[:-1] + (nye // 2 + 1 - hy,))
    return _pad_rows_32(torch.cat([h[..., :, :hy], zc], dim=-1), nx, nxe)


def truncate_32_half(h_e, nx: int, ny: int):
    """truncate_32 for rfft2 HALF spectra: gather an (nxe, nye//2+1) half
    spectrum on the 3/2 grid back to (nx, ny//2+1).

    Columns 0..ny/2-1 map to the same positive frequencies.  The target
    Nyquist column (j = ny/2) must carry the reference's kept coefficient,
    which is the *negative* frequency -ny/2 on the fine grid
    (truncate_32 keeps columns [nye-hy:], i.e. -hy..-1); in half layout
    that is conj(h_e[(nxe - i) % nxe, +hy])."""
    _require_even_32(nx, ny)
    nxe = h_e.shape[-2]
    hx, hy = nx // 2, ny // 2
    rows = torch.cat([h_e[..., :hx, :], h_e[..., nxe - hx :, :]], dim=-2)
    head = rows[..., :, :hy]
    col = torch.conj(h_e[..., :, hy])                    # (.., nxe)
    col = torch.cat([col[..., :1], torch.flip(col[..., 1:], (-1,))],
                    dim=-1)                              # i -> (nxe-i)%nxe
    nyq = torch.cat([col[..., :hx], col[..., nxe - hx :]], dim=-1)
    return torch.cat([head, nyq[..., :, None]], dim=-1)


def truncate_32(fhat_e, nx: int, ny: int):
    """Inverse of pad_32: gather the retained modes back to (nx, ny)."""
    _require_even_32(nx, ny)
    nxe, nye = fhat_e.shape[-2], fhat_e.shape[-1]
    hx, hy = nx // 2, ny // 2
    rows = torch.cat(
        [fhat_e[..., :hx, :], fhat_e[..., nxe - hx :, :]], dim=-2
    )
    return torch.cat(
        [rows[..., :, :hy], rows[..., :, nye - hy :]], dim=-1
    )
