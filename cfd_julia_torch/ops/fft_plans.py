"""cuFFT plans on the port's own layouts (csrc/fft_plans.cu), with their
plain versions, and the half-spectrum vortex step's inverse built on them.

torch.fft picks its own layouts: around ps23's band inverse it pads the kx
transform's column-ordered output into a row-major copy and clones every
c2r input (cuFFT's c2r may overwrite it), and around ps32's it needs the
3/2 pad as `cat` copies.  Here a `Layout` names one 1-D transform over a
batch in cuFFT's advanced layout (element k of sequence b at b idist + k
istride of the input, b odist + k ostride of the output), a `Plan` is a
cuFFT plan of it with its own work area, and `execute` runs the plan of a
layout (made once per (layout, dtype, device) and kept) on a CUDA tensor's
current stream, or, on a CPU tensor, its plain version `execute_plain`:
the same layout applied with torch.as_strided and torch.fft.  Every
execution is counted in cuda_kernels.LAUNCHES under fft_c2c and fft_c2r.
There is no fallback: a cuFFT error raises with its code.

The transforms are inverses and unnormalised (torch.fft's
norm="forward"): the callers fold 1/n into their spectra.  A plan's work
area is a PyTorch tensor allocated with the plan (cuFFT's own allocation
is off), so a captured CUDA graph replays on memory PyTorch owns; make the
plans before a capture, as HalfInverse does.  A plan lives for the process
(a captured graph may replay it at any time) unless destroyed.

Replaces no Pallas kernel: the JAX package leaves these transforms to XLA
(cfd_julia_tpu/models/vortex.py:392 make_spectral_step_half).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from cfd_julia_torch.core import precision
from cfd_julia_torch.ops import _cuda_build, cuda_kernels

C2C, C2R = "c2c", "c2r"
# csrc/fft_plans.cu's kind codes by (kind, real dtype)
_KINDS = {(C2C, torch.float32): 0, (C2R, torch.float32): 1,
          (C2C, torch.float64): 2, (C2R, torch.float64): 3}
# cufftResult codes (cufft.h)
_RESULTS = {1: "CUFFT_INVALID_PLAN", 2: "CUFFT_ALLOC_FAILED",
            3: "CUFFT_INVALID_TYPE", 4: "CUFFT_INVALID_VALUE",
            5: "CUFFT_INTERNAL_ERROR", 6: "CUFFT_EXEC_FAILED",
            7: "CUFFT_SETUP_FAILED", 8: "CUFFT_INVALID_SIZE",
            9: "CUFFT_UNALIGNED_DATA", 11: "CUFFT_INVALID_DEVICE",
            13: "CUFFT_NO_WORKSPACE", 14: "CUFFT_NOT_IMPLEMENTED",
            16: "CUFFT_NOT_SUPPORTED"}


@dataclasses.dataclass(frozen=True)
class Layout:
    """One 1-D transform of length n over `batch` sequences: C2C (an
    inverse complex transform) or C2R (n//2+1 complex values to n real
    ones), strides and distances in elements of the input and the output
    type."""
    kind: str
    n: int
    batch: int
    istride: int
    idist: int
    ostride: int
    odist: int

    @property
    def n_in(self) -> int:
        return self.n if self.kind == C2C else self.n // 2 + 1

    def span(self, side: str) -> int:
        """Elements from the first the layout touches on `side` ("in" or
        "out") to the last, inclusive."""
        n, stride, dist = ((self.n_in, self.istride, self.idist)
                           if side == "in" else
                           (self.n, self.ostride, self.odist))
        return (self.batch - 1) * dist + (n - 1) * stride + 1


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"cuFFT {what} failed: error {err} "
                           f"({_RESULTS.get(err, 'unknown')})")


class Plan:
    """A cuFFT plan of `layout` in `dtype` (the real precision) on a CUDA
    device, with its own work area: two plans never share one, so steps on
    two streams may run at once."""

    def __init__(self, layout: Layout, dtype, device: torch.device):
        self.layout, self.device = layout, device
        self.kind = _KINDS[(layout.kind, dtype)]
        lib = _cuda_build.load_library()
        handle, work = ctypes.c_int(), ctypes.c_longlong()
        with torch.cuda.device(device):
            _check(lib.fft_plan_create(
                self.kind, layout.n, layout.batch, layout.istride,
                layout.idist, layout.ostride, layout.odist,
                ctypes.byref(handle), ctypes.byref(work)),
                f"plan creation of {layout}")
        self.handle = handle.value
        self.work = torch.empty(max(work.value, 1), dtype=torch.uint8,
                                device=device)
        _check(lib.fft_plan_set_work_area(self.handle, self.work.data_ptr()),
               "work area")

    def destroy(self) -> None:
        _check(_cuda_build.load_library().fft_plan_destroy(self.handle),
               "plan destruction")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# execute's plans by (layout, dtype, device)
_PLANS: dict = {}


def _plan(layout: Layout, dtype, device) -> Plan:
    """execute's plan of (layout, dtype, device): created at the first
    call, which must not be inside a CUDA graph capture."""
    key = (layout, dtype, device)
    if key not in _PLANS:
        _PLANS[key] = Plan(layout, dtype, device)
    return _PLANS[key]


def version() -> int:
    """cufftGetVersion() of the cuFFT the kernel library runs."""
    v = ctypes.c_int()
    _check(_cuda_build.load_library().fft_version(ctypes.byref(v)), "version")
    return v.value


def _check_operands(layout: Layout, x, out) -> torch.dtype:
    """The real dtype of a valid (x, out) pair for layout; raises else."""
    real = {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(x.dtype)
    want = x.dtype if layout.kind == C2C else real
    if real is None or out.dtype != want:
        raise TypeError(f"fft {layout.kind}: a complex64 or complex128 input "
                        f"and a {want} output, got {x.dtype}, {out.dtype}")
    if not (x.is_contiguous() and out.is_contiguous()) or \
            x.device != out.device or x.numel() < layout.span("in") or \
            out.numel() < layout.span("out"):
        raise ValueError(f"fft {layout}: contiguous operands on one device "
                         f"spanning {layout.span('in')} input and "
                         f"{layout.span('out')} output elements, got "
                         f"{tuple(x.shape)}, {tuple(out.shape)}")
    return real


def execute_plain(layout: Layout, x, out):
    """Plain version of `execute`: the layout's views of x and out
    (torch.as_strided), torch.fft between them.  Returns out."""
    src = x.as_strided((layout.batch, layout.n_in),
                       (layout.idist, layout.istride))
    if layout.kind == C2C:
        y = torch.fft.ifft(src, dim=-1, norm="forward")
    else:
        y = torch.fft.irfft(src, n=layout.n, dim=-1, norm="forward")
    out.as_strided((layout.batch, layout.n),
                   (layout.odist, layout.ostride)).copy_(y)
    return out


def execute(layout: Layout, x, out):
    """out <- the layout's transform of x, unnormalised; out may be x (in
    place, C2C).  x and out contiguous, of one precision (complex input;
    the output complex for C2C, real for C2R), each spanning the layout.
    CUDA tensors: the layout's kept plan on the current stream (a C2R may
    overwrite x); CPU tensors: execute_plain.  Returns out."""
    dtype = _check_operands(layout, x, out)
    if x.device.type == "cpu":
        return execute_plain(layout, x, out)
    if x.device.type != "cuda":
        raise ValueError(f"fft runs on cpu or cuda, not {x.device}")
    _run(_plan(layout, dtype, _device(x.device)), x.data_ptr(),
         out.data_ptr(), _stream(x.device))
    _nan_check(layout, out)
    return out


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _run(p: Plan, x_ptr: int, out_ptr: int, stream: int) -> None:
    """One execution of plan p on device pointers; counted."""
    _check(_cuda_build.load_library().fft_plan_exec(
        p.handle, p.kind, x_ptr, out_ptr, stream),
        f"{p.layout.kind} execution")
    cuda_kernels.LAUNCHES[f"fft_{p.layout.kind}"] += 1


def _nan_check(layout: Layout, out) -> None:
    if cuda_kernels.CHECK_NAN and bool(torch.isnan(out).any()):
        raise FloatingPointError(f"NaN in the output of the cuFFT "
                                 f"{layout.kind} transform")


# ------------------------------------------- the half-spectrum inverse

def half_inverse_plain(buf, n: int, nb: int, ky_fastest: bool = False):
    """The twin of HalfInverse in torch ops: buf (cols, fields, rows), or
    (fields, rows, >= cols) with ky_fastest (its first cols columns read),
    complex -> (fields, rows, n) real, the inverse transform along the
    rows of the first nb columns, then the c2r along the columns of the
    cols = n//2+1; unnormalised."""
    spec = buf[..., :n // 2 + 1] if ky_fastest else buf.permute(1, 2, 0)
    head = torch.fft.ifft(spec[..., :nb], dim=-2, norm="forward")
    spec = torch.cat([head, spec[..., nb:]], -1)
    return torch.fft.irfft(spec, n=n, dim=-1, norm="forward")


def half_inverse_backward_plain(g, nb: int, ky_fastest: bool = False,
                                width: int | None = None):
    """The adjoint of half_inverse_plain for the cotangent g (fields, rows,
    n): torch's c2r adjoint (an unnormalised r2c, the columns that stand
    for a conjugate pair doubled), then the forward transform along the
    rows of the first nb columns; complex, in the buffer's layout (ky
    fastest: `width` columns a row, those past n//2+1 zero)."""
    n = g.shape[-1]
    gs = torch.fft.rfft(g, dim=-1, norm="backward")
    gs[..., 1:n - gs.shape[-1] + 1] *= 2
    pad = [] if width is None else [gs.new_zeros(
        (*gs.shape[:-1], width - gs.shape[-1]))]
    gs = torch.cat([torch.fft.fft(gs[..., :nb], dim=-2, norm="backward"),
                    gs[..., nb:], *pad], -1)
    return gs if ky_fastest else gs.permute(2, 0, 1)


class _HalfInverse(torch.autograd.Function):
    """HalfInverse under grad: a new output, the adjoint in torch ops."""

    @staticmethod
    def forward(ctx, buf, inv):
        ctx.args = (inv.nb, inv.ky_fastest,
                    buf.shape[-1] if inv.ky_fastest else None)
        return inv.run(buf, torch.empty(inv.out.shape, dtype=inv.out.dtype,
                                        device=buf.device))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return half_inverse_backward_plain(g, *ctx.args), None


class HalfInverse:
    """The inverse of `fields` half spectra held in the buffer layout of
    cuda_kernels.vortex_derivs_half's buffer mode, cols = n//2+1 complex
    columns of which the first nb hold data (the others are zero): an
    in-place C2C along the rows over those columns, then a C2R along the
    columns into (fields, rows, n) real fields.  Two layouts:
      (cols, fields, rows), kx fastest: one C2C over fields * nb
        contiguous columns, one C2R with stride fields * rows (ps32's:
        rows = nxe, n = nye, nb = ny//2);
      (fields, rows, pitch), ky fastest, each row padded to a pitch of 16
        complex values: one strided C2C a field, one C2R over the rows'
        first cols values (ps23's: rows = nx, nb its band), which measured
        faster at 2048^2 (chip_smoke.py phase 2 times both layouts).

    Made with the step: the buffer the derivative pass writes, the fields'
    buffer and, on a CUDA device, its own two plans.  A pitched row's
    values past cols are read by neither plan.  A call consumes its buffer
    (the C2C is in place and the C2R may overwrite it) and, outside grad,
    returns the fields' buffer, which the next call overwrites."""

    def __init__(self, fields: int, rows: int, n: int, nb: int, dtype,
                 device, ky_fastest: bool = False):
        cols = n // 2 + 1
        self.n, self.nb, self.ky_fastest = n, nb, ky_fastest
        if ky_fastest:
            pitch = -(-cols // 16) * 16
            shape = (fields, rows, pitch)
            self.c2c = Layout(C2C, rows, nb, pitch, 1, pitch, 1)
            self.c2r = Layout(C2R, n, fields * rows, 1, pitch, 1, n)
        else:
            shape = (cols, fields, rows)
            self.c2c = Layout(C2C, rows, fields * nb, 1, rows, 1, rows)
            self.c2r = Layout(C2R, n, fields * rows, fields * rows, 1, 1, n)
        self.buffer = torch.empty(shape, dtype=precision.complex_dtype(dtype),
                                  device=device)
        self.out = torch.empty((fields, rows, n), dtype=dtype, device=device)
        self.plans = None
        if self.buffer.device.type == "cuda":
            self.plans = tuple(Plan(layout, dtype,
                                    _device(self.buffer.device))
                               for layout in (self.c2c, self.c2r))

    def run(self, buf, out):
        """The transforms of buf into out (buf consumed); returns out.  On
        the GPU the operands are checked once and the plans run on device
        pointers (ky fastest: one kx transform a field)."""
        if self.plans is None or buf.device.type != "cuda":
            for part in (buf if self.ky_fastest else (buf,)):
                execute(self.c2c, part, part)
            return execute(self.c2r, buf, out)
        if buf.shape != self.buffer.shape or out.shape != self.out.shape or \
                buf.device != self.buffer.device:
            raise ValueError(f"HalfInverse takes a {tuple(self.buffer.shape)}"
                             f" buffer and {tuple(self.out.shape)} fields on "
                             f"{self.buffer.device}, got {tuple(buf.shape)},"
                             f" {tuple(out.shape)} on {buf.device}")
        _check_operands(self.c2r, buf, out)
        stream = _stream(buf.device)
        field = buf[0].numel() * buf.element_size() if self.ky_fastest else 0
        for k in range(buf.shape[0] if self.ky_fastest else 1):
            ptr = buf.data_ptr() + k * field
            _run(self.plans[0], ptr, ptr, stream)
        _run(self.plans[1], buf.data_ptr(), out.data_ptr(), stream)
        _nan_check(self.c2r, out)
        return out

    def __call__(self, buf):
        if torch.is_grad_enabled() and buf.requires_grad:
            return _HalfInverse.apply(buf, self)
        return self.run(buf, self.out)
