"""Build and load the port's CUDA C++ kernels.

nvcc compiles each `csrc/*.cu` for sm_90a into an object, all sources at
once in parallel, and links the objects into one shared library with a
plain C interface, which ctypes loads; the library links cuFFT (`-lcufft`,
for csrc/fft_plans.cu), whose soname resolves to the copy PyTorch has
already loaded.  No PyTorch header is compiled, so a build takes seconds.
The library goes to `build/kernels/<hash of sources + flags>/` beside the
package, with nvcc's output (ptxas register and spill counts) in
`nvcc.log` beside it; it is built on first use, reused from disk by later
processes, and loaded once per process.  A missing nvcc or a failed
compile raises with nvcc's output: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libcfd_julia_torch_kernels.so"
LOG_NAME = "nvcc.log"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-shared", "-lcufft")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double
_ARAKAWA_ARGS = [_PTR, _PTR, _PTR, _INT, _INT, _DBL, _DBL, _DBL, _PTR]
# w, s, out, re (device, one a member), batch, nr, nc, dx, dy, stream
_ARAKAWA_BATCHED_ARGS = [_PTR] * 4 + [_INT] * 3 + [_DBL] * 2 + [_PTR]
# w, s, g, re, gw, gs, partials, counters, gre, batch, nr, nc, dx, dy,
# stream
_ARAKAWA_BACKWARD_ARGS = [_PTR] * 9 + [_INT] * 3 + [_DBL] * 2 + [_PTR]
# q, out, nx, gamma, dx, solver code, wavespeed code, stream
_EULER_ARGS = [_PTR, _PTR, _INT, _DBL, _DBL, _INT, _INT, _PTR]
# w, wt, s, rl, rh, cl, ch, out, rl_o, rh_o, cl_o, ch_o, P, Q, m, n, stage,
# bc order, dt, dx, dy, re, stream
_CAVITY_STAGE_ARGS = [_PTR] * 12 + [_INT] * 6 + [_DBL] * 4 + [_PTR]
# wt, s, rl, rh, cl, ch, g, h_rl, h_rh, h_cl, h_ch, gw, gwt, gs, g_rl, g_rh,
# g_cl, g_ch, partials, counters, gre, P, Q, m, n, stage, bc order, dt, dx,
# dy, re, stream
_CAVITY_STAGE_BACKWARD_ARGS = [_PTR] * 21 + [_INT] * 6 + [_DBL] * 4 + [_PTR]
# x, rows, cols, ld, transpose, out, out_rows, kp, passes, stream
_TIER_SPLIT_ARGS = [_PTR] + [_INT] * 4 + [_PTR] + [_INT] * 3 + [_PTR]
# map, base, rows, kp, role (0 A, 1 B)
_TIER_ENCODE_ARGS = [_PTR, _PTR, _INT, _INT, _INT]
# map_a, map_b, out, M, N, ld, out_rows, k-blocks, a_lo, b_lo, passes,
# epilogue, table, ldt, op, scale, stream
_TIER_GEMM_PLANES_ARGS = [_PTR] * 3 + [_INT] * 9 + [_PTR, _INT, _INT, _DBL,
                                                     _PTR]
# h, rowk, colk, out, rows, hy, nb, kx_major, scale, stream
_VORTEX_DERIVS_ARGS = [_PTR] * 4 + [_INT] * 4 + [_DBL, _PTR]
# in, out, n, stream
_VORTEX_PRODUCT_ARGS = [_PTR, _PTR, ctypes.c_longlong, _PTR]
# a, h, r, j0, b, j1, out, n, stream
_VORTEX_COMBINE_ARGS = [_PTR] * 7 + [ctypes.c_longlong, _PTR]
# h, rowk, colk, out, rows, si, sj, nb, cols, pad, ky_fastest, scale, stream
_VORTEX_DERIVS_BUFFER_ARGS = [_PTR] * 4 + [_INT] * 7 + [_DBL, _PTR]
# jf, table, out, nx, hy, nxe, si, sj, kx_major, stream
_VORTEX_TRUNCATE_ARGS = [_PTR] * 3 + [_INT] * 6 + [_PTR]
# cuFFT plans (csrc/fft_plans.cu): kind, n, batch, istride, idist, ostride,
# odist, *handle, *work bytes; handle, work; handle, kind, in, out, stream
_FFT_SIGNATURES = {
    "fft_plan_create": (_INT, [_INT] * 7 + [_PTR, _PTR]),
    "fft_plan_set_work_area": (_INT, [_INT, _PTR]),
    "fft_plan_exec": (_INT, [_INT, _INT, _PTR, _PTR, _PTR]),
    "fft_plan_destroy": (_INT, [_INT]),
    "fft_version": (_INT, [_PTR]),
}
# multigrid launchers, one per storage type (ops/cuda_kernels.py)
_MG_ARGS = {
    # u, f, out, work, nr, nc, 1/dx^2, 1/dy^2, sweeps, stream
    "mg_rb_sweeps": [_PTR] * 4 + [_INT, _INT, _DBL, _DBL, _INT, _PTR],
    # u, f, out, fc, work, nr, nc, 1/dx^2, 1/dy^2, sweeps, stream
    "mg_smooth_residual_restrict":
        [_PTR] * 5 + [_INT, _INT, _DBL, _DBL, _INT, _PTR],
    # u, f, fc, nr, nc, 1/dx^2, 1/dy^2, stream
    "mg_residual_restrict": [_PTR] * 3 + [_INT, _INT, _DBL, _DBL, _PTR],
    # u, f, uc, out, work, partials, ssq, nr, nc, 1/dx^2, 1/dy^2, sweeps,
    # stream
    "mg_prolong_correct_smooth":
        [_PTR] * 7 + [_INT, _INT, _DBL, _DBL, _INT, _PTR],
    # nr, nc, sweeps -> partial sums the ascend edge's residual sum writes
    "mg_ssq_partials": [_INT, _INT, _INT],
    # u, f, r (or null), partials, ssq, nr, nc, 1/dx^2, 1/dy^2, stream
    "mg_residual_ssq": [_PTR] * 5 + [_INT, _INT, _DBL, _DBL, _PTR],
}
# exported C symbol -> (restype, argtypes); every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
SIGNATURES = {
    "arakawa_rhs_f32": (_INT, _ARAKAWA_ARGS),
    "arakawa_rhs_f64": (_INT, _ARAKAWA_ARGS),
    "arakawa_rhs_batched_f32": (_INT, _ARAKAWA_BATCHED_ARGS),
    "arakawa_rhs_batched_f64": (_INT, _ARAKAWA_BATCHED_ARGS),
    "arakawa_rhs_backward_f32": (_INT, _ARAKAWA_BACKWARD_ARGS),
    "arakawa_rhs_backward_f64": (_INT, _ARAKAWA_BACKWARD_ARGS),
    "arakawa_rhs_backward_partials": (_INT, [_INT, _INT]),
    "arakawa_rhs_backward_constant": (_INT, [_INT]),
    "arakawa_rhs_backward_capacity": (_INT, [_INT] * 2),
    "arakawa_rhs_backward_rows": (_INT, [_INT] * 5),
    "euler_rhs_f32": (_INT, _EULER_ARGS),
    "euler_rhs_f64": (_INT, _EULER_ARGS),
    "cavity_stage_f32": (_INT, _CAVITY_STAGE_ARGS),
    "cavity_stage_f64": (_INT, _CAVITY_STAGE_ARGS),
    "cavity_stage_constant": (_INT, [_INT]),
    "cavity_stage_backward_f32": (_INT, _CAVITY_STAGE_BACKWARD_ARGS),
    "cavity_stage_backward_f64": (_INT, _CAVITY_STAGE_BACKWARD_ARGS),
    "cavity_stage_backward_partials": (_INT, [_INT, _INT]),
    **{f"vortex_{name}_{sfx}": (_INT, args) for name, args in (
        ("derivs_half", _VORTEX_DERIVS_ARGS),
        ("derivs_half_buffer", _VORTEX_DERIVS_BUFFER_ARGS),
        ("product", _VORTEX_PRODUCT_ARGS),
        ("cn_combine", _VORTEX_COMBINE_ARGS),
        ("truncate_32", _VORTEX_TRUNCATE_ARGS)) for sfx in ("f32", "f64")},
    **_FFT_SIGNATURES,
    "tier_split": (_INT, _TIER_SPLIT_ARGS),
    "tier_encode": (_INT, _TIER_ENCODE_ARGS),
    "tier_gemm_tn_planes": (_INT, _TIER_GEMM_PLANES_ARGS),
    "cfd_cuda_error_string": (ctypes.c_char_p, [_INT]),
    "mg_edge_sweeps_per_pass": (_INT, []),
    "mg_edge_work_fields": (_INT, [_INT]),
    "mg_residual_ssq_partials": (_INT, [_INT, _INT]),
    **{f"{name}_{sfx}": (_INT, args) for name, args in _MG_ARGS.items()
       for sfx in ("f32", "f64", "bf16")},
}


def find_nvcc() -> str:
    """nvcc under $CUDA_HOME/bin (default /usr/local/cuda), else on PATH."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin (CUDA_HOME) or on PATH; "
            "the CUDA kernels of cfd_julia_torch cannot be built")
    return found


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def library_path(csrc: Path = CSRC) -> Path:
    """Where the library for the sources in `csrc` and the flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sources(csrc) + sorted(csrc.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build(csrc: Path = CSRC) -> Path:
    """Compile the library of the sources in `csrc` (the package's own by
    default) unless it is already on disk; return its path."""
    out = library_path(csrc)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # private temporary names + atomic rename: a process that builds at the
    # same time never loads a half-written library
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    # nvcc's link step tells objects by their .o suffix
    objs = [out.with_name(f".{p.stem}.{os.getpid()}.o")
            for p in sources(csrc)]
    log = []
    try:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(p)]
                             for p, o in zip(sources(csrc), objs))]
        results = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, proc in procs]
        # the libraries after the objects that use them (a linker with
        # --as-needed drops a library named before its users)
        link = [nvcc, "-o", str(tmp), *(str(o) for o in objs), *LINK_FLAGS]
        for cmd, output, rc in results:
            log.append(f"$ {' '.join(cmd)}\n{output}")
            if rc != 0:
                raise RuntimeError(f"nvcc failed with exit code {rc}: "
                                   f"{' '.join(cmd)}\n{output}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        out.with_name(LOG_NAME).write_text("\n".join(log))
        os.replace(tmp, out)
    finally:
        for p in [tmp, *objs]:
            p.unlink(missing_ok=True)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built if needed, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
