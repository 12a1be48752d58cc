"""Build and load the port's CUDA C++ kernels.

nvcc compiles every `csrc/*.cu` into one shared library with a plain C
interface, for sm_90a, and ctypes loads it.  No PyTorch header is
compiled, so a build takes seconds.  The library goes to
`build/kernels/<hash of sources + flags>/` beside the package, is built on
first use, reused from disk by later processes, and loaded once per
process.  A missing nvcc or a failed compile raises with nvcc's output:
there is no fallback.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTR = ctypes.c_void_p
_ARAKAWA_ARGS = [_PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
                 ctypes.c_double, ctypes.c_double, ctypes.c_double, _PTR]
# exported C symbol -> (restype, argtypes); every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
SIGNATURES = {
    "arakawa_rhs_f32": (ctypes.c_int, _ARAKAWA_ARGS),
    "arakawa_rhs_f64": (ctypes.c_int, _ARAKAWA_ARGS),
    "cfd_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
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


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless it is already on disk; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # private temporary name + atomic rename: a process that builds at the
    # same time never loads a half-written library
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
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
