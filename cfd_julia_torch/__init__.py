"""cfd_julia_torch — the PyTorch/CUDA port of cfd_julia_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout and names (`core/`, `ops/`, `poisson/`,
`models/`, `stepping/`, `utils/`, `presets.py`, `run.py`, `cli.py`), so the
counterpart of each module is found under the same path.  Plain tensor code
is PyTorch run eagerly; every Pallas TPU kernel on a ported path becomes a
hand-written CUDA C++ kernel for sm_90a under `csrc/`, built with nvcc on
first use (`ops/_cuda_build.py`) and bound with ctypes (`ops/cuda_kernels.py`).

Ported so far: the lid-driven cavity (reference ch. 18) on the full-grid
step with the Arakawa RHS kernel and the sine-matmul or rfft DST-I Poisson
solve; the direct (FFT / DST-I, ch. 12-14), iterative and multigrid
(ch. 15-17) 2D Poisson solvers, with the V-cycle's red-black smoother and
fused level edges as CUDA kernels; the 1D Euler Sod shock tube (ch. 09-11),
with its whole WENO-5 + Riemann RHS as one CUDA kernel; the periodic vortex
merger and Taylor-Green solvers (ch. 19-22): fdm on the Arakawa kernel,
hybrid, ps32 and ps23 on torch.fft (cuFFT).

This package imports neither JAX nor cfd_julia_tpu; importing it loads no
GPU library and builds nothing.
"""

__version__ = "0.1.0"
