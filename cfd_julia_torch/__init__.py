"""cfd_julia_torch — the PyTorch/CUDA port of cfd_julia_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout and names (`core/`, `ops/`, `poisson/`,
`models/`, `stepping/`, `utils/`, `presets.py`, `run.py`, `cli.py`), so the
counterpart of each module is found under the same path.  Plain tensor code
is PyTorch run eagerly; every Pallas TPU kernel on a ported path becomes a
hand-written CUDA C++ kernel for sm_90a under `csrc/`, built with nvcc on
first use (`ops/_cuda_build.py`) and bound with ctypes (`ops/cuda_kernels.py`).

Ported so far, each against the JAX package in fp64 on the CPU:
* the lid-driven cavity (reference ch. 18): the full-grid step on the
  Arakawa RHS kernel with the sine-matmul or rfft DST-I Poisson solve; the
  packed interior-padded step (`poisson="fused"`) on its stage kernel; the
  bf16 precision tiers on the tier GEMM and its split pass;
* the 2D Poisson solvers: direct (FFT / DST-I, ch. 12-14), iterative and
  multigrid (ch. 15-17), the V-cycle's red-black smoother and fused level
  edges as CUDA kernels;
* the 1D family: heat (ch. 01-04), Burgers with WENO-5 / CRWENO-5 and the
  flux forms (ch. 05-08), and the Euler Sod tube (ch. 09-11), whose whole
  WENO-5 + Riemann RHS is one CUDA kernel;
* the periodic vortex merger and Taylor-Green solvers (ch. 19-22): fdm on
  the Arakawa kernel; hybrid, ps32 and ps23 on torch.fft (cuFFT) with the
  half-spectrum step's stage passes as CUDA kernels;
* the Reynolds ensemble (one batched RHS launch for all members) and
  gradients through torch.autograd, the kernels' backward included;
* the user surface: the CLI (`list`, `run`, `run-all`, `--sweep`,
  `validate`, `order`, `plot`), the presets, the examples, checkpoints
  that resume bit for bit, `utils.debug.nan_guard`;
* the multi-device layer (`parallel/`): ranks over torch.distributed,
  halo exchanges and pencil transposes, the sharded cavity, multigrid and
  spectral steps and their gradients.
Every time loop runs chunks of steps that are CUDA graphs on the GPU
(stepping/loop.py), the multigrid solve a captured V-cycle.

This package imports neither JAX nor cfd_julia_tpu; importing it loads no
GPU library and builds nothing.
"""

__version__ = "0.1.0"

from cfd_julia_torch.core.grid import Grid1D, Grid2D  # noqa: F401
from cfd_julia_torch.core import precision  # noqa: F401
