// Periodic vorticity RHS  r = -J(w, s) + lap(w) / re  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cfd_julia_tpu/ops/pallas_kernels.py:637-744
// (_arakawa_kernel, launched by arakawa_rhs_fused): the 17-point Arakawa
// Jacobian (j1 + j2 + j3) / 3 plus the 5-point Laplacian, evaluated with
// periodic wrap over the whole (nr, nc) array.  The cavity slices the
// interior [1:-1, 1:-1]; the vortex fdm RHS uses the whole array.
//
// What bounds it: device memory.  A call reads two fields and writes one,
// 3 x 1025^2 x 4 B = 12.6 MB at the 1024^2 cavity in fp32, against about
// 45 flops per point: 3.76 us at 3.35 TB/s.  In the cavity step the fields
// are still in the 50 MB L2 from the kernels before, so what a call costs
// there is the launch, instructions and load latency, not HBM bytes.
//
// Design: a register window down a column.  Each thread owns one column j
// (threadIdx.x on the contiguous axis 1, so a warp's loads of a row are
// coalesced) and kRows consecutive output rows.  It first loads w and s at
// columns j-1, j, j+1 of the kRows + 2 rows it needs (rows i0-1 .. i0+kRows:
// 6 loads an output row, 6 x (kRows + 2) / kRows = 7.5 a point, against
// the 18 of a thread a point), all independent, so they are in flight
// together, then computes its kRows outputs from registers.  The periodic
// wrap is resolved once per row and once per column (jm, jp; with nc = 1
// or 2 they alias j, as they must).  A walk that passes the last row (the
// ragged last block) reads row 0 for every row past nr-1, computes, and
// stores nothing there.  Rows of 1025 fp32 are not 16-byte aligned, so the
// loads are scalar.  Blocks of 4 warps (one wave of 561 blocks at 1025^2).
//
// Numerics: the twin's expression in the twin's order (ops/arakawa.py).
// The four divisions, by constants of the launch (3, dx^2, dy^2, re), are
// div_rn.cuh's with reciprocals made on the host: each equals the IEEE
// quotient, and the kernel has no division slow path (nor any call).  The
// reciprocals go in as scalar parameters and 3 as a literal (passed as
// structs of divisor and reciprocal they cost 17 registers and 2-5% of the
// time on the H100).  Folding the divisions into gg/3, 1/(dx^2 re) and
// 1/(dy^2 re) measured 3% faster there and moves the result off the
// twin's by a few ulps; not taken.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): each
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

constexpr int kBlockX = 32;  // columns a block: axis 1, contiguous
constexpr int kBlockY = 4;   // column walkers a block, stacked along axis 0
constexpr int kRows = 8;     // output rows a walker computes

// w and s at columns jm, j, jp of one row
template <typename T>
struct Row {
  T w[3], s[3];
};

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
arakawa_rhs_kernel(const T* __restrict__ w, const T* __restrict__ s,
                   T* __restrict__ out, int nr, int nc, T gg, T dx2,
                   T dy2, T re, T r3, T rdx2, T rdy2, T rre) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i0 = (blockIdx.y * kBlockY + threadIdx.y) * kRows;
  if (j >= nc || i0 >= nr) return;
  const int jp = (j + 1 == nc) ? 0 : j + 1;
  const int jm = (j == 0) ? nc - 1 : j - 1;

  // rows[k] is row i0-1+k, wrapped: -1 reads nr-1, nr and past it row 0
  Row<T> rows[kRows + 2];
#pragma unroll
  for (int k = 0; k < kRows + 2; ++k) {
    const int g = i0 - 1 + k;
    const int o = (g < 0 ? nr - 1 : (g >= nr ? 0 : g)) * nc;
    rows[k] = {{w[o + jm], w[o + j], w[o + jp]},
               {s[o + jm], s[o + j], s[o + jp]}};
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // E/W step along axis 0, N/S along axis 1, as in
    // cfd_julia_torch/ops/arakawa.py; columns [0], [1], [2] are jm, j, jp
    const Row<T>& W = rows[r];
    const Row<T>& C = rows[r + 1];
    const Row<T>& E = rows[r + 2];
    const T wc = C.w[1];
    const T wE = E.w[1], wW = W.w[1];
    const T wN = C.w[2], wS = C.w[0];
    const T wNE = E.w[2], wSW = W.w[0];
    const T wNW = W.w[2], wSE = E.w[0];
    const T sE = E.s[1], sW = W.s[1];
    const T sN = C.s[2], sS = C.s[0];
    const T sNE = E.s[2], sSW = W.s[0];
    const T sNW = W.s[2], sSE = E.s[0];

    const T j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW);
    const T j2 = wE * (sNE - sSE) - wW * (sNW - sSW)
               - wN * (sNE - sNW) + wS * (sSE - sSW);
    const T j3 = wNE * (sN - sE) - wSW * (sW - sS)
               - wNW * (sN - sW) + wSE * (sE - sS);
    const T jac = div_rn(gg * (j1 + j2 + j3), T(3), r3);
    const T lap = div_rn(wE - T(2) * wc + wW, dx2, rdx2)
                + div_rn(wN - T(2) * wc + wS, dy2, rdy2);
    const T res = -jac + div_rn(lap, re, rre);
    if (i0 + r < nr) out[(i0 + r) * nc + j] = res;
  }
}

template <typename T>
int launch(const T* w, const T* s, T* out, int nr, int nc, double dx,
           double dy, double re, void* stream) {
  if (nr <= 0 || nc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int walkers = (nr + kRows - 1) / kRows;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nc + kBlockX - 1) / kBlockX,
                  (walkers + kBlockY - 1) / kBlockY);
  const T dx2 = static_cast<T>(dx * dx), dy2 = static_cast<T>(dy * dy);
  const T re_ = static_cast<T>(re);
  arakawa_rhs_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      w, s, out, nr, nc, static_cast<T>(1.0 / (4.0 * dx * dy)), dx2, dy2, re_,
      T(1) / T(3), T(1) / dx2, T(1) / dy2, T(1) / re_);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arakawa_rhs_f32(const float* w, const float* s, float* out,
                               int nr, int nc, double dx, double dy,
                               double re, void* stream) {
  return launch<float>(w, s, out, nr, nc, dx, dy, re, stream);
}

extern "C" int arakawa_rhs_f64(const double* w, const double* s, double* out,
                               int nr, int nc, double dx, double dy,
                               double re, void* stream) {
  return launch<double>(w, s, out, nr, nc, dx, dy, re, stream);
}

extern "C" const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
