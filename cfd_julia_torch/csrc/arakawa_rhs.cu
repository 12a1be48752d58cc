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
// 60 flops per point.  The design relies on cache reuse of the 9-point
// neighbourhood: threadIdx.x walks the contiguous axis 1, so a warp's loads
// of one row are coalesced, and the rows i-1, i, i+1 that neighbouring
// threads and blocks share are served from L1/L2, so each element comes from
// device memory about once.  The periodic wrap is index arithmetic: no
// padded copies, no halo rows, no lane padding.  One thread per output
// point; the ragged edge is masked.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): each
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;  // columns: axis 1, contiguous
constexpr int kBlockY = 8;   // rows: axis 0

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
arakawa_rhs_kernel(const T* __restrict__ w, const T* __restrict__ s,
                   T* __restrict__ out, int nr, int nc,
                   T gg, T dx2, T dy2, T re) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= nr || j >= nc) return;

  const int ip = (i + 1 == nr) ? 0 : i + 1;
  const int im = (i == 0) ? nr - 1 : i - 1;
  const int jp = (j + 1 == nc) ? 0 : j + 1;
  const int jm = (j == 0) ? nc - 1 : j - 1;
  const size_t r0 = static_cast<size_t>(i) * nc;
  const size_t rp = static_cast<size_t>(ip) * nc;
  const size_t rm = static_cast<size_t>(im) * nc;

  // u_{i+di, j+dj}: E/W step along axis 0, N/S along axis 1, as in
  // cfd_julia_torch/ops/arakawa.py
  const T wc = w[r0 + j];
  const T wE = w[rp + j], wW = w[rm + j];
  const T wN = w[r0 + jp], wS = w[r0 + jm];
  const T wNE = w[rp + jp], wSW = w[rm + jm];
  const T wNW = w[rm + jp], wSE = w[rp + jm];
  const T sE = s[rp + j], sW = s[rm + j];
  const T sN = s[r0 + jp], sS = s[r0 + jm];
  const T sNE = s[rp + jp], sSW = s[rm + jm];
  const T sNW = s[rm + jp], sSE = s[rp + jm];

  const T j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW);
  const T j2 = wE * (sNE - sSE) - wW * (sNW - sSW)
             - wN * (sNE - sNW) + wS * (sSE - sSW);
  const T j3 = wNE * (sN - sE) - wSW * (sW - sS)
             - wNW * (sN - sW) + wSE * (sE - sS);
  const T jac = gg * (j1 + j2 + j3) / T(3);
  const T lap = (wE - T(2) * wc + wW) / dx2 + (wN - T(2) * wc + wS) / dy2;
  out[r0 + j] = -jac + lap / re;
}

template <typename T>
int launch(const T* w, const T* s, T* out, int nr, int nc, double dx,
           double dy, double re, void* stream) {
  if (nr <= 0 || nc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nc + kBlockX - 1) / kBlockX, (nr + kBlockY - 1) / kBlockY);
  arakawa_rhs_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      w, s, out, nr, nc, static_cast<T>(1.0 / (4.0 * dx * dy)),
      static_cast<T>(dx * dx), static_cast<T>(dy * dy), static_cast<T>(re));
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
