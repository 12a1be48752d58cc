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
// quotient, and the 2-D host-Re call has no division slow path (nor any
// call).  The reciprocals go in as scalar parameters and 3 as a literal
// (passed as structs of divisor and reciprocal they cost 17 registers and
// 2-5% of the time on the H100).  Folding the divisions into gg/3, 1/(dx^2 re) and
// 1/(dy^2 re) measured 3% faster there and moves the result off the
// twin's by a few ulps; not taken.
//
// Batches: a (B, nr, nc) call is one launch, blockIdx.z the member, each
// member's fields at a 64-bit offset, its Reynolds number read from device
// memory (an ensemble, or an Re that carries a gradient; a caller with one
// host value for the batch fills a (B,) tensor with it).  Each thread
// loads re[b] and takes its correctly rounded reciprocal (rcp_rn,
// div_rn.cuh), which equals the IEEE quotient 1/re the host takes, so a
// member's result is the host-value call's bit for bit.  (rcp_rn keeps a
// CALL to its slow path, for operands past the normal range, once a thread
// before the loads.)  One kernel template serves both calls (kBatch
// below); the 2-D host-value call's code is the one measured before
// batches existed (the member offset is compiled out of it: with it,
// ptxas kept fewer loads in flight, 48 registers against 61, and the
// 1025^2 fp32 call ran 7% slower on the H100).
//
// Backward (the adjoint of the forward, for torch.autograd; the TPU
// kernel has none, and the JAX package differentiates its XLA RHS
// instead).  The Arakawa Jacobian is antisymmetric as a trilinear form on
// the periodic grid (sum a J(b, c) = sum b J(c, a)) and the Laplacian is
// self-adjoint, so for upstream gradient g of r = -J(w, s) + lap(w)/re:
//   dL/dw = -J(s, g) + lap(g)/re,  dL/ds = -J(g, w),
//   dL/dre = -sum g lap(w) / re^2   (one value a member).
// One pass computes both fields from a register window of w, s and g, as
// the forward does for w and s (3 fields x 3 columns x kBackRows + 2 rows
// a walker; 2 or 8 rows ran 26% and 15% slower at an (8, 2048, 2048)
// batch on the H100), in the twin's expressions and order
// (ops/cuda_kernels.py arakawa_rhs_backward_plain).  It reads 3 fields and
// writes 2: 5 fields of bytes over HBM's rate bound it.  The Re gradient's sum is taken with
// no atomics, so it is the same every run: each block writes the fp64 sum
// of g lap(w) over its points (every thread's sum, then a fixed tree
// across the block) to its own slot, and a one-block second launch adds
// each member's slots in a fixed order and scales by -1/re^2.  The
// Jacobian, the Laplacian and that sum live in arakawa.cuh, which the
// packed cavity stage's backward (csrc/cavity_stage.cu) shares.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): each
// launcher runs on the caller's stream, allocates nothing (the backward's
// partial sums go to a buffer of arakawa_rhs_backward_partials(nr, nc)
// doubles a member, given by the caller), does not synchronise, and
// returns cudaGetLastError() of its launches.

#include <cuda_runtime.h>

#include "arakawa.cuh"
#include "div_rn.cuh"

namespace {

constexpr int kBlockX = 32;  // columns a block: axis 1, contiguous
constexpr int kBlockY = 4;   // column walkers a block, stacked along axis 0
constexpr int kRows = 8;     // output rows a walker computes
constexpr int kBackRows = 4; // the backward's: its window holds 3 fields

// a field's neighbourhood from its values at columns jm, j, jp ([0], [1],
// [2]) of rows W (i-1), C (i) and E (i+1)
template <typename T>
__device__ __forceinline__ Nbhd<T> nbhd(const T (&W)[3], const T (&C)[3],
                                        const T (&E)[3]) {
  return {C[1], E[1], W[1], C[2], C[0], E[2], W[0], W[2], E[0]};
}

// kFields fields at columns jm, j, jp of one row
template <typename T, int kFields>
struct Row {
  T f[kFields][3];
};

// a walker's window: rows[k] is row i0-1+k of the fields, wrapped: -1
// reads nr-1, nr and past it row 0
template <typename T, int kFields, int kWin>
__device__ __forceinline__ void load_window(
    Row<T, kFields> (&rows)[kWin], const T* const (&f)[kFields], int i0,
    int nr, int nc, int jm, int j, int jp) {
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    const int g = i0 - 1 + k;
    const int o = (g < 0 ? nr - 1 : (g >= nr ? 0 : g)) * nc;
#pragma unroll
    for (int x = 0; x < kFields; ++x) {
      rows[k].f[x][0] = f[x][o + jm];
      rows[k].f[x][1] = f[x][o + j];
      rows[k].f[x][2] = f[x][o + jp];
    }
  }
}

// kBatch false: one (nr, nc) field and the launch's re and 1/re; true:
// blockIdx.z the member, its re from re_dev[b], 1/re by rcp_rn
template <typename T, bool kBatch>
__global__ void __launch_bounds__(kBlockX * kBlockY)
arakawa_rhs_kernel(const T* __restrict__ w, const T* __restrict__ s,
                   T* __restrict__ out, int nr, int nc, T gg, T dx2,
                   T dy2, T re, T r3, T rdx2, T rdy2, T rre,
                   const T* __restrict__ re_dev) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i0 = (blockIdx.y * kBlockY + threadIdx.y) * kRows;
  if (j >= nc || i0 >= nr) return;
  const int jp = (j + 1 == nc) ? 0 : j + 1;
  const int jm = (j == 0) ? nc - 1 : j - 1;
  if constexpr (kBatch) {
    const long long member = static_cast<long long>(blockIdx.z) * nr * nc;
    w += member;
    s += member;
    out += member;
    re = re_dev[blockIdx.z];
    rre = rcp_rn(re);
  }

  Row<T, 2> rows[kRows + 2];
  const T* const f[2] = {w, s};
  load_window(rows, f, i0, nr, nc, jm, j, jp);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const Row<T, 2>& W = rows[r];
    const Row<T, 2>& C = rows[r + 1];
    const Row<T, 2>& E = rows[r + 2];
    const Nbhd<T> wn = nbhd(W.f[0], C.f[0], E.f[0]);
    const Nbhd<T> sn = nbhd(W.f[1], C.f[1], E.f[1]);
    const T res = -jacobian(wn, sn, gg, r3)
                + div_rn(laplacian(wn, dx2, dy2, rdx2, rdy2), re, rre);
    if (i0 + r < nr) out[(i0 + r) * nc + j] = res;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
arakawa_rhs_backward_kernel(const T* __restrict__ w, const T* __restrict__ s,
                            const T* __restrict__ g, T* __restrict__ gw,
                            T* __restrict__ gs, double* __restrict__ partials,
                            int nr, int nc, T gg, T dx2, T dy2, T r3,
                            T rdx2, T rdy2, const T* __restrict__ re_dev) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i0 = (blockIdx.y * kBlockY + threadIdx.y) * kBackRows;
  const long long member = static_cast<long long>(blockIdx.z) * nr * nc;
  double acc = 0.0;   // this thread's sum of g lap(w)
  if (j < nc && i0 < nr) {
    const int jp = (j + 1 == nc) ? 0 : j + 1;
    const int jm = (j == 0) ? nc - 1 : j - 1;
    const T re = re_dev[blockIdx.z];
    const T rre = rcp_rn(re);
    Row<T, 3> rows[kBackRows + 2];
    const T* const f[3] = {w + member, s + member, g + member};
    load_window(rows, f, i0, nr, nc, jm, j, jp);
#pragma unroll
    for (int r = 0; r < kBackRows; ++r) {
      const Row<T, 3>& W = rows[r];
      const Row<T, 3>& C = rows[r + 1];
      const Row<T, 3>& E = rows[r + 2];
      const Nbhd<T> wn = nbhd(W.f[0], C.f[0], E.f[0]);
      const Nbhd<T> sn = nbhd(W.f[1], C.f[1], E.f[1]);
      const Nbhd<T> gn = nbhd(W.f[2], C.f[2], E.f[2]);
      const T d_w = -jacobian(sn, gn, gg, r3)
                  + div_rn(laplacian(gn, dx2, dy2, rdx2, rdy2), re, rre);
      const T d_s = -jacobian(gn, wn, gg, r3);
      if (i0 + r < nr) {
        const long long o = member + (i0 + r) * nc + j;
        gw[o] = d_w;
        gs[o] = d_s;
        if (partials != nullptr)
          acc += static_cast<double>(
              gn.c * laplacian(wn, dx2, dy2, rdx2, rdy2));
      }
    }
  }
  if (partials == nullptr) return;
  const double total = block_sum<kBlockY>(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[(static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y)
             * gridDim.x + blockIdx.x] = total;
}

dim3 grid_of(int nr, int nc, int rows, int batch) {
  const int walkers = (nr + rows - 1) / rows;
  return dim3((nc + kBlockX - 1) / kBlockX,
              (walkers + kBlockY - 1) / kBlockY, batch);
}

bool bad_shape(int batch, int nr, int nc) {
  return batch <= 0 || batch > 65535 || nr <= 0 || nc <= 0;
}

// re_dev null: the 2-D call (batch 1) with the host value re
template <typename T>
int launch(const T* w, const T* s, T* out, const T* re_dev, int batch,
           int nr, int nc, double dx, double dy, double re, void* stream) {
  if (bad_shape(batch, nr, nc) || (re_dev == nullptr && batch != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid = grid_of(nr, nc, kRows, batch);
  const T dx2 = static_cast<T>(dx * dx), dy2 = static_cast<T>(dy * dy);
  const T re_ = static_cast<T>(re);
  const T gg = static_cast<T>(1.0 / (4.0 * dx * dy));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T r3 = T(1) / T(3), rdx2 = T(1) / dx2, rdy2 = T(1) / dy2;
  if (re_dev != nullptr)
    arakawa_rhs_kernel<T, true><<<grid, block, 0, st>>>(
        w, s, out, nr, nc, gg, dx2, dy2, T(0), r3, rdx2, rdy2, T(0), re_dev);
  else
    arakawa_rhs_kernel<T, false><<<grid, block, 0, st>>>(
        w, s, out, nr, nc, gg, dx2, dy2, re_, r3, rdx2, rdy2, T(1) / re_,
        nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const T* w, const T* s, const T* g, const T* re_dev,
                    T* gw, T* gs, double* partials, T* gre, int batch,
                    int nr, int nc, double dx, double dy, void* stream) {
  if (bad_shape(batch, nr, nc) || re_dev == nullptr ||
      (partials == nullptr) != (gre == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid = grid_of(nr, nc, kBackRows, batch);
  const T dx2 = static_cast<T>(dx * dx), dy2 = static_cast<T>(dy * dy);
  const T gg = static_cast<T>(1.0 / (4.0 * dx * dy));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  arakawa_rhs_backward_kernel<T><<<grid, block, 0, st>>>(
      w, s, g, gw, gs, partials, nr, nc, gg, dx2, dy2, T(1) / T(3),
      T(1) / dx2, T(1) / dy2, re_dev);
  if (partials != nullptr) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    re_grad_sum_kernel<T><<<1, kSumThreads, 0, st>>>(
        partials, static_cast<int>(grid.x * grid.y), batch, re_dev, 0.0, 1.0,
        gre);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the 2-D call with a host Re (a batch of one)
extern "C" int arakawa_rhs_f32(const float* w, const float* s, float* out,
                               int nr, int nc, double dx, double dy,
                               double re, void* stream) {
  return launch<float>(w, s, out, nullptr, 1, nr, nc, dx, dy, re, stream);
}

extern "C" int arakawa_rhs_f64(const double* w, const double* s, double* out,
                               int nr, int nc, double dx, double dy,
                               double re, void* stream) {
  return launch<double>(w, s, out, nullptr, 1, nr, nc, dx, dy, re, stream);
}

// (batch, nr, nc) fields; re_dev: the batch's Reynolds numbers in device
// memory
extern "C" int arakawa_rhs_batched_f32(const float* w, const float* s,
                                       float* out, const float* re_dev,
                                       int batch, int nr, int nc, double dx,
                                       double dy, void* stream) {
  if (re_dev == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(w, s, out, re_dev, batch, nr, nc, dx, dy, 0.0, stream);
}

extern "C" int arakawa_rhs_batched_f64(const double* w, const double* s,
                                       double* out, const double* re_dev,
                                       int batch, int nr, int nc, double dx,
                                       double dy, void* stream) {
  if (re_dev == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(w, s, out, re_dev, batch, nr, nc, dx, dy, 0.0,
                        stream);
}

// gw, gs from w, s, g and the batch's device Reynolds numbers; with
// partials and gre (both or neither) also gre[b] = dL/dre[b]
extern "C" int arakawa_rhs_backward_f32(const float* w, const float* s,
                                        const float* g, const float* re_dev,
                                        float* gw, float* gs,
                                        double* partials, float* gre,
                                        int batch, int nr, int nc, double dx,
                                        double dy, void* stream) {
  return launch_backward<float>(w, s, g, re_dev, gw, gs, partials, gre,
                                batch, nr, nc, dx, dy, stream);
}

extern "C" int arakawa_rhs_backward_f64(const double* w, const double* s,
                                        const double* g, const double* re_dev,
                                        double* gw, double* gs,
                                        double* partials, double* gre,
                                        int batch, int nr, int nc, double dx,
                                        double dy, void* stream) {
  return launch_backward<double>(w, s, g, re_dev, gw, gs, partials, gre,
                                 batch, nr, nc, dx, dy, stream);
}

// the backward's partial sums a member: one a block
extern "C" int arakawa_rhs_backward_partials(int nr, int nc) {
  const dim3 grid = grid_of(nr, nc, kBackRows, 1);
  return static_cast<int>(grid.x * grid.y);
}

extern "C" const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
