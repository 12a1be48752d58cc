// Arakawa's Jacobian and the 5-point Laplacian on a point's neighbourhood,
// and the Re gradient's fixed-order fp64 sum: shared by kernel 1's forward
// and backward (csrc/arakawa_rhs.cu) and the packed cavity stage's backward
// (csrc/cavity_stage.cu), so the adjoints take the forward's arithmetic.

#pragma once

#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

constexpr int kSumThreads = 256;  // the Re gradient's second launch

// the 3 x 3 neighbourhood of a point, E/W along axis 0, N/S along axis 1
// (as in cfd_julia_torch/ops/arakawa.py)
template <typename T>
struct Nbhd {
  T c, E, W, N, S, NE, SW, NW, SE;
};

// Arakawa's J(a, b), the twin's jacobian(a, b) (a in w's place)
template <typename T>
__device__ __forceinline__ T jacobian(const Nbhd<T>& a, const Nbhd<T>& b,
                                      T gg, T r3) {
  const T j1 = (a.E - a.W) * (b.N - b.S) - (a.N - a.S) * (b.E - b.W);
  const T j2 = a.E * (b.NE - b.SE) - a.W * (b.NW - b.SW)
             - a.N * (b.NE - b.NW) + a.S * (b.SE - b.SW);
  const T j3 = a.NE * (b.N - b.E) - a.SW * (b.W - b.S)
             - a.NW * (b.N - b.W) + a.SE * (b.E - b.S);
  return div_rn(gg * (j1 + j2 + j3), T(3), r3);
}

// the 5-point Laplacian, the twin's laplacian(a)
template <typename T>
__device__ __forceinline__ T laplacian(const Nbhd<T>& a, T dx2, T dy2,
                                       T rdx2, T rdy2) {
  return div_rn(a.E - T(2) * a.c + a.W, dx2, rdx2)
       + div_rn(a.N - T(2) * a.c + a.S, dy2, rdy2);
}

// fp64 sum over a block of 32 x kWarps threads (the lane threadIdx.x, the
// warp threadIdx.y), in a fixed order: each warp by shuffles, then the
// warps' sums in order; thread 0 has it
template <int kWarps>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kWarps];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if (threadIdx.x == 0) warp_sums[threadIdx.y] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
  }
  return total;
}

// d re[b] = -(scale x the sum of member b's n partials, in a fixed order)
// / re[b]^2, re[b] from re_dev, or re_host for every member if re_dev is
// null; one block of kSumThreads
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
re_grad_sum_kernel(const double* __restrict__ partials, int n, int batch,
                   const T* __restrict__ re_dev, double re_host,
                   double scale, T* __restrict__ gre) {
  __shared__ double sums[kSumThreads];
  for (int b = 0; b < batch; ++b) {
    const double* p = partials + static_cast<long long>(b) * n;
    double v = 0.0;
    for (int k = threadIdx.x; k < n; k += kSumThreads) v += p[k];
    sums[threadIdx.x] = v;
    __syncthreads();
    for (int half = kSumThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const double re =
          re_dev != nullptr ? static_cast<double>(re_dev[b]) : re_host;
      gre[b] = static_cast<T>(-(scale * sums[0]) / (re * re));
    }
    __syncthreads();
  }
}

}  // namespace
