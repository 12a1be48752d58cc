// Arakawa's Jacobian and the 5-point Laplacian on a point's neighbourhood,
// 16-byte row loads and stores, and the Re gradient's fixed-order fp64
// sums: shared by kernel 1's forward and backward (csrc/arakawa_rhs.cu)
// and the packed cavity stage and its backward (csrc/cavity_stage.cu), so
// the adjoints take the forward's arithmetic.

#pragma once

#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

// a lane's 16 bytes of a row: 4 fp32 or 2 fp64 columns, one load or store
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load_vec(const double* __restrict__ p,
                                         double (&v)[2]) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = x.x;
  v[1] = x.y;
}

__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(double* __restrict__ p,
                                          const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// the 3 x 3 neighbourhood of a point, E/W along axis 0, N/S along axis 1
// (as in cfd_julia_torch/ops/arakawa.py)
template <typename T>
struct Nbhd {
  T c, E, W, N, S, NE, SW, NW, SE;
};

// the neighbourhood at slot j of a lane's window rows W (i-1), C (i) and E
// (i+1), slot k holding column c-1+k of the lane's first column c
template <typename T, int N>
__device__ __forceinline__ Nbhd<T> nbhd(const T (&W)[N], const T (&C)[N],
                                        const T (&E)[N], int j) {
  return {C[j],     E[j],     W[j],     C[j + 1], C[j - 1],
          E[j + 1], W[j - 1], W[j + 1], E[j - 1]};
}

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

// The Re gradient's fold counters: member b's blocks take their tickets
// from counter b % kFoldCounters
constexpr int kFoldCounters = 64;

// The Re gradient's fold into the last block: no second launch, and no
// atomics on a value.  Every block of a (gx, gy, batch) grid of 32 x kWarps
// threads calls it with its sum (`total`, thread 0's, from block_sum).
// Thread 0 writes the sum to the block's slot, partials[(z gy + y) gx + x],
// and, after a fence, takes a ticket from counter[z % kFoldCounters] (an
// atomic on the counter).  The block that takes that counter's last ticket
// (its members' blocks all done) adds, for each of its members b, the gx gy
// slots of b in a fixed order, thread t its slots t, t + 32 kWarps, ... in
// turn (8 loads at a time) and then block_sum, so the result does not
// depend on which block came last, and writes gre[b] = -(scale x the sum)
// / re_b^2 (re_b from re_dev[b], or re_host for every member if re_dev is
// null).  Then it sets the counter back to 0: the next call on the stream,
// a CUDA graph's replay too, starts from 0 with no memset.  A batch's
// members end at different times, so their sums overlap the others' walks.
template <int kWarps, typename T>
__device__ __forceinline__ void fold_re_grad(double total,
                                             double* __restrict__ partials,
                                             unsigned* __restrict__ counters,
                                             const T* __restrict__ re_dev,
                                             double re_host, double scale,
                                             T* __restrict__ gre) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kLoads = 8;
  __shared__ bool last;
  const unsigned n = gridDim.x * gridDim.y;   // slots a member
  const unsigned group = blockIdx.z % kFoldCounters;
  const int t = threadIdx.y * 32 + threadIdx.x;
  if (t == 0) {
    partials[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        total;
    __threadfence();
    const unsigned members = (gridDim.z - 1 - group) / kFoldCounters + 1;
    last = atomicAdd(counters + group, 1u) == n * members - 1u;
  }
  __syncthreads();
  if (!last) return;
  for (unsigned b = group; b < gridDim.z; b += kFoldCounters) {
    const double* p = partials + static_cast<unsigned long long>(b) * n;
    double v = 0.0;
    for (unsigned k0 = t; k0 < n; k0 += kLoads * kThreads) {
      double x[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const unsigned k = k0 + i * kThreads;
        x[i] = k < n ? __ldcg(p + k) : 0.0;
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) v += x[i];
    }
    v = block_sum<kWarps>(v);
    if (t == 0) {
      const double re =
          re_dev != nullptr ? static_cast<double>(re_dev[b]) : re_host;
      gre[b] = static_cast<T>(-(scale * v) / (re * re));
    }
    __syncthreads();   // block_sum's shared sums, read by thread 0
  }
  if (t == 0) counters[group] = 0u;
}

}  // namespace
