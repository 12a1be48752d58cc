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
//   dL/dre = -sum g lap(w) / re^2   (one value a member),
// in the twin's expressions and order (ops/cuda_kernels.py
// arakawa_rhs_backward_plain).  It reads 3 fields and writes 2: 5 fields
// of bytes over HBM's rate bound it.
//
// Backward design: a warp is a walker (kernel 7's backward's walk,
// csrc/cavity_stage.cu, without the walls) down a strip of rows.  Where a
// row is 16-byte aligned (nc a multiple of kVec = 16 / sizeof(T) and the
// five arrays on 16-byte boundaries: the 2048^2 vortex field, the
// ensemble's batch, the even-width fp64 framed blocks), lane l owns the
// kVec adjacent columns c = c0 + l kVec and reads each row of the window
// as one 16-byte load a field; otherwise (the cavity's 1025^2, the odd and
// the fp32 framed blocks) it owns one column, and a warp still reads one
// contiguous 128-byte row segment.  A lane takes columns c-1 and c+kVec
// from the lanes beside it (__shfl_up_sync / __shfl_down_sync); lane 0
// loads the column left of the warp's segment, the other lanes the one
// right of its last column, one address each, so the periodic wrap is
// resolved once a segment: a lane past nc (the ragged last segment, nc <
// 32 kVec) loads at a clamped address, hands its right halo to the lane
// before it as that lane's right column (column 0 after the last one), and
// stores nothing; with nc = 1 or 2 the neighbours alias, as they must.
// The window is a ring: each row of the strip and its two halo rows (-1
// wraps to nr-1, nr to 0) is loaded once, kBackAhead rows before it joins
// the three rows in use, under no lane's own branch (whether a row exists
// is the warp's: a strip's row count); gw and gs are stored as the window
// was read, 16 bytes or one value a lane.  The one-value-a-
// thread-a-column window this replaces loaded columns jm, j and jp of the
// 3 fields apart over 4-row walkers, 13.5 loads a point; a strip loads
// 6 (rows + 2) / rows a point with one-column lanes, 1 / kVec of that with
// 16-byte lanes.
//
// The strips' length is set at launch (back_rows): the fewest waves of
// the walkers the card holds at once (its SMs x the kernel's blocks an SM,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) that cover the call with
// kMaxRows-row strips, then as many strips as those waves hold, each as
// short as that allows and at least kMinRows rows (chip_smoke.py phase 2
// prints each timed shape's).  A fixed strip left a part-filled last wave
// of short-lived blocks, and each block's ticket (below) holds its SM slot
// for two round trips.
//
// The Re gradient's sum takes no atomics on a value, so it is the same
// every run on one card: each lane adds g lap(w) over its points in fp64
// (rows, then its columns), block_sum adds a block's lanes in a fixed
// order into the block's own slot, and the last block of a member to
// finish (a ticket from a completion counter the caller owns,
// csrc/arakawa.cuh fold_re_grad) adds the member's slots in a fixed order,
// scales by -1/re^2 and sets the counter back to 0.  A call with d/dRe is
// one launch.  The sum's order follows the strips, so the bits of gre
// follow the card's capacity.  The Jacobian, the Laplacian and the fold
// live in arakawa.cuh, which the packed cavity stage's backward
// (csrc/cavity_stage.cu) shares.
//
// Backward geometry, from ptxas and the card (NVIDIA H100 80GB HBM3,
// 700 W; kernel_ab.py in turns with the one-value-a-thread kernel,
// PERF.md row 1): kBackWalkers = 4, kBackAhead = 3, strips of at most 32
// rows in fp32 and 48 in fp64; fp32 takes 94 registers (one-column lanes)
// and 206 (16-byte lanes), fp64 164 and 250, no spills.  Timed and
// slower: 4-row walkers with every window load issued first (192
// registers; 2048^2 no faster than the old kernel, fp64 1025^2 12%
// slower), fixed walkers of 2, 8 and 16 rows, 1, 2 and 8 walkers a block,
// rings of 1, 2 and 4 rows, strips of at most 8 rows, of 64 (fp64 2048^2
// 13% slower) and of 32 in fp64 (2050^2 2% slower than the old kernel),
// 48 in fp32 (the batch 5% slower), a cap of 3 blocks an SM (168
// registers, spills: 2048^2 43% slower), columns c-1 and c+1 loaded in
// place of the one-column lanes' shuffles (118 and 198 registers; fp64
// 1025^2 25% slower), one-column lanes for fp64's aligned rows (2048^2
// 20% slower), and an acquire-release atomic in place of __threadfence()
// and atomicAdd (no change).  One counter for a whole batch left its fold
// in the tail (31 us at the 8-member batch, as the old second launch); a
// counter a member overlaps the folds.  Without d/dRe the one-column
// lanes run 3-12% slower than the old kernel (its loads hit L1 as cheaply
// as the shuffles): the shapes' gain is the Re sum's launch folded away.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): each
// launcher runs on the caller's stream, allocates nothing (the backward's
// partial sums go to a buffer of arakawa_rhs_backward_partials(nr, nc)
// doubles a member and its completion counter to one unsigned int that is
// 0 between calls, both given by the caller), does not synchronise, and
// returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <algorithm>

#include "arakawa.cuh"
#include "div_rn.cuh"

namespace {

constexpr int kBlockX = 32;  // columns a block: axis 1, contiguous
constexpr int kBlockY = 4;   // column walkers a block, stacked along axis 0
constexpr int kRows = 8;     // output rows a walker computes

// the backward's walk: a warp (kBlockX lanes) a walker of a strip of rows
constexpr int kVecBytes = 16;    // an aligned lane's columns: one 16-byte load
constexpr int kBackWalkers = 4;  // walkers a block, stacked along axis 0
constexpr int kBackAhead = 3;    // window rows in flight ahead of the window
constexpr int kMinRows = 4;      // rows a walker's strip holds, at least
constexpr int kMaxRows = 32;     // and at most in fp32
constexpr int kMaxRows64 = 48;   // and in fp64
constexpr int kMaxDevices = 64;  // devices whose capacity is kept

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

// a lane's V adjacent columns of a row: one 16-byte load or store (V > 1,
// arakawa.cuh), or one value
template <typename T, int V>
__device__ __forceinline__ void load_cols(const T* __restrict__ p,
                                          T (&v)[V]) {
  if constexpr (V == 1)
    v[0] = __ldg(p);
  else
    load_vec(p, v);
}

template <typename T, int V>
__device__ __forceinline__ void store_cols(T* __restrict__ p,
                                           const T (&v)[V]) {
  if constexpr (V == 1)
    p[0] = v[0];
  else
    store_vec(p, v);
}

// one window row of a lane as loaded: its V columns and its halo column
// of w, s and g
template <typename T, int V>
struct RawRow {
  T v[3][V], h[3];
};

template <typename T, int V>
__device__ __forceinline__ void load_row(RawRow<T, V>& x,
                                         const T* const (&f)[3], int o,
                                         int cv, int hc) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    load_cols<T, V>(f[k] + o + cv, x.v[k]);
    x.h[k] = __ldg(f[k] + o + hc);
  }
}

// a window row of the three fields, slot j column c-1+j: the columns
// beside the lane's from the lanes beside it, the segment's ends from the
// halos (lane 0 the left, the others the right one); a lane past nc hands
// its halo to the lane before it
template <typename T, int V>
__device__ __forceinline__ void shuffle_row(T (&win)[3][V + 2],
                                            const RawRow<T, V>& x, bool own,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T left = __shfl_up_sync(0xffffffffu, x.v[k][V - 1], 1);
    const T right =
        __shfl_down_sync(0xffffffffu, own ? x.v[k][0] : x.h[k], 1);
    win[k][0] = lane == 0 ? x.h[k] : left;
    win[k][V + 1] = lane == kBlockX - 1 ? x.h[k] : right;
#pragma unroll
    for (int e = 0; e < V; ++e) win[k][e + 1] = x.v[k][e];
  }
}

// V columns a lane (16 / sizeof(T), or 1), a strip of `rows` output rows
// a walker, K window rows in flight (a ring of K loaded rows ahead of the
// 3 rows in use); blockIdx.z the member, its Re from re_dev; with partials
// (and counters, gre) also gre = dL/dre, folded into the last block
template <typename T, int V, int K>
__global__ void __launch_bounds__(kBlockX * kBackWalkers)
arakawa_rhs_backward_kernel(const T* __restrict__ w, const T* __restrict__ s,
                            const T* __restrict__ g, T* __restrict__ gw,
                            T* __restrict__ gs, double* __restrict__ partials,
                            unsigned* __restrict__ counters,
                            T* __restrict__ gre, int nr, int nc, int rows,
                            T gg, T dx2, T dy2, T r3, T rdx2, T rdy2,
                            const T* __restrict__ re_dev) {
  constexpr int kSeg = kBlockX * V;
  constexpr int U = K % 3 == 0 ? K : 3 * K;   // both rings' period, rows
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kSeg;
  const int c = c0 + lane * V;
  const int a0 = (blockIdx.y * kBackWalkers + threadIdx.y) * rows;
  const long long member = static_cast<long long>(blockIdx.z) * nr * nc;
  const bool want_re = partials != nullptr;
  double acc = 0.0;   // this lane's sum of g lap(w)
  if (a0 < nr) {      // the whole warp
    const int n = min(rows, nr - a0);   // the strip's output rows
    const T re = re_dev[blockIdx.z];
    const T rre = rcp_rn(re);
    // a lane past nc loads at a clamped address and stores nothing; lane 0
    // loads the column left of the segment, the others the one right of
    // its last column (wrapped)
    const bool own = c < nc;
    const int cv = own ? c : nc - V;
    const int end = min(c0 + kSeg, nc);
    const int hc = lane == 0 ? (c0 == 0 ? nc - 1 : c0 - 1)
                             : (end == nc ? 0 : end);
    const T* const f[3] = {w + member, s + member, g + member};
    // window row q is row a0-1+q, wrapped: -1 reads nr-1, nr and past it
    // 0; rows 0 .. n+1 are read, each once
    const auto offset = [&](int q) {
      const int row = a0 - 1 + q;
      return (row < 0 ? nr - 1 : (row >= nr ? 0 : row)) * nc;
    };
    RawRow<T, V> raw[K];   // row q in raw[q % K] until it joins the window
    T win[3][3][V + 2];    // window row q in win[q % 3]
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (q < n + 2) load_row(raw[q], f, offset(q), cv, hc);
    // row q joins the window; row q + K takes its ring slot
    const auto take = [&](int q, T (&into)[3][V + 2], RawRow<T, V>& slot) {
      shuffle_row(into, slot, own, lane);
      if (q + K < n + 2) load_row(slot, f, offset(q + K), cv, hc);
    };
    take(0, win[0], raw[0]);
    take(1, win[1], raw[1 % K]);
    for (int r0 = 0; r0 < n; r0 += U) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int r = r0 + j;
        if (r >= n) break;
        take(r + 2, win[(j + 2) % 3], raw[(j + 2) % K]);
        const auto& W = win[j % 3];
        const auto& C = win[(j + 1) % 3];
        const auto& E = win[(j + 2) % 3];
        T dw[V], ds[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const Nbhd<T> wn = nbhd(W[0], C[0], E[0], e + 1);
          const Nbhd<T> sn = nbhd(W[1], C[1], E[1], e + 1);
          const Nbhd<T> gn = nbhd(W[2], C[2], E[2], e + 1);
          dw[e] = -jacobian(sn, gn, gg, r3)
                + div_rn(laplacian(gn, dx2, dy2, rdx2, rdy2), re, rre);
          ds[e] = -jacobian(gn, wn, gg, r3);
          if (want_re && own)
            acc += static_cast<double>(
                gn.c * laplacian(wn, dx2, dy2, rdx2, rdy2));
        }
        if (own) {
          const long long at =
              member + static_cast<long long>(a0 + r) * nc + c;
          store_cols<T, V>(gw + at, dw);
          store_cols<T, V>(gs + at, ds);
        }
      }
    }
  }
  if (!want_re) return;   // the whole grid
  fold_re_grad<kBackWalkers>(block_sum<kBackWalkers>(acc), partials,
                             counters, re_dev, 0.0, 1.0, gre);
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

bool aligned(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % kVecBytes == 0;
}

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// the backward's grid: kBlockX V columns by kBackWalkers walkers of strips
// of `rows` rows a block, a member a z slice
dim3 back_grid(int V, int rows, int nr, int nc, int batch) {
  return dim3(ceil_div(nc, kBlockX * V),
              ceil_div(ceil_div(nr, rows), kBackWalkers), batch);
}

// the walkers a device holds at once with the kernel of V columns a lane:
// its SMs times the blocks of the kernel an SM holds, times kBackWalkers
template <typename T, int V>
int back_capacity() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 1, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, arakawa_rhs_backward_kernel<T, V, kBackAhead>,
      kBlockX * kBackWalkers, 0);
  const int cap = sms * per_sm * kBackWalkers;
  if (dev < kMaxDevices) cached[dev] = cap;
  return cap > 0 ? cap : 1;
}

// rows a walker's strip: the fewest waves of `capacity` resident walkers
// that hold the call with strips of `most` rows, then as many strips as
// those waves hold, each as short as that allows (kMinRows .. most)
int back_rows(int nr, int nc, int batch, int V, int capacity, int most) {
  const long long units = static_cast<long long>(ceil_div(nc, kBlockX * V))
                        * batch;   // walkers side by side
  const long long waves =
      (units * ceil_div(nr, most) + capacity - 1) / capacity;
  const long long strips = std::max(1LL, waves * capacity / units);
  return std::min(most, std::max(kMinRows, ceil_div(nr, strips)));
}

template <typename T>
constexpr int kMostRows = sizeof(T) == 8 ? kMaxRows64 : kMaxRows;

template <typename T>
int launch_backward(const T* w, const T* s, const T* g, const T* re_dev,
                    T* gw, T* gs, double* partials, unsigned* counters,
                    T* gre, int batch, int nr, int nc, double dx, double dy,
                    void* stream) {
  if (bad_shape(batch, nr, nc) || re_dev == nullptr ||
      (partials == nullptr) != (gre == nullptr) ||
      (partials == nullptr) != (counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = kVecBytes / static_cast<int>(sizeof(T));
  const dim3 block(kBlockX, kBackWalkers);
  const T dx2 = static_cast<T>(dx * dx), dy2 = static_cast<T>(dy * dy);
  const T gg = static_cast<T>(1.0 / (4.0 * dx * dy));
  const T r3 = T(1) / T(3), rdx2 = T(1) / dx2, rdy2 = T(1) / dy2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nc % V == 0 && aligned(w) && aligned(s) && aligned(g) && aligned(gw) &&
      aligned(gs)) {
    const int rows = back_rows(nr, nc, batch, V, back_capacity<T, V>(),
                               kMostRows<T>);
    arakawa_rhs_backward_kernel<T, V, kBackAhead>
        <<<back_grid(V, rows, nr, nc, batch), block, 0, st>>>(
            w, s, g, gw, gs, partials, counters, gre, nr, nc, rows, gg, dx2,
            dy2, r3, rdx2, rdy2, re_dev);
  } else {
    const int rows = back_rows(nr, nc, batch, 1, back_capacity<T, 1>(),
                               kMostRows<T>);
    arakawa_rhs_backward_kernel<T, 1, kBackAhead>
        <<<back_grid(1, rows, nr, nc, batch), block, 0, st>>>(
            w, s, g, gw, gs, partials, counters, gre, nr, nc, rows, gg, dx2,
            dy2, r3, rdx2, rdy2, re_dev);
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
// partials, counter and gre (all or none) also gre[b] = dL/dre[b]
extern "C" int arakawa_rhs_backward_f32(const float* w, const float* s,
                                        const float* g, const float* re_dev,
                                        float* gw, float* gs,
                                        double* partials, unsigned* counters,
                                        float* gre, int batch, int nr,
                                        int nc, double dx, double dy,
                                        void* stream) {
  return launch_backward<float>(w, s, g, re_dev, gw, gs, partials, counters,
                                gre, batch, nr, nc, dx, dy, stream);
}

extern "C" int arakawa_rhs_backward_f64(const double* w, const double* s,
                                        const double* g, const double* re_dev,
                                        double* gw, double* gs,
                                        double* partials, unsigned* counters,
                                        double* gre, int batch, int nr,
                                        int nc, double dx, double dy,
                                        void* stream) {
  return launch_backward<double>(w, s, g, re_dev, gw, gs, partials, counters,
                                 gre, batch, nr, nc, dx, dy, stream);
}

// the backward's partial sums a member: one a block of the largest of its
// grids (16-byte lanes of fp32 and fp64, one-column lanes, strips of
// kMinRows rows); a launch uses the first of them
extern "C" int arakawa_rhs_backward_partials(int nr, int nc) {
  unsigned most = 0;
  for (int V : {kVecBytes / 4, kVecBytes / 8, 1}) {
    const dim3 d = back_grid(V, kMinRows, nr, nc, 1);
    most = d.x * d.y > most ? d.x * d.y : most;
  }
  return static_cast<int>(most);
}

// the walkers the current device holds at once with the backward kernel
// of 16-byte lanes (vec 1) or one-column lanes (vec 0), fp64 (1) or fp32
// (0)
extern "C" int arakawa_rhs_backward_capacity(int f64, int vec) {
  return f64 ? (vec ? back_capacity<double, kVecBytes / 8>()
                    : back_capacity<double, 1>())
             : (vec ? back_capacity<float, kVecBytes / 4>()
                    : back_capacity<float, 1>());
}

// the rows of a walker's strip a (batch, nr, nc) call of that kernel takes
// on the current device
extern "C" int arakawa_rhs_backward_rows(int batch, int nr, int nc, int f64,
                                         int vec) {
  const int V = vec ? kVecBytes / (f64 ? 8 : 4) : 1;
  return back_rows(nr, nc, batch, V, arakawa_rhs_backward_capacity(f64, vec),
                   f64 ? kMaxRows64 : kMaxRows);
}

// the backward's walk, for the tests that emulate it and the wrapper: 0
// rows a strip holds at least, 1 at most in fp32, 2 walkers a block, 3
// bytes an aligned lane loads of a row, 4 lanes a walker, 5 window rows in
// flight, 6 the Re fold's counters (the unsigned ints of the buffer the
// caller gives both backward kernels), 7 rows a strip holds at most in
// fp64
extern "C" int arakawa_rhs_backward_constant(int which) {
  switch (which) {
    case 0: return kMinRows;
    case 1: return kMaxRows;
    case 2: return kBackWalkers;
    case 3: return kVecBytes;
    case 4: return kBlockX;
    case 5: return kBackAhead;
    case 6: return kFoldCounters;
    case 7: return kMaxRows64;
    default: return -1;
  }
}

extern "C" const char* cfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
