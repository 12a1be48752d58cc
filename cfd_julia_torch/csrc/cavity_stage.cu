// One SSP-RK3 stage of the packed lid-driven cavity for Hopper (sm_90a).
//
// Replaces the XLA-fused stage of cfd_julia_tpu/models/cavity_fused.py:153-215
// (rhs, the stage combine and the validity mask of make_fused_step_fn, and the
// wall vectors of the next stage, wall_vecs :129-151).  That code is not a
// Pallas kernel: XLA fuses it into one elementwise pass over the padded
// interior, which eager PyTorch would run as ~90 launches.  One launch here:
//
//   r      = -J(wt, s) + lap(wt) / re     on the logical interior (m, n),
//            wt's wall values from the four wall vectors rl, rh, cl, ch
//   out    = the stage-k combine of w (the step's start), wt and r, masked
//            to 0 in the padding (rows >= m, columns >= n)
//   rl_o.. = the wall vorticity of psi = s (Hoffmann or Jensen), the
//            vectors the next stage reads
//
// The packed state holds the (m, n) = (nx-1, ny-1) interior in (P, Q)
// buffers, P a multiple of 8 and Q of 128 (1024^2 at the 1024^2 cavity).
// Seen from the RHS, wt is the full grid W(a, b), a in [-1, m], b in [-1, n]:
// the buffer inside, rl / rh on the rows a = -1 / m, cl / ch on the columns
// b = -1 / n, and the corners 0 at b = -1 and lid at b = n (the y-walls own
// the corners; cavity_fused.py:166-180 writes the row-wall correction first,
// then the column-wall one).  psi reads the buffer and 0 past its edge.
//
// What bounds it: device memory.  Stage 1 reads w and s and writes out, 3 x
// 1024^2 x 4 B = 12.6 MB in fp32 (3.76 us at 3.35 TB/s); stages 2 and 3 also
// read wt (16.8 MB, 5.0 us).  The wall vectors are 16 KB.  The whole call
// is a few DRAM latencies long, so what decides its time is how many bytes
// are in flight at once and how many warps the SMs hold to overlap them.
// The scalar kernel this replaces (one column a thread, 8 rows) made 7.5
// scalar loads a point, each behind a wall branch, and loaded the step-start
// w0 under a per-row branch after the previous row's store, one round trip
// a row.
//
// Design.  A warp is a walker: lane l owns the kVec = 16 / sizeof(T)
// adjacent columns c = c0 + l kVec (4 in fp32, 2 in fp64) of kRows output
// rows a0 .. a0+kRows-1, so a warp covers 32 kVec columns (a 512-byte row
// segment).  It reads each row of its window, a0-1 .. a0+kRows, as one
// 16-byte load of wt and one of s a lane, plus the step-start rows of w
// (stages 2-3), every one of them issued before any arithmetic and none
// under a branch.  A lane takes its columns c-1 and c+kVec from the lanes
// beside it (__shfl_up_sync / __shfl_down_sync); lane 0 and the others load
// the warp's two outer halo columns c0-1 and c0+32 kVec (one address each,
// so lanes 1..31 share one sector).  `out` is stored 16 bytes a lane.
//
// A walker whose whole window, halo included, lies inside rows [0, m) x
// columns [0, n) (a warp-uniform test) takes the interior path: raw loads,
// no wall logic, no mask, no wall-vector writes.  The others (the first and
// last column segments and row walkers, and the padding) take the edge
// path: the same loads at clamped addresses, then each value of the window
// replaced by its wall value by its logical row (the warp's: a branch) and
// column (the lane's, classified once: selects on wall vectors loaded with
// the window), the output masked, and the next wall vectors written: rl_o /
// rh_o by the lanes of rows 0 / m-1, cl_o / ch_o at every buffer row by the
// lane of column 0 / n-1 (0 at rows >= m), so each vector is written whole,
// by one thread an entry.  The wall vectors are read from one set of buffers
// and written to another.
//
// Geometry, from ptxas and the card (H100, kernel_ab.py; PERF.md row 7):
// kRows = 2, kWalkers = 4.  fp32 takes 95-96 registers, no spills: 5 blocks
// of 128 threads a SM (20 warps), so the 1024 blocks of a 1024^2 buffer run
// in 1.55 waves of 660; fp64 128 registers, 4 blocks a SM, 2048 blocks.
// Walkers of 4 and 8 rows (128-136 and 254 registers), blocks of 64 and 256
// threads, register caps that fit the grid in one wave (64 or 80 registers:
// spills), a shared-memory tile filled by cp.async, and walkers that share
// their boundary rows through shared memory all timed slower; the time is
// in moving the window (a copy with the same loads takes ~93% of it), not in
// the arithmetic.  cavity_stage_constant() exports the constants for the
// tests that emulate the walk.
//
// Numerics: the plain twin's expression in its order
// (ops/cuda_kernels.cavity_fused_stage_plain, JAX's order), as the scalar
// kernel computed it.  Divisions by constants of the launch (3, dx^2, dy^2,
// re) go through div_rn.cuh with reciprocals made on the host, as in
// kernel 1.  The compiler fuses products into FMAs by the code around an
// expression, so a new value can differ from the scalar kernel's by a
// rounding (kernel_ab.py prints max|new - old|, PERF.md row 7 records it);
// the wall vectors are bitwise the scalar kernel's.
//
// Backward (the adjoint of a stage, for torch.autograd; the JAX package
// takes jax.grad of its XLA stage, which has no TPU kernel).  For the
// cotangents G of out and H of the next wall vectors, with q = G on the
// logical interior (0 elsewhere), W wt extended by its walls and corners,
// S psi extended by 0, and the stage's combine a w + b wt + c r ((0, 1,
// dt) at stage 1, where wt is w; (3/4, 1/4, dt/4); (1/3, 2/3, 2 dt/3)):
//   gw  = a q,
//   dW  = c (-J(S, q) + lap(q) / re) at the interior and its one-node
//         frame: gwt = b q + dW on the interior (0 in the padding), the
//         four wall vectors' gradients on the frame (0 past the logical
//         walls; the corners are constants),
//   gs  = -c J(q, W) + the next wall vectors' adjoint of H,
//   gre = -c sum q lap(W) / re^2.
// Kernel 1's adjoint identities (sum q J(W, S) = sum W J(S, q) = sum S
// J(q, W): the Jacobian is antisymmetric as a trilinear form) hold here on
// the zero-extended grid, since every sum is over finitely many points;
// the tests hold the formulas against autograd of the twin.  A gather:
// one thread an output point of a 32 x 8 block, each reading the 3 x 3
// neighbourhoods of q, W and S from global memory under the extension's
// branches (a simple kernel; its time is in PERF.md); the threads of row 0
// also write rl's and rh's gradients, those of column 0 cl's and ch's.  So
// each output is written by one thread, with no atomics, and two calls
// agree bitwise.  The Re gradient takes each block's fp64 sum of q lap(W)
// and a one-block second launch that adds them in a fixed order (kernel
// 1's, csrc/arakawa.cuh, with its Jacobian and Laplacian).
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): the
// launchers run on the caller's stream, allocate nothing (the backward's
// partial sums go to a buffer of cavity_stage_backward_partials(P, Q)
// doubles, given by the caller), do not synchronise, and return
// cudaGetLastError() of their launches; the forward refuses
// (cudaErrorInvalidValue) a shape out of range, Q not a multiple of kVec,
// or w, wt, s, out not 16-byte aligned.

#include <cuda_runtime.h>

#include "arakawa.cuh"
#include "div_rn.cuh"

namespace {

constexpr int kWarp = 32;      // lanes a walker
constexpr int kVecBytes = 16;  // a lane's columns of a row: one 16-byte load
constexpr int kRows = 2;       // output rows a walker computes
constexpr int kWalkers = 4;    // walkers a block, stacked along axis 0

template <typename T>
constexpr int kVec = kVecBytes / static_cast<int>(sizeof(T));

template <typename T>
struct Consts {
  T gg, dx2, dy2, re, r3, rdx2, rdy2, rre;
  T lid;     // the lid term of ch and the value at the two lid corners
  T c;       // dt, dt/4 or 2 dt: the stage's factor of r
};

// one row of a lane's window: slot j is column c-1+j, j in [0, kVec+1]
template <typename T>
struct Row {
  T w[kVec<T> + 2], s[kVec<T> + 2];
};

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

// the wall vorticity of psi values s0 (next to the wall) and s1 (one further)
template <typename T>
__device__ __forceinline__ T wall_value(T s0, T s1, T h2, T rh2, int order) {
  return order == 1 ? div_rn(T(-2) * s0, h2, rh2)
                    : div_rn(T(-4) * s0 + T(0.5) * s1, h2, rh2);
}

// the stage's new value at slot j of the centre row C, between rows W (a-1)
// and E (a+1); w0 the step's start there
template <typename T, int kStage>
__device__ __forceinline__ T stage_value(const Row<T>& W, const Row<T>& C,
                                         const Row<T>& E, int j, T w0,
                                         const Consts<T>& k) {
  // E/W step along axis 0, N/S along axis 1 (slots j-1, j, j+1 are
  // columns b-1, b, b+1), as in ops/arakawa.py
  const T wc = C.w[j];
  const T wE = E.w[j], wW = W.w[j];
  const T wN = C.w[j + 1], wS = C.w[j - 1];
  const T wNE = E.w[j + 1], wSW = W.w[j - 1];
  const T wNW = W.w[j + 1], wSE = E.w[j - 1];
  const T sE = E.s[j], sW = W.s[j];
  const T sN = C.s[j + 1], sS = C.s[j - 1];
  const T sNE = E.s[j + 1], sSW = W.s[j - 1];
  const T sNW = W.s[j + 1], sSE = E.s[j - 1];

  const T j1 = (wE - wW) * (sN - sS) - (wN - wS) * (sE - sW);
  const T j2 = wE * (sNE - sSE) - wW * (sNW - sSW)
             - wN * (sNE - sNW) + wS * (sSE - sSW);
  const T j3 = wNE * (sN - sE) - wSW * (sW - sS)
             - wNW * (sN - sW) + wSE * (sE - sS);
  const T jac = div_rn(k.gg * (j1 + j2 + j3), T(3), k.r3);
  const T lap = div_rn(wE - T(2) * wc + wW, k.dx2, k.rdx2)
              + div_rn(wN - T(2) * wc + wS, k.dy2, k.rdy2);
  const T rhs = -jac + div_rn(lap, k.re, k.rre);
  if constexpr (kStage == 1)
    return wc + k.c * rhs;  // wt is w
  else if constexpr (kStage == 2)
    return T(0.75) * w0 + T(0.25) * wc + k.c * rhs;
  else
    return div_rn(w0 + T(2) * wc + k.c * rhs, T(3), k.r3);
}

// One walker: rows a0 .. a0+kRows-1 of the columns c0 .. c0+32 kVec-1.
// kEdge: the window may leave the logical interior (wall logic, masks and
// the wall vectors); otherwise it lies inside rows [0, m) x columns [0, n).
template <typename T, int kStage, bool kEdge>
__device__ __forceinline__ void walk(
    const T* __restrict__ w, const T* __restrict__ wt,
    const T* __restrict__ s, const T* __restrict__ rl,
    const T* __restrict__ rh, const T* __restrict__ cl,
    const T* __restrict__ ch, T* __restrict__ out, T* __restrict__ rl_o,
    T* __restrict__ rh_o, T* __restrict__ cl_o, T* __restrict__ ch_o, int P,
    int Q, int m, int n, int order, const Consts<T>& k, int a0, int c0) {
  constexpr int V = kVec<T>;
  constexpr int kSeg = kWarp * V;
  const int lane = threadIdx.x;
  const int c = c0 + lane * V;
  // lane 0 loads the halo column left of the segment, the others the one
  // right of it (lane 31's); addresses clamped into the buffer on the edge
  const int hc = lane == 0 ? c0 - 1 : c0 + kSeg;
  const int cv = kEdge ? min(c, Q - V) : c;
  const int hcv = kEdge ? min(max(hc, 0), Q - 1) : hc;

  // every load of the walker, before any arithmetic
  T wv[kRows + 2][V], sv[kRows + 2][V], wh[kRows + 2], sh[kRows + 2];
  T w0v[kRows][V];  // stages 2-3; stage 1 reads wt's own rows instead
#pragma unroll
  for (int q = 0; q < kRows + 2; ++q) {
    const int g = a0 - 1 + q;
    const int gv = kEdge ? min(max(g, 0), P - 1) : g;
    load_vec(wt + gv * Q + cv, wv[q]);
    load_vec(s + gv * Q + cv, sv[q]);
    wh[q] = __ldg(wt + gv * Q + hcv);
    sh[q] = __ldg(s + gv * Q + hcv);
  }
  if constexpr (kStage != 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      load_vec(w + (kEdge ? min(a0 + r, P - 1) : a0 + r) * Q + cv, w0v[r]);
  }
  // the edge path's wall values: cl, ch at the window's rows, rl, rh at the
  // lane's slot columns
  T clv[kEdge ? kRows + 2 : 1], chv[kEdge ? kRows + 2 : 1];
  T rlv[kEdge ? V + 2 : 1], rhv[kEdge ? V + 2 : 1];
  if constexpr (kEdge) {
#pragma unroll
    for (int q = 0; q < kRows + 2; ++q) {
      const int gv = min(max(a0 - 1 + q, 0), P - 1);
      clv[q] = __ldg(cl + gv);
      chv[q] = __ldg(ch + gv);
    }
#pragma unroll
    for (int j = 0; j < V + 2; ++j) {
      const int cj = min(max(c - 1 + j, 0), Q - 1);
      rlv[j] = __ldg(rl + cj);
      rhv[j] = __ldg(rh + cj);
    }
  }

  // the edge path's columns, once a lane: slot j is column cj = c-1+j;
  // inside the logical interior, the wall column -1 or n, inside the buffer
  bool cin[V + 2], cwl[V + 2], cwr[V + 2], cbuf[V + 2];
#pragma unroll
  for (int j = 0; j < V + 2; ++j) {
    const int cj = c - 1 + j;
    cin[j] = cj >= 0 && cj < n;
    cwl[j] = cj == -1;
    cwr[j] = cj == n;
    cbuf[j] = cj >= 0 && cj < Q;
  }

  // the window's rows with the columns of the lanes beside
  Row<T> rows[kRows + 2];
#pragma unroll
  for (int q = 0; q < kRows + 2; ++q) {
    const T wl = __shfl_up_sync(0xffffffffu, wv[q][V - 1], 1);
    const T wr = __shfl_down_sync(0xffffffffu, wv[q][0], 1);
    const T sl = __shfl_up_sync(0xffffffffu, sv[q][V - 1], 1);
    const T sr = __shfl_down_sync(0xffffffffu, sv[q][0], 1);
    Row<T>& R = rows[q];
    R.w[0] = lane == 0 ? wh[q] : wl;
    R.s[0] = lane == 0 ? sh[q] : sl;
    R.w[V + 1] = lane == kWarp - 1 ? wh[q] : wr;
    R.s[V + 1] = lane == kWarp - 1 ? sh[q] : sr;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      R.w[e + 1] = wv[q][e];
      R.s[e + 1] = sv[q][e];
    }
    if constexpr (kEdge) {
      // W(g, cj), wt extended by its walls: the row's kind is the warp's,
      // the column's the lane's (the y-walls own the corners)
      const int g = a0 - 1 + q;
      if (g >= 0 && g < m) {
#pragma unroll
        for (int j = 0; j < V + 2; ++j)
          R.w[j] = cin[j] ? R.w[j]
                          : cwl[j] ? clv[q] : cwr[j] ? chv[q] : T(0);
      } else if (g == -1 || g == m) {
#pragma unroll
        for (int j = 0; j < V + 2; ++j)
          R.w[j] = cin[j] ? (g < 0 ? rlv[j] : rhv[j])
                          : cwr[j] ? k.lid : T(0);
      } else {
#pragma unroll
        for (int j = 0; j < V + 2; ++j) R.w[j] = T(0);  // beyond the walls
      }
      // psi: the buffer, 0 past its edge
      const bool grow = g >= 0 && g < P;
#pragma unroll
      for (int j = 0; j < V + 2; ++j)
        R.s[j] = grow && cbuf[j] ? R.s[j] : T(0);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int a = a0 + r;
    if (kEdge && a >= P) break;
    const Row<T>& W = rows[r];
    const Row<T>& C = rows[r + 1];
    const Row<T>& E = rows[r + 2];
    T res[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      T w0 = T(0);
      if constexpr (kStage != 1) w0 = w0v[r][e];
      res[e] = stage_value<T, kStage>(W, C, E, e + 1, w0, k);
      if (kEdge && !(a < m && cin[e + 1])) res[e] = T(0);
    }
    if (!kEdge || c < Q) store_vec(out + a * Q + c, res);

    if constexpr (kEdge) {
      // the next stage's wall vectors, from this stage's (pre-solve) psi
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int b = c + e, j = e + 1;
        if (b >= Q) break;
        if (a == 0) rl_o[b] = wall_value(C.s[j], E.s[j], k.dx2, k.rdx2, order);
        if (a == m - 1)
          rh_o[b] = wall_value(C.s[j], W.s[j], k.dx2, k.rdx2, order);
        if (cwl[j - 1])  // b == 0
          cl_o[a] = a < m ? wall_value(C.s[j], C.s[j + 1], k.dy2, k.rdy2,
                                       order)
                          : T(0);
        if (cwr[j + 1])  // b == n - 1
          ch_o[a] = a < m ? wall_value(C.s[j], C.s[j - 1], k.dy2, k.rdy2,
                                       order) + k.lid
                          : T(0);
      }
    }
  }
}

template <typename T, int kStage>
__global__ void __launch_bounds__(kWarp * kWalkers)
cavity_stage_kernel(const T* __restrict__ w, const T* __restrict__ wt,
                    const T* __restrict__ s, const T* __restrict__ rl,
                    const T* __restrict__ rh, const T* __restrict__ cl,
                    const T* __restrict__ ch, T* __restrict__ out,
                    T* __restrict__ rl_o, T* __restrict__ rh_o,
                    T* __restrict__ cl_o, T* __restrict__ ch_o, int P, int Q,
                    int m, int n, int order, Consts<T> k) {
  constexpr int kSeg = kWarp * kVec<T>;
  const int c0 = blockIdx.x * kSeg;
  const int a0 = (blockIdx.y * kWalkers + threadIdx.y) * kRows;
  if (a0 >= P) return;  // the whole warp
  const bool interior = a0 >= 1 && a0 + kRows <= m - 1 && c0 >= 1 &&
                        c0 + kSeg <= n - 1;
  if (interior)
    walk<T, kStage, false>(w, wt, s, rl, rh, cl, ch, out, rl_o, rh_o, cl_o,
                           ch_o, P, Q, m, n, order, k, a0, c0);
  else
    walk<T, kStage, true>(w, wt, s, rl, rh, cl, ch, out, rl_o, rh_o, cl_o,
                          ch_o, P, Q, m, n, order, k, a0, c0);
}

bool aligned(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % kVecBytes == 0;
}

template <typename T>
int launch(const T* w, const T* wt, const T* s, const T* rl, const T* rh,
           const T* cl, const T* ch, T* out, T* rl_o, T* rh_o, T* cl_o,
           T* ch_o, int P, int Q, int m, int n, int stage, int order,
           double dt, double dx, double dy, double re, void* stream) {
  if (P <= 0 || Q <= 0 || m < 2 || n < 2 || m > P || n > Q ||
      Q % kVec<T> != 0 || !aligned(w) || !aligned(wt) || !aligned(s) ||
      !aligned(out) || (order != 1 && order != 2) || stage < 1 || stage > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSeg = kWarp * kVec<T>;
  const int walkers = (P + kRows - 1) / kRows;
  const dim3 block(kWarp, kWalkers);
  const dim3 grid((Q + kSeg - 1) / kSeg, (walkers + kWalkers - 1) / kWalkers);
  Consts<T> k;
  k.gg = static_cast<T>(1.0 / (4.0 * dx * dy));
  k.dx2 = static_cast<T>(dx * dx);
  k.dy2 = static_cast<T>(dy * dy);
  k.re = static_cast<T>(re);
  k.r3 = T(1) / T(3);
  k.rdx2 = T(1) / k.dx2;
  k.rdy2 = T(1) / k.dy2;
  k.rre = T(1) / k.re;
  k.lid = static_cast<T>(order == 2 ? -3.0 / dy : -2.0 / dy);
  k.c = static_cast<T>(stage == 1 ? dt : stage == 2 ? 0.25 * dt : 2.0 * dt);
  auto st = static_cast<cudaStream_t>(stream);
  if (stage == 1)
    cavity_stage_kernel<T, 1><<<grid, block, 0, st>>>(
        w, wt, s, rl, rh, cl, ch, out, rl_o, rh_o, cl_o, ch_o, P, Q, m, n,
        order, k);
  else if (stage == 2)
    cavity_stage_kernel<T, 2><<<grid, block, 0, st>>>(
        w, wt, s, rl, rh, cl, ch, out, rl_o, rh_o, cl_o, ch_o, P, Q, m, n,
        order, k);
  else
    cavity_stage_kernel<T, 3><<<grid, block, 0, st>>>(
        w, wt, s, rl, rh, cl, ch, out, rl_o, rh_o, cl_o, ch_o, P, Q, m, n,
        order, k);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBackX = 32;  // the backward's block: columns (a warp)
constexpr int kBackY = 8;   // and rows; a thread an output point

template <typename T>
struct BackConsts {
  T gg, dx2, dy2, re, r3, rdx2, rdy2, rre, lid;
  T a, b, c;   // the stage's combine a w + b wt + c r
  T k0, k1;    // a next wall value is (k0 s0 + k1 s1) / h^2
};

// the backward's inputs as fields on the whole plane
template <typename T>
struct BackFields {
  const T *wt, *s, *rl, *rh, *cl, *ch, *g;
  int P, Q, m, n;
  T lid;

  // wt extended: the interior, the walls on its frame, the lid corners
  __device__ __forceinline__ T W(int a, int b) const {
    const bool rin = a >= 0 && a < m, cin = b >= 0 && b < n;
    if (rin && cin) return wt[a * Q + b];
    if (cin) return a == -1 ? rl[b] : a == m ? rh[b] : T(0);
    if (rin) return b == -1 ? cl[a] : b == n ? ch[a] : T(0);
    return b == n && (a == -1 || a == m) ? lid : T(0);
  }
  // psi: the buffer, 0 past its edge
  __device__ __forceinline__ T S(int a, int b) const {
    return a >= 0 && a < P && b >= 0 && b < Q ? s[a * Q + b] : T(0);
  }
  // the cotangent of out on the logical interior, 0 elsewhere
  __device__ __forceinline__ T q(int a, int b) const {
    return a >= 0 && a < m && b >= 0 && b < n ? g[a * Q + b] : T(0);
  }
};

// the 3 x 3 neighbourhood of (a, b) of field kF: 0 W, 1 S, 2 q
template <int kF, typename T>
__device__ __forceinline__ Nbhd<T> around(const BackFields<T>& f, int a,
                                          int b) {
  auto v = [&f](int i, int j) {
    return kF == 0 ? f.W(i, j) : kF == 1 ? f.S(i, j) : f.q(i, j);
  };
  return {v(a, b),         v(a + 1, b),     v(a - 1, b),
          v(a, b + 1),     v(a, b - 1),     v(a + 1, b + 1),
          v(a - 1, b - 1), v(a - 1, b + 1), v(a + 1, b - 1)};
}

// dW / c at a point of the interior or its frame: -J(S, q) + lap(q)/re
template <typename T>
__device__ __forceinline__ T d_wt(const BackFields<T>& f,
                                  const BackConsts<T>& k, int a, int b) {
  const Nbhd<T> qn = around<2>(f, a, b);
  return -jacobian(around<1>(f, a, b), qn, k.gg, k.r3)
       + div_rn(laplacian(qn, k.dx2, k.dy2, k.rdx2, k.rdy2), k.re, k.rre);
}

template <typename T>
__global__ void __launch_bounds__(kBackX * kBackY)
cavity_stage_backward_kernel(BackFields<T> f, const T* __restrict__ h_rl,
                             const T* __restrict__ h_rh,
                             const T* __restrict__ h_cl,
                             const T* __restrict__ h_ch, T* __restrict__ gw,
                             T* __restrict__ gwt, T* __restrict__ gs,
                             T* __restrict__ g_rl, T* __restrict__ g_rh,
                             T* __restrict__ g_cl, T* __restrict__ g_ch,
                             double* __restrict__ partials, BackConsts<T> k) {
  const int b = blockIdx.x * kBackX + threadIdx.x;
  const int a = blockIdx.y * kBackY + threadIdx.y;
  const int m = f.m, n = f.n;
  double acc = 0.0;   // this thread's q lap(W)
  if (a < f.P && b < f.Q) {
    const int o = a * f.Q + b;
    const Nbhd<T> qn = around<2>(f, a, b);
    const Nbhd<T> wn = around<0>(f, a, b);
    T v = k.c * -jacobian(qn, wn, k.gg, k.r3);
    // the next wall vectors' adjoint, in the plain version's order
    if (a == 0) v += div_rn(k.k0 * h_rl[b], k.dx2, k.rdx2);
    if (k.k1 != T(0) && a == 1) v += div_rn(k.k1 * h_rl[b], k.dx2, k.rdx2);
    if (a == m - 1) v += div_rn(k.k0 * h_rh[b], k.dx2, k.rdx2);
    if (k.k1 != T(0) && a == m - 2)
      v += div_rn(k.k1 * h_rh[b], k.dx2, k.rdx2);
    if (a < m) {
      if (b == 0) v += div_rn(k.k0 * h_cl[a], k.dy2, k.rdy2);
      if (k.k1 != T(0) && b == 1)
        v += div_rn(k.k1 * h_cl[a], k.dy2, k.rdy2);
      if (b == n - 1) v += div_rn(k.k0 * h_ch[a], k.dy2, k.rdy2);
      if (k.k1 != T(0) && b == n - 2)
        v += div_rn(k.k1 * h_ch[a], k.dy2, k.rdy2);
    }
    gs[o] = v;
    if (a < m && b < n) {
      gwt[o] = k.b * qn.c + k.c * d_wt(f, k, a, b);
      if (partials != nullptr)
        acc = static_cast<double>(
            qn.c * laplacian(wn, k.dx2, k.dy2, k.rdx2, k.rdy2));
    } else {
      gwt[o] = T(0);
    }
    if (gw != nullptr) gw[o] = k.a * qn.c;
    // the frame: rows -1 and m by row 0's threads, columns -1 and n by
    // column 0's
    if (a == 0) {
      g_rl[b] = b < n ? k.c * d_wt(f, k, -1, b) : T(0);
      g_rh[b] = b < n ? k.c * d_wt(f, k, m, b) : T(0);
    }
    if (b == 0) {
      g_cl[a] = a < m ? k.c * d_wt(f, k, a, -1) : T(0);
      g_ch[a] = a < m ? k.c * d_wt(f, k, a, n) : T(0);
    }
  }
  if (partials == nullptr) return;   // the whole grid
  const double total = block_sum<kBackY>(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

dim3 back_grid(int P, int Q) {
  return dim3((Q + kBackX - 1) / kBackX, (P + kBackY - 1) / kBackY);
}

template <typename T>
int launch_backward(const T* wt, const T* s, const T* rl, const T* rh,
                    const T* cl, const T* ch, const T* g, const T* h_rl,
                    const T* h_rh, const T* h_cl, const T* h_ch, T* gw,
                    T* gwt, T* gs, T* g_rl, T* g_rh, T* g_cl, T* g_ch,
                    double* partials, T* gre, int P, int Q, int m, int n,
                    int stage, int order, double dt, double dx, double dy,
                    double re, void* stream) {
  if (P <= 0 || Q <= 0 || m < 2 || n < 2 || m > P || n > Q ||
      static_cast<long long>(P) * Q >= (1LL << 31) ||
      (order != 1 && order != 2) || stage < 1 || stage > 3 ||
      (partials == nullptr) != (gre == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static const double kA[] = {0.0, 0.75, 1.0 / 3.0};
  static const double kB[] = {1.0, 0.25, 2.0 / 3.0};
  static const double kC[] = {1.0, 0.25, 2.0 / 3.0};
  const double c = kC[stage - 1] * dt;
  BackConsts<T> k;
  k.gg = static_cast<T>(1.0 / (4.0 * dx * dy));
  k.dx2 = static_cast<T>(dx * dx);
  k.dy2 = static_cast<T>(dy * dy);
  k.re = static_cast<T>(re);
  k.r3 = T(1) / T(3);
  k.rdx2 = T(1) / k.dx2;
  k.rdy2 = T(1) / k.dy2;
  k.rre = T(1) / k.re;
  k.lid = static_cast<T>(order == 2 ? -3.0 / dy : -2.0 / dy);
  k.a = static_cast<T>(kA[stage - 1]);
  k.b = static_cast<T>(kB[stage - 1]);
  k.c = static_cast<T>(c);
  k.k0 = static_cast<T>(order == 1 ? -2.0 : -4.0);
  k.k1 = static_cast<T>(order == 1 ? 0.0 : 0.5);
  const BackFields<T> f{wt, s, rl, rh, cl, ch, g, P, Q, m, n, k.lid};
  const dim3 grid = back_grid(P, Q);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cavity_stage_backward_kernel<T><<<grid, dim3(kBackX, kBackY), 0, st>>>(
      f, h_rl, h_rh, h_cl, h_ch, gw, gwt, gs, g_rl, g_rh, g_cl, g_ch,
      partials, k);
  if (partials != nullptr) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    re_grad_sum_kernel<T><<<1, kSumThreads, 0, st>>>(
        partials, static_cast<int>(grid.x * grid.y), 1, nullptr, re, c, gre);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define CAVITY_STAGE_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const T* w, const T* wt, const T* s, const T* rl,     \
                      const T* rh, const T* cl, const T* ch, T* out,        \
                      T* rl_o, T* rh_o, T* cl_o, T* ch_o, int P, int Q,     \
                      int m, int n, int stage, int order, double dt,        \
                      double dx, double dy, double re, void* stream) {      \
    return launch<T>(w, wt, s, rl, rh, cl, ch, out, rl_o, rh_o, cl_o, ch_o, \
                     P, Q, m, n, stage, order, dt, dx, dy, re, stream);     \
  }

CAVITY_STAGE_LAUNCHER(cavity_stage_f32, float)
CAVITY_STAGE_LAUNCHER(cavity_stage_f64, double)

// gw (null at stage 1, or not wanted), gwt, gs and the wall vectors'
// gradients from the stage's inputs wt, s, rl, rh, cl, ch and the
// cotangents g, h_*; with partials and gre (both or neither) also gre =
// dL/dre, one value
#define CAVITY_STAGE_BACKWARD_LAUNCHER(NAME, T)                              \
  extern "C" int NAME(const T* wt, const T* s, const T* rl, const T* rh,    \
                      const T* cl, const T* ch, const T* g, const T* h_rl,  \
                      const T* h_rh, const T* h_cl, const T* h_ch, T* gw,   \
                      T* gwt, T* gs, T* g_rl, T* g_rh, T* g_cl, T* g_ch,    \
                      double* partials, T* gre, int P, int Q, int m, int n, \
                      int stage, int order, double dt, double dx,           \
                      double dy, double re, void* stream) {                 \
    return launch_backward<T>(wt, s, rl, rh, cl, ch, g, h_rl, h_rh, h_cl,   \
                              h_ch, gw, gwt, gs, g_rl, g_rh, g_cl, g_ch,    \
                              partials, gre, P, Q, m, n, stage, order, dt,  \
                              dx, dy, re, stream);                          \
  }

CAVITY_STAGE_BACKWARD_LAUNCHER(cavity_stage_backward_f32, float)
CAVITY_STAGE_BACKWARD_LAUNCHER(cavity_stage_backward_f64, double)

// the backward's partial sums of the Re gradient: one a block
extern "C" int cavity_stage_backward_partials(int P, int Q) {
  const dim3 grid = back_grid(P, Q);
  return static_cast<int>(grid.x * grid.y);
}

// the walk's geometry, for the tests that emulate it: 0 rows a walker,
// 1 walkers a block, 2 bytes a lane loads of a row, 3 lanes a walker
extern "C" int cavity_stage_constant(int which) {
  switch (which) {
    case 0: return kRows;
    case 1: return kWalkers;
    case 2: return kVecBytes;
    case 3: return kWarp;
    default: return -1;
  }
}
