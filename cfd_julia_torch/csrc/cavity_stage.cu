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
// the tests hold the formulas against autograd of the twin.
//
// The backward's design is the forward's walk on three fields.  It reads q
// (g), W (wt) and S (s) and writes gs, gwt and gw (stages 2-3): 6 fields
// of 1024^2 fp32, 25.2 MB, 7.5 us at 3.35 TB/s, so it too is bound by
// device memory.  A warp is a walker: lane l owns the kVec columns c = c0
// + l kVec of kBackRows output rows, reads each row of its window (rows
// a0-1 .. a0+kBackRows) of g, wt and s as one 16-byte load a field, and
// the two halo columns as the forward does, every load before any
// arithmetic and none under a branch; the columns beside its own come by
// shuffles.  A walker whose window lies inside rows [1, m-2] x columns
// [1, n-2] and whose output rows and columns miss 0, 1, m-2, m-1 and 0,
// 1, n-2, n-1 (a warp-uniform test) takes the raw path: no extension, no
// mask, no wall terms.  The edge path clamps its addresses and extends
// each field its own way: q by 0 past the logical interior (m, n), S by 0
// past the buffer (P, Q) (so psi's padding values are read), W by the
// wall vectors on the frame and the lid at the corners (-1, n), (m, n).
// It adds the next wall vectors' adjoint of H into gs on rows 0, 1, m-2,
// m-1 and columns 0, 1, n-2, n-1 (k1's only under bc_order 2) in the
// plain version's order, writes gwt = 0 in the padding, and writes the
// frame's gradients: rl's and rh's by the walkers of rows 0 and m-1, one
// lane an entry, cl's and ch's by the lanes of columns 0 and n-1, one an
// output row.  dW on the frame row -1 needs row -2, past the buffer (0);
// on row m it needs row m+1, whose psi values meet only differences of q
// between points past the interior (0) and q there (0), so both are taken
// as 0, and the same for the columns -2 and n+1: the frame needs no load
// beyond the window.  gs, gwt and gw are stored 16 bytes a lane, every
// output by one thread, with no atomics.  Each lane adds q lap(W) over its
// points in fp64 in a fixed order, the block adds its lanes by block_sum
// (csrc/arakawa.cuh) into its own slot, and the last block to finish adds
// the slots in a fixed order and scales them (fold_re_grad, kernel 1's,
// csrc/arakawa.cuh, with its Jacobian and Laplacian), so two calls agree
// bitwise and a call with d/dRe is one launch.
//
// Backward geometry, from ptxas and the card (NVIDIA H100 80GB HBM3,
// 700 W; kernel_ab.py, PERF.md row 7): kBackRows = 2, kBackWalkers = 4.
// fp32 takes 128 registers, fp64 162, no spills: 4 and 3 blocks of 128
// threads a SM.  At the 1024^2 buffer, fp32, stage 2 the kernel runs
// 14.8 us (torch.profiler), half its 7.5 us bound, and a copy with the
// same loads and stores and no stencil takes 12.2 us of that; walkers of
// 1 and 4 rows (108 and 185 registers), blocks of 2 and 8 walkers and a
// cap of 96 registers (spills) all timed slower.  The gather this
// replaces (a thread an output point, each 3 x 3 neighbourhood read from
// global memory under the extensions' branches, ~36 loads a point) took
// 22.4 us.  cavity_stage_constant() exports kBackRows and kBackWalkers
// beside the forward's constants.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): the
// launchers run on the caller's stream, allocate nothing (the backward's
// partial sums go to a buffer of cavity_stage_backward_partials(P, Q)
// doubles and its completion counter to one unsigned int that is 0
// between calls, both given by the caller), do not synchronise, and
// return cudaGetLastError() of their launch; both refuse
// (cudaErrorInvalidValue) a shape out of range or Q not a multiple of
// kVec, the forward w, wt, s, out and the backward wt, s, g, gw, gwt, gs
// not 16-byte aligned.

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

constexpr int kBackRows = 2;     // output rows a backward walker computes
constexpr int kBackWalkers = 4;  // backward walkers a block, along axis 0

template <typename T>
struct BackConsts {
  T gg, dx2, dy2, re, r3, rdx2, rdy2, rre, lid;
  T a, b, c;   // the stage's combine a w + b wt + c r
  T k0, k1;    // a next wall value is (k0 s0 + k1 s1) / h^2
};

// the backward's buffers: the stage's inputs, the cotangents g (of out)
// and h_* (of the next wall vectors), the gradients; gw null at stage 1
template <typename T>
struct BackArgs {
  const T *wt, *s, *rl, *rh, *cl, *ch, *g, *h_rl, *h_rh, *h_cl, *h_ch;
  T *gw, *gwt, *gs, *g_rl, *g_rh, *g_cl, *g_ch;
  int P, Q, m, n;
};

// one row of a backward lane's window, slot j column c-1+j: q (the
// cotangent), W (wt extended) and S (psi extended)
template <typename T>
struct BackRow {
  T q[kVec<T> + 2], w[kVec<T> + 2], s[kVec<T> + 2];
};

// the same at slot 0 with the column left of it 0 (column -2 of the frame
// column -1: past the buffer)
template <typename T, int N>
__device__ __forceinline__ Nbhd<T> nbhd_left0(const T (&W)[N],
                                              const T (&C)[N],
                                              const T (&E)[N]) {
  return {C[0], E[0], W[0], C[1], T(0), E[1], T(0), W[1], T(0)};
}

// the same at slot j with the column right of it 0 (column n+1 of the
// frame column n: psi's value there meets only q differences that are 0)
template <typename T, int N>
__device__ __forceinline__ Nbhd<T> nbhd_right0(const T (&W)[N],
                                               const T (&C)[N],
                                               const T (&E)[N], int j) {
  return {C[j], E[j], W[j], T(0), C[j - 1], T(0), W[j - 1], T(0), E[j - 1]};
}

// dW / c at a point of the interior or its frame: -J(S, q) + lap(q)/re
template <typename T>
__device__ __forceinline__ T d_wt(const Nbhd<T>& sn, const Nbhd<T>& qn,
                                  const BackConsts<T>& k) {
  return -jacobian(sn, qn, k.gg, k.r3)
       + div_rn(laplacian(qn, k.dx2, k.dy2, k.rdx2, k.rdy2), k.re, k.rre);
}

// One backward walker: rows a0 .. a0+kBackRows-1 of the columns c0 ..
// c0+32 kVec-1; returns the lane's fp64 sum of q lap(W) over its points
// (0 unless want_re).  kEdge: the window may leave the logical interior (the
// extensions, masks, the next walls' adjoint, the frame's gradients);
// otherwise it lies inside rows [1, m-2] x columns [1, n-2].
template <typename T, bool kEdge>
__device__ __forceinline__ double back_walk(const BackArgs<T>& f,
                                            const BackConsts<T>& k,
                                            bool want_re, int a0, int c0) {
  constexpr int V = kVec<T>;
  constexpr int kSeg = kWarp * V;
  constexpr int R = kBackRows;
  const int P = f.P, Q = f.Q, m = f.m, n = f.n;
  const int lane = threadIdx.x;
  const int c = c0 + lane * V;
  const int hc = lane == 0 ? c0 - 1 : c0 + kSeg;
  const int cv = kEdge ? min(c, Q - V) : c;
  const int hcv = kEdge ? min(max(hc, 0), Q - 1) : hc;

  // every load of the window, before any arithmetic
  T qv[R + 2][V], wv[R + 2][V], sv[R + 2][V];
  T qh[R + 2], wh[R + 2], sh[R + 2];
#pragma unroll
  for (int i = 0; i < R + 2; ++i) {
    const int g = a0 - 1 + i;
    const int row = (kEdge ? min(max(g, 0), P - 1) : g) * Q;
    load_vec(f.g + row + cv, qv[i]);
    load_vec(f.wt + row + cv, wv[i]);
    load_vec(f.s + row + cv, sv[i]);
    qh[i] = __ldg(f.g + row + hcv);
    wh[i] = __ldg(f.wt + row + hcv);
    sh[i] = __ldg(f.s + row + hcv);
  }
  // the edge path's wall values: cl, ch at the window's rows, rl, rh at
  // the lane's slot columns
  T clv[kEdge ? R + 2 : 1], chv[kEdge ? R + 2 : 1];
  T rlv[kEdge ? V + 2 : 1], rhv[kEdge ? V + 2 : 1];
  if constexpr (kEdge) {
#pragma unroll
    for (int i = 0; i < R + 2; ++i) {
      const int gv = min(max(a0 - 1 + i, 0), P - 1);
      clv[i] = __ldg(f.cl + gv);
      chv[i] = __ldg(f.ch + gv);
    }
#pragma unroll
    for (int j = 0; j < V + 2; ++j) {
      const int cj = min(max(c - 1 + j, 0), Q - 1);
      rlv[j] = __ldg(f.rl + cj);
      rhv[j] = __ldg(f.rh + cj);
    }
  }
  // the edge path's columns, once a lane: slot j is column c-1+j; inside
  // the logical interior, the wall column -1 or n, inside the buffer
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
  BackRow<T> rows[R + 2];
#pragma unroll
  for (int i = 0; i < R + 2; ++i) {
    BackRow<T>& X = rows[i];
    const T ql = __shfl_up_sync(0xffffffffu, qv[i][V - 1], 1);
    const T wl = __shfl_up_sync(0xffffffffu, wv[i][V - 1], 1);
    const T sl = __shfl_up_sync(0xffffffffu, sv[i][V - 1], 1);
    const T qr = __shfl_down_sync(0xffffffffu, qv[i][0], 1);
    const T wr = __shfl_down_sync(0xffffffffu, wv[i][0], 1);
    const T sr = __shfl_down_sync(0xffffffffu, sv[i][0], 1);
    X.q[0] = lane == 0 ? qh[i] : ql;
    X.w[0] = lane == 0 ? wh[i] : wl;
    X.s[0] = lane == 0 ? sh[i] : sl;
    X.q[V + 1] = lane == kWarp - 1 ? qh[i] : qr;
    X.w[V + 1] = lane == kWarp - 1 ? wh[i] : wr;
    X.s[V + 1] = lane == kWarp - 1 ? sh[i] : sr;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      X.q[e + 1] = qv[i][e];
      X.w[e + 1] = wv[i][e];
      X.s[e + 1] = sv[i][e];
    }
    if constexpr (kEdge) {
      // the row's kind is the warp's, the column's the lane's
      const int g = a0 - 1 + i;
      const bool qrow = g >= 0 && g < m;
      const bool srow = g >= 0 && g < P;
#pragma unroll
      for (int j = 0; j < V + 2; ++j) {
        X.q[j] = qrow && cin[j] ? X.q[j] : T(0);  // 0 past the interior
        X.s[j] = srow && cbuf[j] ? X.s[j] : T(0);  // 0 past the buffer
      }
      // W: wt extended by its walls (the y-walls own the corners)
      if (qrow) {
#pragma unroll
        for (int j = 0; j < V + 2; ++j)
          X.w[j] = cin[j] ? X.w[j] : cwl[j] ? clv[i] : cwr[j] ? chv[i] : T(0);
      } else if (g == -1 || g == m) {
#pragma unroll
        for (int j = 0; j < V + 2; ++j)
          X.w[j] = cin[j] ? (g < 0 ? rlv[j] : rhv[j]) : cwr[j] ? k.lid : T(0);
      } else {
#pragma unroll
        for (int j = 0; j < V + 2; ++j) X.w[j] = T(0);  // beyond the walls
      }
    }
  }

  const T zero[V + 2] = {};  // a row past the buffer (the frame rows)
  double acc = 0.0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int a = a0 + r;
    if (kEdge && a >= P) break;
    const BackRow<T>& W = rows[r];
    const BackRow<T>& C = rows[r + 1];
    const BackRow<T>& E = rows[r + 2];
    T vs[V], vt[V], vw[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int j = e + 1;
      const Nbhd<T> qn = nbhd(W.q, C.q, E.q, j);
      const Nbhd<T> wn = nbhd(W.w, C.w, E.w, j);
      const Nbhd<T> sn = nbhd(W.s, C.s, E.s, j);
      T v = k.c * -jacobian(qn, wn, k.gg, k.r3);
      if constexpr (kEdge) {
        // the next wall vectors' adjoint, in the plain version's order
        const int b = c + e;
        if (b < Q) {
          if (a == 0) v += div_rn(k.k0 * __ldg(f.h_rl + b), k.dx2, k.rdx2);
          if (k.k1 != T(0) && a == 1)
            v += div_rn(k.k1 * __ldg(f.h_rl + b), k.dx2, k.rdx2);
          if (a == m - 1)
            v += div_rn(k.k0 * __ldg(f.h_rh + b), k.dx2, k.rdx2);
          if (k.k1 != T(0) && a == m - 2)
            v += div_rn(k.k1 * __ldg(f.h_rh + b), k.dx2, k.rdx2);
          if (a < m) {
            if (b == 0) v += div_rn(k.k0 * __ldg(f.h_cl + a), k.dy2, k.rdy2);
            if (k.k1 != T(0) && b == 1)
              v += div_rn(k.k1 * __ldg(f.h_cl + a), k.dy2, k.rdy2);
            if (b == n - 1)
              v += div_rn(k.k0 * __ldg(f.h_ch + a), k.dy2, k.rdy2);
            if (k.k1 != T(0) && b == n - 2)
              v += div_rn(k.k1 * __ldg(f.h_ch + a), k.dy2, k.rdy2);
          }
        }
      }
      vs[e] = v;
      const bool valid = !kEdge || (a < m && cin[j]);
      vt[e] = valid ? k.b * qn.c + k.c * d_wt(sn, qn, k) : T(0);
      vw[e] = k.a * qn.c;
      if (want_re && valid)
        acc += static_cast<double>(
            qn.c * laplacian(wn, k.dx2, k.dy2, k.rdx2, k.rdy2));
    }
    if (!kEdge || c < Q) {
      const int o = a * Q + c;
      store_vec(f.gs + o, vs);
      store_vec(f.gwt + o, vt);
      if (f.gw != nullptr) store_vec(f.gw + o, vw);
    }

    if constexpr (kEdge) {
      // the frame's gradients: rows -1 and m from the walkers of rows 0
      // and m-1 (a row past them is 0 or meets only zero q differences),
      // columns -1 and n from the lanes of columns 0 and n-1
      if (c < Q && a == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          f.g_rl[c + e] = c + e < n
              ? k.c * d_wt(nbhd(zero, W.s, C.s, e + 1),
                           nbhd(zero, W.q, C.q, e + 1), k)
              : T(0);
      }
      if (c < Q && a == m - 1) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          f.g_rh[c + e] = c + e < n
              ? k.c * d_wt(nbhd(C.s, E.s, zero, e + 1),
                           nbhd(C.q, E.q, zero, e + 1), k)
              : T(0);
      }
      if (c == 0)
        f.g_cl[a] = a < m ? k.c * d_wt(nbhd_left0(W.s, C.s, E.s),
                                       nbhd_left0(W.q, C.q, E.q), k)
                          : T(0);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (c + e == n - 1)
          f.g_ch[a] = a < m ? k.c * d_wt(nbhd_right0(W.s, C.s, E.s, e + 2),
                                         nbhd_right0(W.q, C.q, E.q, e + 2),
                                         k)
                            : T(0);
      }
    }
  }
  return acc;
}

// the Re gradient (partials, counter and gre all given, or none): the
// host re and the stage's factor c of r, folded into the last block
struct ReFold {
  double* partials;
  unsigned* counter;
  double re, c;
};

template <typename T>
__global__ void __launch_bounds__(kWarp * kBackWalkers)
cavity_stage_backward_kernel(BackArgs<T> f, ReFold fold, T* __restrict__ gre,
                             BackConsts<T> k) {
  constexpr int kSeg = kWarp * kVec<T>;
  const int c0 = blockIdx.x * kSeg;
  const int a0 = (blockIdx.y * kBackWalkers + threadIdx.y) * kBackRows;
  const bool want_re = fold.partials != nullptr;
  double acc = 0.0;   // this lane's q lap(W)
  if (a0 < f.P) {     // the whole warp
    const bool interior = a0 >= 2 && a0 + kBackRows <= f.m - 2 && c0 >= 2 &&
                          c0 + kSeg <= f.n - 2;
    acc = interior ? back_walk<T, false>(f, k, want_re, a0, c0)
                   : back_walk<T, true>(f, k, want_re, a0, c0);
  }
  if (!want_re) return;   // the whole grid
  fold_re_grad<kBackWalkers>(block_sum<kBackWalkers>(acc), fold.partials,
                             fold.counter, static_cast<const T*>(nullptr),
                             fold.re, fold.c, gre);
}

template <typename T>
dim3 back_grid(int P, int Q) {
  constexpr int kSeg = kWarp * kVec<T>;
  const int walkers = (P + kBackRows - 1) / kBackRows;
  return dim3((Q + kSeg - 1) / kSeg,
              (walkers + kBackWalkers - 1) / kBackWalkers);
}

template <typename T>
int launch_backward(const T* wt, const T* s, const T* rl, const T* rh,
                    const T* cl, const T* ch, const T* g, const T* h_rl,
                    const T* h_rh, const T* h_cl, const T* h_ch, T* gw,
                    T* gwt, T* gs, T* g_rl, T* g_rh, T* g_cl, T* g_ch,
                    double* partials, unsigned* counter, T* gre, int P,
                    int Q, int m, int n, int stage, int order, double dt,
                    double dx, double dy, double re, void* stream) {
  if (P <= 0 || Q <= 0 || m < 2 || n < 2 || m > P || n > Q ||
      static_cast<long long>(P) * Q >= (1LL << 31) || Q % kVec<T> != 0 ||
      !aligned(wt) || !aligned(s) || !aligned(g) || !aligned(gw) ||
      !aligned(gwt) || !aligned(gs) || (order != 1 && order != 2) ||
      stage < 1 || stage > 3 || (partials == nullptr) != (gre == nullptr) ||
      (partials == nullptr) != (counter == nullptr))
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
  const BackArgs<T> f{wt,   s,    rl,   rh,   cl,   ch,   g,
                      h_rl, h_rh, h_cl, h_ch, gw,   gwt,  gs,
                      g_rl, g_rh, g_cl, g_ch, P,    Q,    m,    n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cavity_stage_backward_kernel<T>
      <<<back_grid<T>(P, Q), dim3(kWarp, kBackWalkers), 0, st>>>(
          f, ReFold{partials, counter, re, c}, gre, k);
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
// cotangents g, h_*; with partials, counter and gre (all or none) also
// gre = dL/dre, one value
#define CAVITY_STAGE_BACKWARD_LAUNCHER(NAME, T)                              \
  extern "C" int NAME(const T* wt, const T* s, const T* rl, const T* rh,    \
                      const T* cl, const T* ch, const T* g, const T* h_rl,  \
                      const T* h_rh, const T* h_cl, const T* h_ch, T* gw,   \
                      T* gwt, T* gs, T* g_rl, T* g_rh, T* g_cl, T* g_ch,    \
                      double* partials, unsigned* counter, T* gre, int P,  \
                      int Q, int m, int n, int stage, int order, double dt, \
                      double dx, double dy, double re, void* stream) {      \
    return launch_backward<T>(wt, s, rl, rh, cl, ch, g, h_rl, h_rh, h_cl,   \
                              h_ch, gw, gwt, gs, g_rl, g_rh, g_cl, g_ch,    \
                              partials, counter, gre, P, Q, m, n, stage,    \
                              order, dt, dx, dy, re, stream);               \
  }

CAVITY_STAGE_BACKWARD_LAUNCHER(cavity_stage_backward_f32, float)
CAVITY_STAGE_BACKWARD_LAUNCHER(cavity_stage_backward_f64, double)

// the backward's partial sums of the Re gradient: one a block of its grid,
// which has more blocks in fp64 (a walker spans 64 columns, not 128); the
// buffer the caller gives holds the larger count, and an fp32 launch uses
// the first of them
extern "C" int cavity_stage_backward_partials(int P, int Q) {
  const dim3 f32 = back_grid<float>(P, Q), f64 = back_grid<double>(P, Q);
  const unsigned a = f32.x * f32.y, b = f64.x * f64.y;
  return static_cast<int>(a > b ? a : b);
}

// the walks' geometry, for the tests that emulate them: 0 rows a walker,
// 1 walkers a block, 2 bytes a lane loads of a row, 3 lanes a walker;
// 4 rows a backward walker, 5 backward walkers a block
extern "C" int cavity_stage_constant(int which) {
  switch (which) {
    case 0: return kRows;
    case 1: return kWalkers;
    case 2: return kVecBytes;
    case 3: return kWarp;
    case 4: return kBackRows;
    case 5: return kBackWalkers;
    default: return -1;
  }
}
