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
// read wt (16.8 MB, 5.0 us).  The wall vectors are 16 KB.
//
// Design: kernel 1's register window down a column (csrc/arakawa_rhs.cu).
// Each thread owns one column b of the (P, Q) buffer (threadIdx.x on the
// contiguous axis) and kRows rows; it loads W and s at columns b-1, b, b+1
// of rows a0-1 .. a0+kRows, then computes its rows from registers.  Threads
// of padding points store 0.  The threads of row 0, row m-1, column 0 and
// column n-1 also write rl, rh, cl and ch from the psi values in their
// window; a thread of column 0 or n-1 writes cl or ch for every row of the
// buffer (0 at rows >= m), so each vector is written whole, by one thread an
// entry.  The wall vectors are read from one set of buffers and written to
// another.
//
// Numerics: the plain twin's expression in its order
// (ops/cuda_kernels.cavity_fused_stage_plain, JAX's order).  Divisions by
// constants of the launch (3, dx^2, dy^2, re) go through div_rn.cuh with
// reciprocals made on the host, as in kernel 1.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): the
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

constexpr int kBlockX = 32;  // columns a block: axis 1, contiguous
constexpr int kBlockY = 4;   // column walkers a block, stacked along axis 0
constexpr int kRows = 8;     // output rows a walker computes

template <typename T>
struct Consts {
  T gg, dx2, dy2, re, r3, rdx2, rdy2, rre;
  T lid;     // the lid term of ch and the value at the two lid corners
  T c;       // dt, dt/4 or 2 dt: the stage's factor of r
};

template <typename T>
struct Row {
  T w[3], s[3];
};

// wt extended by its walls: W(g, c) for g in [-1, m], c in [-1, n]
template <typename T>
__device__ __forceinline__ T wall_w(const T* __restrict__ wt,
                                    const T* __restrict__ rl,
                                    const T* __restrict__ rh,
                                    const T* __restrict__ cl,
                                    const T* __restrict__ ch, int g, int c,
                                    int m, int n, int Q, T lid) {
  const bool gin = g >= 0 && g < m, cin = c >= 0 && c < n;
  if (gin && cin) return wt[g * Q + c];
  if (g == -1 || g == m) {
    if (cin) return g < 0 ? rl[c] : rh[c];
    return c == n ? lid : T(0);
  }
  if (gin) {
    if (c == -1) return cl[g];
    if (c == n) return ch[g];
  }
  return T(0);  // beyond the walls: read only for padding points
}

template <typename T>
__device__ __forceinline__ T psi(const T* __restrict__ s, int g, int c, int P,
                                 int Q) {
  return (g >= 0 && g < P && c >= 0 && c < Q) ? s[g * Q + c] : T(0);
}

// the wall vorticity of psi values s0 (next to the wall) and s1 (one further)
template <typename T>
__device__ __forceinline__ T wall_value(T s0, T s1, T h2, T rh2, int order) {
  return order == 1 ? div_rn(T(-2) * s0, h2, rh2)
                    : div_rn(T(-4) * s0 + T(0.5) * s1, h2, rh2);
}

template <typename T, int kStage>
__global__ void __launch_bounds__(kBlockX * kBlockY)
cavity_stage_kernel(const T* __restrict__ w, const T* __restrict__ wt,
                    const T* __restrict__ s, const T* __restrict__ rl,
                    const T* __restrict__ rh, const T* __restrict__ cl,
                    const T* __restrict__ ch, T* __restrict__ out,
                    T* __restrict__ rl_o, T* __restrict__ rh_o,
                    T* __restrict__ cl_o, T* __restrict__ ch_o, int P, int Q,
                    int m, int n, int order, Consts<T> k) {
  const int b = blockIdx.x * kBlockX + threadIdx.x;
  const int a0 = (blockIdx.y * kBlockY + threadIdx.y) * kRows;
  if (b >= Q || a0 >= P) return;

  // rows[q] is row a0-1+q at columns b-1, b, b+1
  Row<T> rows[kRows + 2];
#pragma unroll
  for (int q = 0; q < kRows + 2; ++q) {
    const int g = a0 - 1 + q;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      rows[q].w[d] = wall_w(wt, rl, rh, cl, ch, g, b - 1 + d, m, n, Q, k.lid);
      rows[q].s[d] = psi(s, g, b - 1 + d, P, Q);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int a = a0 + r;
    if (a >= P) break;
    const Row<T>& W = rows[r];
    const Row<T>& C = rows[r + 1];
    const Row<T>& E = rows[r + 2];

    // the next stage's wall vectors, from this stage's (pre-solve) psi
    if (a == 0) rl_o[b] = wall_value(C.s[1], E.s[1], k.dx2, k.rdx2, order);
    if (a == m - 1) rh_o[b] = wall_value(C.s[1], W.s[1], k.dx2, k.rdx2, order);
    if (b == 0)
      cl_o[a] = a < m ? wall_value(C.s[1], C.s[2], k.dy2, k.rdy2, order)
                      : T(0);
    if (b == n - 1)
      ch_o[a] = a < m ? wall_value(C.s[1], C.s[0], k.dy2, k.rdy2, order) +
                            k.lid
                      : T(0);

    T res = T(0);
    if (a < m && b < n) {
      // E/W step along axis 0, N/S along axis 1 (columns [0], [1], [2] are
      // b-1, b, b+1), as in ops/arakawa.py
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
      const T jac = div_rn(k.gg * (j1 + j2 + j3), T(3), k.r3);
      const T lap = div_rn(wE - T(2) * wc + wW, k.dx2, k.rdx2)
                  + div_rn(wN - T(2) * wc + wS, k.dy2, k.rdy2);
      const T rhs = -jac + div_rn(lap, k.re, k.rre);
      if constexpr (kStage == 1) {
        res = wc + k.c * rhs;  // wt is w
      } else {
        const T w0 = w[a * Q + b];
        if constexpr (kStage == 2)
          res = T(0.75) * w0 + T(0.25) * wc + k.c * rhs;
        else
          res = div_rn(w0 + T(2) * wc + k.c * rhs, T(3), k.r3);
      }
    }
    out[a * Q + b] = res;
  }
}

template <typename T>
int launch(const T* w, const T* wt, const T* s, const T* rl, const T* rh,
           const T* cl, const T* ch, T* out, T* rl_o, T* rh_o, T* cl_o,
           T* ch_o, int P, int Q, int m, int n, int stage, int order,
           double dt, double dx, double dy, double re, void* stream) {
  if (P <= 0 || Q <= 0 || m < 2 || n < 2 || m > P || n > Q ||
      (order != 1 && order != 2) || stage < 1 || stage > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int walkers = (P + kRows - 1) / kRows;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((Q + kBlockX - 1) / kBlockX,
                  (walkers + kBlockY - 1) / kBlockY);
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
