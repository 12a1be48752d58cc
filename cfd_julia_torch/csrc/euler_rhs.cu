// 1D Euler RHS  out = -(F[j+1] - F[j]) / dx  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel euler_rhs_fused
// (cfd_julia_tpu/ops/pallas_kernels.py:749): mirror-boundary WENO-5 left and
// right states of the three conservative components at every interface,
// the Euler fluxes of both states, the Roe, HLLC or Rusanov flux (Rusanov
// with the Roe wavespeed |u_roe + a_roe| or the cell-centred spectral
// wavespeed2 of ops/riemann.py), and the conservative divergence; the same
// arithmetic, in the same order, as the plain PyTorch twin
// (ops/cuda_kernels.euler_rhs_fused_plain: ops/weno.py + ops/riemann.py).
//
// Layout: q and out are (3, nx) component-major, contiguous.  Interface j
// (0..nx) sits at x_{j-1/2}; its left-biased state L[j] is the WENO-5 value
// centred on cell j-1 (cells j-3..j+1), its right-biased state R[j] is
// centred on cell j (cells j-2..j+2).  The mirror ghosts are index
// arithmetic: cell i < 0 reads i' = -i-1, cell i >= nx reads 2nx-1-i (the
// JAX pads weno.py _pad_mirror_L/_R), so the R stencil reaches u_{nx-3}
// and nx >= 3 is required.
//
// What bounds it: at the sizes users run (nx = 256 .. 8192) a call moves
// 2 x 3 x nx values (192 KB at nx = 8192 in fp32) against ~400 flops per
// interface, so a call is latency: the launch, one load, and the longest
// dependent chain of arithmetic in a thread, which the warps of an SM hide
// from each other only if there are several of them.
//
// Design: a block of kThreads threads owns kCells cells (512 blocks of 4
// warps at nx = 8192, all resident at once) and runs the RHS in five phases
// through shared memory, one task a thread in each, a __syncthreads()
// between phases:
//   1. stage cells c0-3 .. c0+kCells+2 of all three components (the
//      mirror ghosts resolved while loading; one read of q);
//   2. WENO-5: one task per (side, component, interface) of the kFaces =
//      kCells + 1 interfaces, the L tasks in the first half of the block
//      and the R tasks in the second, so no warp mixes the two;
//   3. the states: one task per (side, interface) computes u, p, h, the
//      sound speed and the Euler flux; for the spectral wavespeed the
//      second half of the block computes |u| + a of staged cells c0-1 ..
//      c0+kCells;
//   4. the flux: one task per (component, interface); the three tasks of
//      an interface compute its shared scalars (Roe average, HLLC speeds)
//      each, in parallel;
//   5. the divergence: one task per (component, cell); one write of out.
// A thread's longest chain is one phase's, not the whole interface's, and
// neighbouring blocks recompute the interface between them (1/kCells extra
// work; no scratch buffer, one launch).  The spectral wavespeed at
// interface j is max(rad[jj-1], rad[jj]) with jj = clamp(j, 1, nx-1) — the
// copied ends ps[0] = ps[1], ps[nx] = ps[nx-1] — from cells c0-1 ..
// c0+kCells, inside the tile's ghosts for every kCells >= 1.
//
// Numerics: EPS_WENO = 1e-6 and the (eps + s)^2 weights as in ops/weno.py;
// the HLLC branch order of ops/riemann.py (the flux is continuous at each
// branch point, so a branch that flips on roundoff changes the flux by
// roundoff); IEEE sqrt.  Divisions (div_rn.cuh): by the constants 3, 6,
// gamma - 1 and dx with reciprocals made on the host; by the WENO
// weights' (eps + s)^2 >= 1e-12 and their sum, by rho, and 1 / (sL + sR)
// with rcp_rn of the divisor: each equals the IEEE quotient.  The HLLC
// contact speed's denominator and S - SP, and the Roe a^2, keep `/`: on
// the interface states WENO-5 makes from rough data (rho < 0, p < 0) they
// can come near zero, where div_rn's quotient or remainder would leave
// fp32's normal range.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): each
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

constexpr int kCells = 16;                // output cells per block
constexpr int kThreads = 128;
constexpr int kHalf = kThreads / 2;       // L | R, states | radii
constexpr int kFaces = kCells + 1;        // interfaces a block computes
constexpr int kGhost = 3;                 // WENO-5 reach beyond a tile
constexpr int kStaged = kCells + 2 * kGhost;
constexpr int kRadii = kCells + 2;        // cells c0-1 .. c0+kCells
static_assert(3 * kFaces <= kHalf && kRadii <= kHalf,
              "a phase's tasks of one kind fit in half a block");

// solver and wavespeed codes (ops/cuda_kernels.py _EULER_SOLVER, _EULER_WS)
constexpr int kRoe = 0, kHllc = 1, kRusanov = 2;
constexpr int kWaveRoe = 0, kWaveSpectral = 1;

// per-side fields of an interface state in shared memory (f0 is q1)
enum { kU, kP, kH, kA, kF1, kF2, kStateFields };

constexpr double kEpsWeno = 1e-6;

__device__ __forceinline__ int mirror(int i, int nx) {
  if (i < 0) i = -i - 1;
  else if (i >= nx) i = 2 * nx - 1 - i;
  // staged slots past the last block's ghosts feed no interface
  return min(max(i, 0), nx - 1);
}

template <typename T>
__device__ __forceinline__ void smoothness(T v1, T v2, T v3, T v4, T v5,
                                           T& s1, T& s2, T& s3) {
  const T a1 = v1 - T(2) * v2 + v3, b1 = v1 - T(4) * v2 + T(3) * v3;
  const T a2 = v2 - T(2) * v3 + v4, b2 = v2 - v4;
  const T a3 = v3 - T(2) * v4 + v5, b3 = T(3) * v3 - T(4) * v4 + v5;
  s1 = T(13.0 / 12.0) * (a1 * a1) + T(0.25) * (b1 * b1);
  s2 = T(13.0 / 12.0) * (a2 * a2) + T(0.25) * (b2 * b2);
  s3 = T(13.0 / 12.0) * (a3 * a3) + T(0.25) * (b3 * b3);
}

// lin / (eps + s)^2: the divisor is at least 1e-12
template <typename T>
__device__ __forceinline__ T weight(T lin, T s) {
  const T d = T(kEpsWeno) + s;
  const T d2 = d * d;
  return div_rn(lin, d2, rcp_rn(d2));
}

// upwind value at the right face of the v3 cell (weno.py weno5_L); r3, r6
// are 1/3 and 1/6
template <typename T>
__device__ __forceinline__ T weno5_L(const T* v, T r3, T r6) {
  T s1, s2, s3;
  smoothness(v[0], v[1], v[2], v[3], v[4], s1, s2, s3);
  const T c1 = weight(T(0.1), s1);
  const T c2 = weight(T(0.6), s2);
  const T c3 = weight(T(0.3), s3);
  const T wsum = c1 + c2 + c3;
  const T q1 = div_rn(v[0], T(3), r3) - T(7.0 / 6.0) * v[1]
             + T(11.0 / 6.0) * v[2];
  const T q2 = -div_rn(v[1], T(6), r6) + T(5.0 / 6.0) * v[2]
             + div_rn(v[3], T(3), r3);
  const T q3 = div_rn(v[2], T(3), r3) + T(5.0 / 6.0) * v[3]
             - div_rn(v[4], T(6), r6);
  return div_rn(c1 * q1 + c2 * q2 + c3 * q3, wsum, rcp_rn(wsum));
}

// downwind value at the left face of the v3 cell (weno.py weno5_R)
template <typename T>
__device__ __forceinline__ T weno5_R(const T* v, T r3, T r6) {
  T s1, s2, s3;
  smoothness(v[0], v[1], v[2], v[3], v[4], s1, s2, s3);
  const T c1 = weight(T(0.3), s1);
  const T c2 = weight(T(0.6), s2);
  const T c3 = weight(T(0.1), s3);
  const T wsum = c1 + c2 + c3;
  const T q1 = -div_rn(v[0], T(6), r6) + T(5.0 / 6.0) * v[1]
             + div_rn(v[2], T(3), r3);
  const T q2 = div_rn(v[1], T(3), r3) + T(5.0 / 6.0) * v[2]
             - div_rn(v[3], T(6), r6);
  const T q3 = T(11.0 / 6.0) * v[2] - T(7.0 / 6.0) * v[3]
             + div_rn(v[4], T(3), r3);
  return div_rn(c1 * q1 + c2 * q2 + c3 * q3, wsum, rcp_rn(wsum));
}

// one side's state at an interface, read back from shared memory: the
// three components, and component m of the state and of its Euler flux
// (scalars, not arrays indexed by m, which would go to local memory)
template <typename T>
struct Face {
  T q0, q1, q2, qm, fm;
  T rho, u, p, h, a;
};

template <typename T>
__device__ __forceinline__ Face<T> load_face(const T (*qi)[kFaces],
                                             const T (*st)[kFaces], int k,
                                             int m) {
  Face<T> F;
  F.q0 = qi[0][k];
  F.q1 = qi[1][k];
  F.q2 = qi[2][k];
  F.qm = qi[m][k];
  F.fm = m == 0 ? F.q1 : st[kF1 + m - 1][k];
  F.rho = F.q0;
  F.u = st[kU][k];
  F.p = st[kP][k];
  F.h = st[kH][k];
  F.a = st[kA][k];
  return F;
}

// Roe-averaged (uu, hh, aa) (riemann.py _roe_average)
template <typename T>
__device__ __forceinline__ void roe_average(const Face<T>& L,
                                            const Face<T>& R, T gm,
                                            T& uu, T& hh, T& aa) {
  const T sL = sqrt(fabs(L.rho)), sR = sqrt(fabs(R.rho));
  const T alpha = rcp_rn(sL + sR);
  uu = (sL * L.u + sR * R.u) * alpha;
  hh = (sL * L.h + sR * R.h) * alpha;
  aa = sqrt(fabs(gm * (hh - T(0.5) * (uu * uu))));
}

// component m of the Roe flux; gm = gamma - 1, rgm = 1 / gm
template <typename T>
__device__ T roe_flux(const Face<T>& L, const Face<T>& R, int m, T gm,
                      T rgm) {
  T uu, hh, aa;
  roe_average(L, R, gm, uu, hh, aa);
  const T D11 = fabs(uu), D22 = fabs(uu + aa), D33 = fabs(uu - aa);
  const T aa2 = aa * aa;
  const T beta = T(0.5) / aa2;
  const T phi2 = T(0.5) * gm * (uu * uu);
  const T V0 = T(0.5) * (R.q0 - L.q0);
  const T V1 = T(0.5) * (R.q1 - L.q1);
  const T V2 = T(0.5) * (R.q2 - L.q2);
  const T dd1 = D11 * ((T(1) - phi2 / aa2) * V0 + (gm * uu / aa2) * V1
                       - (gm / aa2) * V2);
  const T dd2 = D22 * ((phi2 - uu * aa) * V0 + (aa - gm * uu) * V1 + gm * V2);
  const T dd3 = D33 * ((phi2 + uu * aa) * V0 + (-aa - gm * uu) * V1
                       + gm * V2);
  T dF;
  if (m == 0)
    dF = dd1 + beta * dd2 + beta * dd3;
  else if (m == 1)
    dF = uu * dd1 + beta * (uu + aa) * dd2 + beta * (uu - aa) * dd3;
  else
    dF = div_rn(phi2, gm, rgm) * dd1 + beta * (hh + uu * aa) * dd2
       + beta * (hh - uu * aa) * dd3;
  return T(0.5) * (R.fm + L.fm) - dF;
}

// component m of the HLLC flux
template <typename T>
__device__ T hllc_flux(const Face<T>& L, const Face<T>& R, int m) {
  const T amax = fmax(L.a, R.a);
  const T SL = fmin(L.u, R.u) - amax;
  const T SR = fmax(L.u, R.u) + amax;
  const T SP = (R.p - L.p + L.rho * L.u * (SL - L.u)
                - R.rho * R.u * (SR - R.u))
             / (L.rho * (SL - L.u) - R.rho * (SR - R.u));
  // the branch order of riemann.hllc's nested where
  if (SL >= T(0)) return L.fm;
  if (SR <= T(0)) return R.fm;
  const T PLR = T(0.5) * (L.p + R.p + L.rho * (SL - L.u) * (SP - L.u)
                          + R.rho * (SR - R.u) * (SP - R.u));
  const bool left = SP >= T(0);
  const T S = left ? SL : SR;
  const T Kq = left ? L.qm : R.qm, Kf = left ? L.fm : R.fm;
  const T Ds = m == 0 ? T(0) : (m == 1 ? T(1) : SP);
  return (SP * (S * Kq - Kf) + S * PLR * Ds) / (S - SP);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
euler_rhs_kernel(const T* __restrict__ q, T* __restrict__ out, int nx,
                 T gamma, T gm, T rgm, T dx, T rdx, T r3, T r6,
                 int solver, int wavespeed) {
  __shared__ T sq[3][kStaged];                 // staged cells
  __shared__ T sqi[2][3][kFaces];              // WENO states, L | R
  __shared__ T sst[2][kStateFields][kFaces];   // their u, p, h, a, f1, f2
  __shared__ T srad[kRadii];                   // |u| + a of cells c0-1..
  __shared__ T sf[3][kFaces];                  // interface fluxes
  const int c0 = blockIdx.x * kCells;          // first cell of the tile
  const int t = threadIdx.x;
  const int half = t / kHalf, ht = t % kHalf;

  // 1. stage cells c0-3 .. c0+kCells+2 (mirror ghosts)
  for (int k = t; k < 3 * kStaged; k += kThreads) {
    const int m = k / kStaged, slot = k - m * kStaged;
    sq[m][slot] = q[m * nx + mirror(c0 - kGhost + slot, nx)];
  }
  __syncthreads();

  // 2. interface k = j - c0: L on staged slots k..k+4 (cells j-3..j+1),
  // R on slots k+1..k+5 (cells j-2..j+2)
  for (int k = ht; k < 3 * kFaces; k += kHalf) {
    const int m = k / kFaces, face = k - m * kFaces;
    const T* v = &sq[m][face + half];
    sqi[half][m][face] = half == 0 ? weno5_L(v, r3, r6) : weno5_R(v, r3, r6);
  }
  __syncthreads();

  // 3. the states at the interfaces (first half), the cells' spectral
  // radii (second half; riemann.py rusanov_wavespeed2)
  if (half == 0) {
    for (int k = ht; k < 2 * kFaces; k += kHalf) {
      const int side = k / kFaces, face = k - side * kFaces;
      const T rho = sqi[side][0][face], q1 = sqi[side][1][face];
      const T q2 = sqi[side][2][face];
      const T rr = rcp_rn(rho);
      const T u = div_rn(q1, rho, rr);
      const T e = div_rn(q2, rho, rr);
      const T p = gm * (q2 - T(0.5) * q1 * u);
      T(*st)[kFaces] = sst[side];
      st[kU][face] = u;
      st[kP][face] = p;
      st[kH][face] = e + div_rn(p, rho, rr);
      st[kA][face] = sqrt(fabs(div_rn(gamma * p, rho, rr)));
      st[kF1][face] = q1 * u + p;
      st[kF2][face] = (q2 + p) * u;
    }
  } else if (solver == kRusanov && wavespeed == kWaveSpectral) {
    for (int k = ht; k < kRadii; k += kHalf) {
      const int slot = kGhost - 1 + k;           // cell c0 - 1 + k
      const T rho = sq[0][slot], q1 = sq[1][slot], q2 = sq[2][slot];
      const T rr = rcp_rn(rho);
      const T u = div_rn(q1, rho, rr);
      const T p = gm * (q2 - T(0.5) * q1 * u);
      srad[k] = fabs(u) + sqrt(fabs(div_rn(gamma * p, rho, rr)));
    }
  }
  __syncthreads();

  // 4. component m of the flux at interface face
  for (int k = t; k < 3 * kFaces; k += kThreads) {
    const int m = k / kFaces, face = k - m * kFaces;
    const Face<T> L = load_face<T>(sqi[0], sst[0], face, m);
    const Face<T> R = load_face<T>(sqi[1], sst[1], face, m);
    T F;
    if (solver == kRoe) {
      F = roe_flux(L, R, m, gm, rgm);
    } else if (solver == kHllc) {
      F = hllc_flux(L, R, m);
    } else {
      T ps;
      if (wavespeed == kWaveSpectral) {
        // cells jj-1, jj with jj = clamp(j, 1, nx-1); cell c's radius is
        // srad[c - c0 + 1]
        const int jj = min(max(c0 + face, 1), nx - 1);
        ps = fmax(srad[jj - c0], srad[jj - c0 + 1]);
      } else {
        T uu, hh, aa;
        roe_average(L, R, gm, uu, hh, aa);
        ps = fabs(aa + uu);
      }
      F = T(0.5) * (R.fm + L.fm) - T(0.5) * ps * (R.qm - L.qm);
    }
    sf[m][face] = F;
  }
  __syncthreads();

  // 5. the divergence of the tile's cells
  for (int k = t; k < 3 * kCells; k += kThreads) {
    const int m = k / kCells, cell = k - m * kCells;
    if (c0 + cell < nx)
      out[m * nx + c0 + cell] =
          -div_rn(sf[m][cell + 1] - sf[m][cell], dx, rdx);
  }
}

template <typename T>
int launch(const T* q, T* out, int nx, double gamma, double dx, int solver,
           int wavespeed, void* stream) {
  if (nx < 3 || solver < kRoe || solver > kRusanov ||
      wavespeed < kWaveRoe || wavespeed > kWaveSpectral)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (nx + kCells - 1) / kCells;
  const T gm = static_cast<T>(gamma - 1.0), dx_ = static_cast<T>(dx);
  euler_rhs_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, out, nx, static_cast<T>(gamma), gm, T(1) / gm, dx_, T(1) / dx_,
      T(1) / T(3), T(1) / T(6), solver, wavespeed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int euler_rhs_f32(const float* q, float* out, int nx, double gamma,
                             double dx, int solver, int wavespeed,
                             void* stream) {
  return launch<float>(q, out, nx, gamma, dx, solver, wavespeed, stream);
}

extern "C" int euler_rhs_f64(const double* q, double* out, int nx,
                             double gamma, double dx, int solver,
                             int wavespeed, void* stream) {
  return launch<double>(q, out, nx, gamma, dx, solver, wavespeed, stream);
}
