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
// interface, so a call is a few microseconds of latency, not bandwidth or
// arithmetic.  The TPU kernel ran the whole state as one VMEM block; one
// CUDA block would use 1 of 132 SMs, so the design tiles the cells over a
// grid instead: each block of kThreads threads owns kCells = kThreads - 1
// cells, stages them with 3 ghost cells a side of all three components in
// shared memory (one read of q), computes its kCells + 1 interface fluxes
// into shared memory (one interface per thread), and after one
// __syncthreads writes the divergence of its cells (one write of out).
// Neighbouring blocks recompute their shared boundary interface; that is
// 1/kCells extra work and keeps the kernel one pass with no scratch buffer.
// The Rusanov spectral wavespeed at interface j is max(rad[jj-1], rad[jj])
// with jj = clamp(j, 1, nx-1) — the copied ends ps[0] = ps[1], ps[nx] =
// ps[nx-1] — from staged cells j-1 and j, inside the tile's ghosts.
//
// Numerics: IEEE division and sqrt (no fast math); EPS_WENO = 1e-6 and the
// (eps + s)^2 weights as in ops/weno.py; the HLLC branch order of
// ops/riemann.py (the flux is continuous at each branch point, so a branch
// that flips on roundoff changes the flux by roundoff).
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): each
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;              // one interface per thread
constexpr int kCells = kThreads - 1;      // output cells per block
constexpr int kGhost = 3;                 // WENO-5 reach beyond a tile
constexpr int kStaged = kCells + 2 * kGhost;

// solver and wavespeed codes (ops/cuda_kernels.py _EULER_SOLVER, _EULER_WS)
constexpr int kRoe = 0, kHllc = 1, kRusanov = 2;
constexpr int kWaveRoe = 0, kWaveSpectral = 1;

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

// upwind value at the right face of the v3 cell (weno.py weno5_L)
template <typename T>
__device__ __forceinline__ T weno5_L(const T* v) {
  T s1, s2, s3;
  smoothness(v[0], v[1], v[2], v[3], v[4], s1, s2, s3);
  const T eps = T(kEpsWeno);
  const T d1 = eps + s1, d2 = eps + s2, d3 = eps + s3;
  const T c1 = T(0.1) / (d1 * d1);
  const T c2 = T(0.6) / (d2 * d2);
  const T c3 = T(0.3) / (d3 * d3);
  const T wsum = c1 + c2 + c3;
  const T q1 = v[0] / T(3) - T(7.0 / 6.0) * v[1] + T(11.0 / 6.0) * v[2];
  const T q2 = -v[1] / T(6) + T(5.0 / 6.0) * v[2] + v[3] / T(3);
  const T q3 = v[2] / T(3) + T(5.0 / 6.0) * v[3] - v[4] / T(6);
  return (c1 * q1 + c2 * q2 + c3 * q3) / wsum;
}

// downwind value at the left face of the v3 cell (weno.py weno5_R)
template <typename T>
__device__ __forceinline__ T weno5_R(const T* v) {
  T s1, s2, s3;
  smoothness(v[0], v[1], v[2], v[3], v[4], s1, s2, s3);
  const T eps = T(kEpsWeno);
  const T d1 = eps + s1, d2 = eps + s2, d3 = eps + s3;
  const T c1 = T(0.3) / (d1 * d1);
  const T c2 = T(0.6) / (d2 * d2);
  const T c3 = T(0.1) / (d3 * d3);
  const T wsum = c1 + c2 + c3;
  const T q1 = -v[0] / T(6) + T(5.0 / 6.0) * v[1] + v[2] / T(3);
  const T q2 = v[1] / T(3) + T(5.0 / 6.0) * v[2] - v[3] / T(6);
  const T q3 = T(11.0 / 6.0) * v[2] - T(7.0 / 6.0) * v[3] + v[4] / T(3);
  return (c1 * q1 + c2 * q2 + c3 * q3) / wsum;
}

// (rho, u, e, p, h) and the Euler flux of one state (riemann.py); gm is
// gamma - 1, rounded once from double as the twin's Python float is
template <typename T>
struct State {
  T q[3], f[3];
  T rho, u, p, h;

  __device__ __forceinline__ State(T q0, T q1, T q2, T gm) {
    q[0] = q0; q[1] = q1; q[2] = q2;
    rho = q0;
    u = q1 / rho;
    const T e = q2 / rho;
    p = gm * (q2 - T(0.5) * q1 * u);
    h = e + p / rho;
    f[0] = q1;
    f[1] = q1 * u + p;
    f[2] = (q2 + p) * u;
  }
};

// Roe-averaged (uu, hh, aa) (riemann.py _roe_average)
template <typename T>
__device__ __forceinline__ void roe_average(const State<T>& L,
                                            const State<T>& R, T gm,
                                            T& uu, T& hh, T& aa) {
  const T sL = sqrt(fabs(L.rho)), sR = sqrt(fabs(R.rho));
  const T alpha = T(1) / (sL + sR);
  uu = (sL * L.u + sR * R.u) * alpha;
  hh = (sL * L.h + sR * R.h) * alpha;
  aa = sqrt(fabs(gm * (hh - T(0.5) * (uu * uu))));
}

template <typename T>
__device__ void roe_flux(const State<T>& L, const State<T>& R, T gm, T* F) {
  T uu, hh, aa;
  roe_average(L, R, gm, uu, hh, aa);
  const T D11 = fabs(uu), D22 = fabs(uu + aa), D33 = fabs(uu - aa);
  const T aa2 = aa * aa;
  const T beta = T(0.5) / aa2;
  const T phi2 = T(0.5) * gm * (uu * uu);
  const T V0 = T(0.5) * (R.q[0] - L.q[0]);
  const T V1 = T(0.5) * (R.q[1] - L.q[1]);
  const T V2 = T(0.5) * (R.q[2] - L.q[2]);
  const T dd1 = D11 * ((T(1) - phi2 / aa2) * V0 + (gm * uu / aa2) * V1
                       - (gm / aa2) * V2);
  const T dd2 = D22 * ((phi2 - uu * aa) * V0 + (aa - gm * uu) * V1 + gm * V2);
  const T dd3 = D33 * ((phi2 + uu * aa) * V0 + (-aa - gm * uu) * V1
                       + gm * V2);
  const T dF0 = dd1 + beta * dd2 + beta * dd3;
  const T dF1 = uu * dd1 + beta * (uu + aa) * dd2 + beta * (uu - aa) * dd3;
  const T dF2 = (phi2 / gm) * dd1 + beta * (hh + uu * aa) * dd2
              + beta * (hh - uu * aa) * dd3;
  F[0] = T(0.5) * (R.f[0] + L.f[0]) - dF0;
  F[1] = T(0.5) * (R.f[1] + L.f[1]) - dF1;
  F[2] = T(0.5) * (R.f[2] + L.f[2]) - dF2;
}

template <typename T>
__device__ void hllc_flux(const State<T>& L, const State<T>& R, T gamma,
                          T* F) {
  const T aL = sqrt(fabs(gamma * L.p / L.rho));
  const T aR = sqrt(fabs(gamma * R.p / R.rho));
  const T amax = fmax(aL, aR);
  const T SL = fmin(L.u, R.u) - amax;
  const T SR = fmax(L.u, R.u) + amax;
  const T SP = (R.p - L.p + L.rho * L.u * (SL - L.u)
                - R.rho * R.u * (SR - R.u))
             / (L.rho * (SL - L.u) - R.rho * (SR - R.u));
  // the branch order of riemann.hllc's nested where
  if (SL >= T(0)) {
    for (int m = 0; m < 3; ++m) F[m] = L.f[m];
  } else if (SR <= T(0)) {
    for (int m = 0; m < 3; ++m) F[m] = R.f[m];
  } else {
    const T PLR = T(0.5) * (L.p + R.p + L.rho * (SL - L.u) * (SP - L.u)
                            + R.rho * (SR - R.u) * (SP - R.u));
    const bool left = SP >= T(0);
    const State<T>& K = left ? L : R;
    const T S = left ? SL : SR;
    const T Ds[3] = {T(0), T(1), SP};
    for (int m = 0; m < 3; ++m)
      F[m] = (SP * (S * K.q[m] - K.f[m]) + S * PLR * Ds[m]) / (S - SP);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
euler_rhs_kernel(const T* __restrict__ q, T* __restrict__ out, int nx,
                 T gamma, T gm, T dx, int solver, int wavespeed) {
  __shared__ T sq[3][kStaged];
  __shared__ T sf[3][kThreads];
  const int c0 = blockIdx.x * kCells;     // first cell of the tile
  const int t = threadIdx.x;

  // stage cells c0-3 .. c0+kCells+2 (mirror ghosts) of all components
  for (int k = t; k < kStaged; k += kThreads) {
    const int c = mirror(c0 - kGhost + k, nx);
    sq[0][k] = q[c];
    sq[1][k] = q[nx + c];
    sq[2][k] = q[2 * nx + c];
  }
  __syncthreads();

  // interface j = c0 + t: L on staged slots t..t+4 (cells j-3..j+1),
  // R on slots t+1..t+5 (cells j-2..j+2)
  const int j = c0 + t;
  if (j <= nx) {
    const State<T> L(weno5_L(&sq[0][t]), weno5_L(&sq[1][t]),
                     weno5_L(&sq[2][t]), gm);
    const State<T> R(weno5_R(&sq[0][t + 1]), weno5_R(&sq[1][t + 1]),
                     weno5_R(&sq[2][t + 1]), gm);
    T F[3];
    if (solver == kRoe) {
      roe_flux(L, R, gm, F);
    } else if (solver == kHllc) {
      hllc_flux(L, R, gamma, F);
    } else {
      T ps;
      if (wavespeed == kWaveSpectral) {
        // cells jj-1, jj with jj = clamp(j, 1, nx-1): staged slot of cell
        // c is c - c0 + kGhost
        const int jj = min(max(j, 1), nx - 1);
        auto radius = [&](int k) {   // |u| + a of the staged cell in slot k
          const State<T> c(sq[0][k], sq[1][k], sq[2][k], gm);
          return fabs(c.u) + sqrt(fabs(gamma * c.p / c.rho));
        };
        ps = fmax(radius(jj - 1 - c0 + kGhost), radius(jj - c0 + kGhost));
      } else {
        T uu, hh, aa;
        roe_average(L, R, gm, uu, hh, aa);
        ps = fabs(aa + uu);
      }
      for (int m = 0; m < 3; ++m)
        F[m] = T(0.5) * (R.f[m] + L.f[m]) - T(0.5) * ps * (R.q[m] - L.q[m]);
    }
    for (int m = 0; m < 3; ++m) sf[m][t] = F[m];
  }
  __syncthreads();

  const int i = c0 + t;
  if (t < kCells && i < nx) {
    for (int m = 0; m < 3; ++m)
      out[m * nx + i] = -(sf[m][t + 1] - sf[m][t]) / dx;
  }
}

template <typename T>
int launch(const T* q, T* out, int nx, double gamma, double dx, int solver,
           int wavespeed, void* stream) {
  if (nx < 3 || solver < kRoe || solver > kRusanov ||
      wavespeed < kWaveRoe || wavespeed > kWaveSpectral)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (nx + kCells - 1) / kCells;
  euler_rhs_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, out, nx, static_cast<T>(gamma), static_cast<T>(gamma - 1.0),
      static_cast<T>(dx), solver, wavespeed);
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
