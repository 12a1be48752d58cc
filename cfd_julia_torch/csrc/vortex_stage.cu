// The stage passes of the half-spectrum RK3/CN vortex step for Hopper
// (sm_90a): the derivative spectra, the physical product, the
// Crank-Nicolson combine and ps32's truncation.
//
// Replaces no Pallas kernel: the JAX package leaves this stage math to XLA's
// fusion (cfd_julia_tpu/models/vortex.py:392 make_spectral_step_half, the
// ps23 branch :457-469), which eager PyTorch runs as ~34 launches a step,
// 64.5% of a ps23 2048^2 step's device time.  The port's step
// (cfd_julia_torch/models/vortex.py make_spectral_step_half) runs each
// Jacobian as (a) -> inverse transform -> (b) -> rfft2, and each stage's
// update as (c):
//
//   (a) derivs   out[c, i, j] = g_c(i, j) * (i H[i, j]), j < nb, c = 0..3:
//                g = kx0/k2, ky, ky/k2, kx0 (psi_x, w_y, psi_y, w_x), each
//                times the mask m = rm[i] cm[j] and `scale`, with
//                k2 = kx[i]^2 + kyg[j]^2 (kx, kyg the eps-guarded
//                wavenumbers, kx0 the row wavenumber with k = 0 zeroed);
//                H is the (rows, hy) half spectrum, or a rank's row slab of
//                it, and nb <= hy its first columns (ps23's 2/3 band, or
//                all of them);
//   (b) product  p = a b - c d over the four real fields (4, n) -> (n);
//   (c) combine  out = a H + r j0 + b j1 (stage 1: a H + b j1) with the
//                stage's real (rows, hy) tables a, b, r;
//   (d) truncate ps32's Jacobian, spectral.truncate_32_half of the fine
//                grid's rfft2 output jf (nxe, hye) times the real (nx, hy)
//                table nyq/scale: out[i, j] = jf[r(i), j] t[i, j] for
//                j < ny/2, conj(jf[(nxe - r(i)) % nxe, ny/2]) t[i, ny/2]
//                on the Nyquist column, r(i) = i below nx/2, else
//                nxe - nx + i (kernel 12).
//
// (a) has a second mode, the buffer mode, for the single-device ps23 and
// ps32 steps: it writes the four spectra into a caller's complex buffer
// in the layout of the step's cuFFT plans (csrc/fft_plans.cu), one of
// two: kx fastest, (cols, 4, R), where the kx transform runs in place over
// the first 4 nb columns and the c2r along ky with stride 4 R (ps32's); or
// ky fastest, (4, R, cols), where the kx transform runs strided, a field
// at a time, and the c2r on contiguous rows (ps23's, cols a 16-value pitch
// past the c2r's hy: faster at 2048^2, chip_smoke.py phase 2).  Buffer row e
// holds H's row e below rows/2, zeros for `pad` rows after, then H's row
// e - pad (ps32's 3/2 pad, pad = nxe - nx; ps23 pad = 0), and columns
// nb..cols-1 are zero.  Every element is written, zeros too: the c2r may
// overwrite its input, so the buffer must be whole again at each stage.
// The pitch's columns past hy are read by no plan but written all the
// same: at 2048^2 fp32 that measured faster than stopping each row's
// stores at hy (0.03471 against 0.03724 ms, kernel_ab.py on an H100).
//
// g is built here from two small tables, rowk (rows, 3) = (kx, kx0, rm)
// and colk (>= nb, 3) = (ky, kyg, cm), not read as a (4, rows, hy) table:
// at 2048^2 that would add 33.6 MB of reads to every Jacobian.
//
// What bounds them: device memory.  At 2048^2 fp32 (H 16.79 MB, a real
// field 16.78 MB, 3.35 TB/s): (a) banded reads 11.17 MB and writes 44.70 MB
// (16.7 us), at full width 16.8 + 67.2 MB (25.1 us); (b) 67.1 + 16.8 MB
// (25.0 us); (c) with its tables 67.1 MB at stage 1 (20.0 us), 92.3 MB at
// stages 2 and 3 (27.5 us); (a)'s buffer mode, counting the values the
// plans read, ps23 (4, 2048, 1025 of the 1040 written) 11.17 + 67.17 MB
// (23.4 us), ps32 (1537, 4, 3072) 16.79 + 151.1 MB (50.1 us); (d) 16.8 MB of jf, 8.4 of its table and 16.8
// written (12.5 us).  Design: flat index over the output, column and
// row derived from it (hy = 1025 is odd, so the complex rows of H are not
// 16-byte aligned, but the output planes are); H and (a)'s output in
// either memory order, row by row or column by column (the order
// torch.fft.rfft2 returns on the GPU, which the inverse's kx transform
// reads without a copy); 16-byte loads and stores a
// thread where the sizes and pointers allow (kVec elements: (a) and (c) two
// complex64 or one complex128, (b) four floats or two doubles), else the
// same code one element a thread; H read once for its four outputs.
//
// Numerics: every operation in the plain twin's order (ops/cuda_kernels.py
// vortex_*_plain) with the _rn intrinsics, so nvcc's default FMA
// contraction cannot fuse them, and IEEE division: each pass equals its
// twin bit for bit.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): each
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for arguments it refuses, without launching).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecBytes = 16;

// round-to-nearest operations that nvcc does not contract into an FMA
#define VORTEX_RN(NAME, F32, F64)                                          \
  __device__ __forceinline__ float NAME(float a, float b) {                \
    return F32(a, b);                                                      \
  }                                                                        \
  __device__ __forceinline__ double NAME(double a, double b) {             \
    return F64(a, b);                                                      \
  }

VORTEX_RN(mul, __fmul_rn, __dmul_rn)
VORTEX_RN(add, __fadd_rn, __dadd_rn)
VORTEX_RN(sub, __fsub_rn, __dsub_rn)
VORTEX_RN(quo, __fdiv_rn, __ddiv_rn)

// V values of T, loaded and stored as one access of sizeof(T) * V bytes
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& x) {
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

// ------------------------------------------------------------ (a) derivs

// the four spectra at (i, j): out[2c], out[2c+1] = (-g_c Im H, g_c Re H);
// H[i, j] is h's complex number i si + j sj
template <typename T>
__device__ __forceinline__ void derivs_at(const T* __restrict__ h,
                                          const T* __restrict__ rowk,
                                          const T* __restrict__ colk, int i,
                                          int j, int si, int sj, T scale,
                                          T* out) {
  const T kx = rowk[3 * i], kx0 = rowk[3 * i + 1], rm = rowk[3 * i + 2];
  const T ky = colk[3 * j], kyg = colk[3 * j + 1], cm = colk[3 * j + 2];
  const Pack<T, 2> z = load<T, 2>(
      h + 2 * (static_cast<size_t>(i) * si + static_cast<size_t>(j) * sj));
  const T k2 = add(mul(kx, kx), mul(kyg, kyg));
  const T m = mul(rm, cm);
  const T g[4] = {mul(mul(quo(kx0, k2), m), scale), mul(mul(ky, m), scale),
                  mul(mul(quo(ky, k2), m), scale), mul(mul(kx0, m), scale)};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[2 * c] = -mul(g[c], z.v[1]);
    out[2 * c + 1] = mul(g[c], z.v[0]);
  }
}

// V complex outputs a thread (V = 2 for complex64 with an even plane, else
// 1): flat q over the (rows, nb) plane in memory order, each of the four
// planes stored as one 2V-value access.  kKxMajor: H (rows, hy) and the
// output planes hold each column's rows together (H's strides (1, rows):
// the layout torch.fft.rfft2 returns on the GPU, which the kx transform
// of the inverse then reads without a copy), so q walks i fastest; else
// both are row-major and q walks j fastest.
template <typename T, int V, bool kKxMajor>
__global__ void __launch_bounds__(kThreads)
    derivs_kernel(const T* __restrict__ h, const T* __restrict__ rowk,
                  const T* __restrict__ colk, T* __restrict__ out, int rows,
                  int hy, int nb, T scale) {
  const long long plane = static_cast<long long>(rows) * nb;
  const long long q =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (q >= plane) return;
  const int inner = kKxMajor ? rows : nb;
  int o = static_cast<int>(q / inner);
  int k = static_cast<int>(q - static_cast<long long>(o) * inner);
  T vals[V][8];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (kKxMajor)  // (i, j) = (k, o), H[i, j] at i + j rows
      derivs_at(h, rowk, colk, k, o, 1, rows, scale, vals[v]);
    else           // (i, j) = (o, k), H[i, j] at i hy + j
      derivs_at(h, rowk, colk, o, k, hy, 1, scale, vals[v]);
    if (++k == inner) {
      k = 0;
      ++o;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    Pack<T, 2 * V> w;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      w.v[2 * v] = vals[v][2 * c];
      w.v[2 * v + 1] = vals[v][2 * c + 1];
    }
    store<T, 2 * V>(out + 2 * (c * plane + q), w);
  }
}

// (a)'s buffer mode: V buffer points a thread, consecutive along the
// fastest axis (V = 2 for complex64 with that axis even), each of the four
// fields' values stored as one 2V-value access at ((j 4 + c) R + e) (kx
// fastest) or ((c R + e) cols + j) (kKyFastest); H[i, j] at i si + j sj
template <typename T, int V, bool kKyFastest>
__global__ void __launch_bounds__(kThreads)
    derivs_buffer_kernel(const T* __restrict__ h, const T* __restrict__ rowk,
                         const T* __restrict__ colk, T* __restrict__ out,
                         int rows, int si, int sj, int nb, int cols, int pad,
                         T scale) {
  const int r_out = rows + pad, split = rows / 2;
  const int inner = kKyFastest ? cols : r_out;
  const long long q =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (q >= static_cast<long long>(cols) * r_out) return;
  const int o = static_cast<int>(q / inner);
  const int k0 = static_cast<int>(q - static_cast<long long>(o) * inner);
  T vals[V][8];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = kKyFastest ? o : k0 + v, j = kKyFastest ? k0 + v : o;
    if (j < nb && (e < split || e >= split + pad)) {
      derivs_at(h, rowk, colk, e < split ? e : e - pad, j, si, sj, scale,
                vals[v]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) vals[v][k] = T(0);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    Pack<T, 2 * V> w;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      w.v[2 * v] = vals[v][2 * c];
      w.v[2 * v + 1] = vals[v][2 * c + 1];
    }
    const long long at =
        kKyFastest ? (static_cast<long long>(c) * r_out + o) * cols + k0
                   : (static_cast<long long>(o) * 4 + c) * r_out + k0;
    store<T, 2 * V>(out + 2 * at, w);
  }
}

// ----------------------------------------------------------- (b) product

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    product_kernel(const T* __restrict__ in, T* __restrict__ out,
                   long long n) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= n) return;
  const Pack<T, V> a = load<T, V>(in + e), b = load<T, V>(in + n + e),
                   c = load<T, V>(in + 2 * n + e),
                   d = load<T, V>(in + 3 * n + e);
  Pack<T, V> p;
#pragma unroll
  for (int v = 0; v < V; ++v)
    p.v[v] = sub(mul(a.v[v], b.v[v]), mul(c.v[v], d.v[v]));
  store<T, V>(out + e, p);
}

// ----------------------------------------------------------- (c) combine

// V complex values a thread; kThree: the r j0 term (stages 2 and 3)
template <typename T, int V, bool kThree>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ a, const T* __restrict__ h,
                   const T* __restrict__ r, const T* __restrict__ j0,
                   const T* __restrict__ b, const T* __restrict__ j1,
                   T* __restrict__ out, long long n) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (e >= n) return;
  const Pack<T, V> av = load<T, V>(a + e), bv = load<T, V>(b + e);
  const Pack<T, 2 * V> hv = load<T, 2 * V>(h + 2 * e),
                       j1v = load<T, 2 * V>(j1 + 2 * e);
  Pack<T, V> rv;
  Pack<T, 2 * V> j0v;
  if (kThree) {
    rv = load<T, V>(r + e);
    j0v = load<T, 2 * V>(j0 + 2 * e);
  }
  Pack<T, 2 * V> o;
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) {
    T acc = mul(av.v[k / 2], hv.v[k]);
    if (kThree) acc = add(acc, mul(rv.v[k / 2], j0v.v[k]));
    o.v[k] = add(acc, mul(bv.v[k / 2], j1v.v[k]));
  }
  store<T, 2 * V>(out + 2 * e, o);
}

// ---------------------------------------------------------- (d) truncate

// one output value a thread, flat q in the output's (and the table's)
// memory order: kKxMajor (i, j) at j nx + i, else i hy + j; jf (r, j) at
// r si + j sj.  The product by the real t is the twin's complex product
// by (t, 0), so a NaN or an infinity in jf propagates as it does there.
template <typename T, bool kKxMajor>
__global__ void __launch_bounds__(kThreads)
    truncate_kernel(const T* __restrict__ jf, const T* __restrict__ table,
                    T* __restrict__ out, int nx, int hy, int nxe, int si,
                    int sj) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= static_cast<long long>(nx) * hy) return;
  const int a = static_cast<int>(q / (kKxMajor ? nx : hy));
  const int b = static_cast<int>(q - static_cast<long long>(a) *
                                         (kKxMajor ? nx : hy));
  const int i = kKxMajor ? b : a, j = kKxMajor ? a : b;
  const int r = i < nx / 2 ? i : nxe - nx + i;
  const bool nyquist = j == hy - 1;
  const int src = nyquist ? (r == 0 ? 0 : nxe - r) : r;
  const Pack<T, 2> z = load<T, 2>(
      jf + 2 * (static_cast<size_t>(src) * si + static_cast<size_t>(j) * sj));
  const T re = z.v[0], im = nyquist ? -z.v[1] : z.v[1];
  const T t = table[q], zero = T(0);
  Pack<T, 2> o;
  o.v[0] = sub(mul(re, t), mul(im, zero));
  o.v[1] = add(mul(re, zero), mul(im, t));
  store<T, 2>(out + 2 * q, o);
}

// ------------------------------------------------------------- launchers

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

unsigned blocks(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T, bool kKxMajor>
void derivs_launch(const T* h, const T* rowk, const T* colk, T* out,
                   int rows, int hy, int nb, T scale, long long plane,
                   cudaStream_t st) {
  constexpr int kVec = kVecBytes / (2 * static_cast<int>(sizeof(T)));
  if (kVec > 1 && plane % kVec == 0 && aligned(out, kVecBytes))
    derivs_kernel<T, kVec, kKxMajor><<<blocks(plane / kVec), kThreads, 0,
                                       st>>>(h, rowk, colk, out, rows, hy,
                                             nb, scale);
  else
    derivs_kernel<T, 1, kKxMajor><<<blocks(plane), kThreads, 0, st>>>(
        h, rowk, colk, out, rows, hy, nb, scale);
}

template <typename T>
int launch_derivs(const T* h, const T* rowk, const T* colk, T* out, int rows,
                  int hy, int nb, int kx_major, double scale, void* stream) {
  if (rows <= 0 || nb <= 0 || nb > hy ||
      static_cast<long long>(rows) * hy >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = static_cast<long long>(rows) * nb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kx_major)
    derivs_launch<T, true>(h, rowk, colk, out, rows, hy, nb,
                           static_cast<T>(scale), plane, st);
  else
    derivs_launch<T, false>(h, rowk, colk, out, rows, hy, nb,
                            static_cast<T>(scale), plane, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kKyFastest>
void derivs_buffer_launch(const T* h, const T* rowk, const T* colk, T* out,
                          int rows, int si, int sj, int nb, int cols, int pad,
                          T scale, long long total, cudaStream_t st) {
  constexpr int kVec = kVecBytes / (2 * static_cast<int>(sizeof(T)));
  const int inner = kKyFastest ? cols : rows + pad;
  if (kVec > 1 && inner % kVec == 0 && aligned(out, kVecBytes))
    derivs_buffer_kernel<T, kVec, kKyFastest>
        <<<blocks(total / kVec), kThreads, 0, st>>>(h, rowk, colk, out, rows,
                                                    si, sj, nb, cols, pad,
                                                    scale);
  else
    derivs_buffer_kernel<T, 1, kKyFastest><<<blocks(total), kThreads, 0, st>>>(
        h, rowk, colk, out, rows, si, sj, nb, cols, pad, scale);
}

template <typename T>
int launch_derivs_buffer(const T* h, const T* rowk, const T* colk, T* out,
                         int rows, int si, int sj, int nb, int cols, int pad,
                         int ky_fastest, double scale, void* stream) {
  const long long total = static_cast<long long>(cols) * (rows + pad);
  if (rows <= 0 || nb <= 0 || nb > cols || pad < 0 || si <= 0 || sj <= 0 ||
      total * 4 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ky_fastest)
    derivs_buffer_launch<T, true>(h, rowk, colk, out, rows, si, sj, nb, cols,
                                  pad, static_cast<T>(scale), total, st);
  else
    derivs_buffer_launch<T, false>(h, rowk, colk, out, rows, si, sj, nb,
                                   cols, pad, static_cast<T>(scale), total,
                                   st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_truncate(const T* jf, const T* table, T* out, int nx, int hy,
                    int nxe, int si, int sj, int kx_major, void* stream) {
  if (nx <= 0 || nx % 2 || hy < 2 || nxe < nx || si <= 0 || sj <= 0 ||
      static_cast<long long>(nxe) * si >= (1LL << 31) ||
      static_cast<long long>(hy) * sj >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(nx) * hy;
  if (kx_major)
    truncate_kernel<T, true><<<blocks(n), kThreads, 0, st>>>(
        jf, table, out, nx, hy, nxe, si, sj);
  else
    truncate_kernel<T, false><<<blocks(n), kThreads, 0, st>>>(
        jf, table, out, nx, hy, nxe, si, sj);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_product(const T* in, T* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kVec = kVecBytes / static_cast<int>(sizeof(T));
  if (n % kVec == 0 && aligned(in, kVecBytes) && aligned(out, kVecBytes))
    product_kernel<T, kVec><<<blocks(n / kVec), kThreads, 0, st>>>(in, out, n);
  else
    product_kernel<T, 1><<<blocks(n), kThreads, 0, st>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
void combine_launch(const T* a, const T* h, const T* r, const T* j0,
                    const T* b, const T* j1, T* out, long long n,
                    cudaStream_t st) {
  if (j0 != nullptr)
    combine_kernel<T, V, true><<<blocks(n / V), kThreads, 0, st>>>(
        a, h, r, j0, b, j1, out, n);
  else
    combine_kernel<T, V, false><<<blocks(n / V), kThreads, 0, st>>>(
        a, h, r, j0, b, j1, out, n);
}

template <typename T>
int launch_combine(const T* a, const T* h, const T* r, const T* j0,
                   const T* b, const T* j1, T* out, long long n,
                   void* stream) {
  if (n <= 0 || (r == nullptr) != (j0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kVec = kVecBytes / (2 * static_cast<int>(sizeof(T)));
  constexpr int kRealBytes = kVec * static_cast<int>(sizeof(T));
  const bool vec = kVec > 1 && n % kVec == 0 && aligned(a, kRealBytes) &&
                   aligned(b, kRealBytes) && aligned(r, kRealBytes) &&
                   aligned(h, kVecBytes) && aligned(j0, kVecBytes) &&
                   aligned(j1, kVecBytes) && aligned(out, kVecBytes);
  if (vec)
    combine_launch<T, kVec>(a, h, r, j0, b, j1, out, n, st);
  else
    combine_launch<T, 1>(a, h, r, j0, b, j1, out, n, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (a): h (rows, hy) complex as interleaved (re, im); rowk (rows, 3), colk
// (>= nb, 3); out (4, rows, nb) complex; kx_major: h and each plane of out
// stored column by column (h's strides (1, rows)), else row by row
#define VORTEX_DERIVS_LAUNCHER(NAME, T)                                     \
  extern "C" int NAME(const T* h, const T* rowk, const T* colk, T* out,    \
                      int rows, int hy, int nb, int kx_major,              \
                      double scale, void* stream) {                        \
    return launch_derivs<T>(h, rowk, colk, out, rows, hy, nb, kx_major,    \
                            scale, stream);                                \
  }

VORTEX_DERIVS_LAUNCHER(vortex_derivs_half_f32, float)
VORTEX_DERIVS_LAUNCHER(vortex_derivs_half_f64, double)

// (a)'s buffer mode: h (rows, hy) complex, H[i, j] at complex element
// i si + j sj; out (cols, 4, rows + pad) complex, or (4, rows + pad, cols)
// with ky_fastest, every element written
#define VORTEX_DERIVS_BUFFER_LAUNCHER(NAME, T)                              \
  extern "C" int NAME(const T* h, const T* rowk, const T* colk, T* out,    \
                      int rows, int si, int sj, int nb, int cols, int pad, \
                      int ky_fastest, double scale, void* stream) {        \
    return launch_derivs_buffer<T>(h, rowk, colk, out, rows, si, sj, nb,   \
                                   cols, pad, ky_fastest, scale, stream);  \
  }

VORTEX_DERIVS_BUFFER_LAUNCHER(vortex_derivs_half_buffer_f32, float)
VORTEX_DERIVS_BUFFER_LAUNCHER(vortex_derivs_half_buffer_f64, double)

// (b): in (4, n) real, out (n)
#define VORTEX_PRODUCT_LAUNCHER(NAME, T)                                    \
  extern "C" int NAME(const T* in, T* out, long long n, void* stream) {   \
    return launch_product<T>(in, out, n, stream);                          \
  }

VORTEX_PRODUCT_LAUNCHER(vortex_product_f32, float)
VORTEX_PRODUCT_LAUNCHER(vortex_product_f64, double)

// (c): a, r, b (n) real; h, j0, j1, out (n) complex; r and j0 both null at
// stage 1
#define VORTEX_COMBINE_LAUNCHER(NAME, T)                                    \
  extern "C" int NAME(const T* a, const T* h, const T* r, const T* j0,     \
                      const T* b, const T* j1, T* out, long long n,        \
                      void* stream) {                                      \
    return launch_combine<T>(a, h, r, j0, b, j1, out, n, stream);          \
  }

VORTEX_COMBINE_LAUNCHER(vortex_cn_combine_f32, float)
VORTEX_COMBINE_LAUNCHER(vortex_cn_combine_f64, double)

// (d): jf (nxe, >= hy) complex, element (r, j) at complex element r si +
// j sj; table (nx, hy) real and out (nx, hy) complex, both column by column
// (kx_major) or both row by row
#define VORTEX_TRUNCATE_LAUNCHER(NAME, T)                                   \
  extern "C" int NAME(const T* jf, const T* table, T* out, int nx, int hy, \
                      int nxe, int si, int sj, int kx_major,               \
                      void* stream) {                                      \
    return launch_truncate<T>(jf, table, out, nx, hy, nxe, si, sj,         \
                              kx_major, stream);                           \
  }

VORTEX_TRUNCATE_LAUNCHER(vortex_truncate_32_f32, float)
VORTEX_TRUNCATE_LAUNCHER(vortex_truncate_32_f64, double)
