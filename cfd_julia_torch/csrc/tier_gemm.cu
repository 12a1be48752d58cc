// The cavity's bf16 precision tiers: a split-bf16 matrix product on the
// tensor cores for Hopper (sm_90a).
//
// Replaces the TPU matrix unit's bf16 dots that XLA emits for
// jnp.matmul(..., precision="high" | "default") in the JAX package's Poisson
// solves (cfd_julia_tpu/poisson/direct.py:99-102 and :133, and the packed
// step's cfd_julia_tpu/models/cavity_fused.py:120).  Those are not Pallas
// kernels; no library call computes them on the card (cuBLAS has no 3-pass
// bf16 mode, and a bf16 torch.matmul rounds its output to bf16).
//
//   C[M, N] = A[M, K] @ B[K, N], fp32 in and out, row-major, contiguous
//   passes = 3 (XLA's bf16_3x, precision "high"):
//            x_hi = bf16(x), x_lo = bf16(x - x_hi) for x in A and B;
//            C = sum_k a_hi b_hi + a_hi b_lo + a_lo b_hi
//   passes = 1 (precision "default"): C = sum_k bf16(a) bf16(b)
//
// bf16 rounds to nearest even, as torch's .to(torch.bfloat16) does; a - hi
// is exact in fp32.  The products run on mma.sync m16n8k16 (bf16 in, fp32
// accumulators).  Every pass of a k-tile (32 k, the small terms first) goes
// into one set of fresh accumulators, which are added to the output tile's
// fp32 sums once at the end of the k-tile: the tensor cores' own additions
// keep fewer bits than an fp32 add, and with one accumulator across all of
// K = 1024 the kernel sat 4e-6 of max|C| from the twin, 3x cuBLAS's fp32
// error (1e-5 for the sine matrix squared); added once a k-tile it sits
// 3e-7 away, for ~5% more time (measured on an H100 80GB HBM3 at 700 W).
// The plain twin (ops/cuda_kernels.tier_matmul_plain) takes each pass
// exactly in fp64 and rounds it to fp32, so kernel and twin differ by the
// accumulation alone.
//
// What bounds it at the cavity's 1024^3: a pass is 2.15 GFLOP, 2.17 us at the
// H100's 989 TFLOP/s of dense bf16; the three fp32 matrices are 12.6 MB,
// 3.76 us at 3.35 TB/s.  Three passes are bound by operations (6.51 us), one
// pass by bytes.
//
// Design, simple first (wgmma, TMA and a producer warp are later work): a
// block computes a 128 x 64 tile of C with 8 warps of 32 x 32 (4 along M, 2
// along N; 128 blocks at 1024^2, about one an SM).  K goes in tiles of 32:
// each thread loads its part of the next A and B tiles from device memory
// into registers (float4 when K and N are multiples of 4 and the operands
// 16-byte aligned, else four predicated scalars; zero past the edges) while
// the warps multiply the current tile, then splits them into hi and lo bf16
// as it stores them into the other of two shared-memory buffers: one
// __syncthreads a k-tile.  Fragments come from shared memory by ldmatrix (A,
// row-major) and ldmatrix.trans (B, stored k-major); rows padded to 80 and
// 144 bytes make both conflict-free.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): the
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise (so a CUDA graph can capture it), and returns
// cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBM = 128;       // rows of C a block
constexpr int kBN = 64;        // columns of C a block
constexpr int kBK = 32;        // k a tile
constexpr int kThreads = 256;  // 8 warps of 32 x 32
constexpr int kApad = kBK + 8;  // an A row in shared memory: 40 bf16, 80 B
constexpr int kBpad = kBN + 8;  // a B row (one k): 72 bf16, 144 B
// float4 groups of the A and B tiles a thread loads
constexpr int kAGroups = kBM * kBK / 4 / kThreads;  // 4
constexpr int kBGroups = kBK * kBN / 4 / kThreads;  // 2

struct Buffer {
  __nv_bfloat16 a[2][kBM][kApad];  // [hi, lo][m][k]
  __nv_bfloat16 b[2][kBK][kBpad];  // [hi, lo][k][n]
};
constexpr size_t kSmemBytes = 2 * sizeof(Buffer);  // 59,392 B

// (row, col .. col+3) of a row-major rows x cols matrix, 0 outside it
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int row,
                                        int col, int rows, int cols) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* q = p + static_cast<size_t>(row) * cols + col;
  if (kVec) {
    // cols % 4 == 0 and col % 4 == 0: all four in, or all out
    if (col < cols) v = *reinterpret_cast<const float4*>(q);
  } else {
    if (col < cols) v.x = q[0];
    if (col + 1 < cols) v.y = q[1];
    if (col + 2 < cols) v.z = q[2];
    if (col + 3 < cols) v.w = q[3];
  }
  return v;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// four consecutive values into hi (and, for 3 passes, lo) bf16 at hi / lo
template <int kPasses>
__device__ __forceinline__ void split_store(float4 v, __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(hi) = make_uint2(bits(h01), bits(h23));
  if (kPasses == 3) {
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(
        v.x - __low2float(h01), v.y - __high2float(h01));
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(
        v.z - __low2float(h23), v.w - __high2float(h23));
    *reinterpret_cast<uint2*>(lo) = make_uint2(bits(l01), bits(l23));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 16, row-major fragment) @ b (16 x 8, column-major fragment)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A and B tiles at k0 into registers
template <bool kVec>
__device__ __forceinline__ void load_tile(
    const float* __restrict__ A, const float* __restrict__ B,
    float4 (&ra)[kAGroups], float4 (&rb)[kBGroups], int m0, int n0, int k0,
    int M, int N, int K) {
#pragma unroll
  for (int i = 0; i < kAGroups; ++i) {
    const int g = threadIdx.x + i * kThreads;
    ra[i] = load4<kVec>(A, m0 + g / (kBK / 4), k0 + (g % (kBK / 4)) * 4, M,
                        K);
  }
#pragma unroll
  for (int i = 0; i < kBGroups; ++i) {
    const int g = threadIdx.x + i * kThreads;
    rb[i] = load4<kVec>(B, k0 + g / (kBN / 4), n0 + (g % (kBN / 4)) * 4, K,
                        N);
  }
}

// the registers' tiles, split, into a shared-memory buffer
template <int kPasses>
__device__ __forceinline__ void store_tile(Buffer& s,
                                           const float4 (&ra)[kAGroups],
                                           const float4 (&rb)[kBGroups]) {
#pragma unroll
  for (int i = 0; i < kAGroups; ++i) {
    const int g = threadIdx.x + i * kThreads;
    const int r = g / (kBK / 4), c = (g % (kBK / 4)) * 4;
    split_store<kPasses>(ra[i], &s.a[0][r][c], &s.a[1][r][c]);
  }
#pragma unroll
  for (int i = 0; i < kBGroups; ++i) {
    const int g = threadIdx.x + i * kThreads;
    const int r = g / (kBN / 4), c = (g % (kBN / 4)) * 4;
    split_store<kPasses>(rb[i], &s.b[0][r][c], &s.b[1][r][c]);
  }
}

template <int kPasses, bool kVec>
__global__ void __launch_bounds__(kThreads)
    tier_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  Buffer* buf = reinterpret_cast<Buffer*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[2][4][4];  // [m16 tile][n8 tile][fragment]: the sums over K
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  float4 ra[kAGroups], rb[kBGroups];
  const int tiles = (K + kBK - 1) / kBK;
  load_tile<kVec>(A, B, ra, rb, m0, n0, 0, M, N, K);
  store_tile<kPasses>(buf[0], ra, rb);
  if (tiles > 1) load_tile<kVec>(A, B, ra, rb, m0, n0, kBK, M, N, K);
  __syncthreads();

  // ldmatrix row addresses: lane l gives row l & 15 of A's 16 x 16 block at
  // column 8 (l >> 4) (matrices: rows 0-7 / 8-15 x k 0-7 / 8-15, the a0..a7
  // order); for B (k-major), k row (l & 7) + 8 ((l >> 3) & 1) at column
  // 8 (l >> 4), transposed: b0b1, b2b3 of two n8 tiles
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;

  for (int t = 0; t < tiles; ++t) {
    const Buffer& s = buf[t & 1];
    // this k-tile's products, added to acc once at its end
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &s.b[0][kk + b_row][wn + j * 16 + b_col]);
        bh[2 * j][0] = r[0];
        bh[2 * j][1] = r[1];
        bh[2 * j + 1][0] = r[2];
        bh[2 * j + 1][1] = r[3];
        if (kPasses == 3) {
          ldmatrix_x4_trans(r, &s.b[1][kk + b_row][wn + j * 16 + b_col]);
          bl[2 * j][0] = r[0];
          bl[2 * j][1] = r[1];
          bl[2 * j + 1][0] = r[2];
          bl[2 * j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t ah[4], al[4];
        ldmatrix_x4(ah, &s.a[0][wm + i * 16 + a_row][kk + a_col]);
        if (kPasses == 3)
          ldmatrix_x4(al, &s.a[1][wm + i * 16 + a_row][kk + a_col]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kPasses == 3) {  // the small terms first
            mma(part[i][j], al, bh[j][0], bh[j][1]);
            mma(part[i][j], ah, bl[j][0], bl[j][1]);
          }
          mma(part[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    // the next tile into the other buffer (last read before the previous
    // barrier), then the one after it into registers
    if (t + 1 < tiles) {
      store_tile<kPasses>(buf[(t + 1) & 1], ra, rb);
      if (t + 2 < tiles)
        load_tile<kVec>(A, B, ra, rb, m0, n0, (t + 2) * kBK, M, N, K);
    }
    __syncthreads();
  }

  // c0 c1 at (g, 2q), (g, 2q+1), c2 c3 eight rows below
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= M) continue;
      float* crow = C + static_cast<size_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + q2;
        if (col < N) crow[col] = acc[i][j][2 * h];
        if (col + 1 < N) crow[col + 1] = acc[i][j][2 * h + 1];
      }
    }
}

template <int kPasses, bool kVec>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           cudaStream_t stream) {
  // dynamic shared memory above 48 KB must be allowed per kernel
  const cudaError_t e = cudaFuncSetAttribute(
      tier_gemm_kernel<kPasses, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  tier_gemm_kernel<kPasses, kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tier_gemm(const float* a, const float* b, float* c, int M,
                         int N, int K, int passes, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (passes != 1 && passes != 3) ||
      (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (passes == 3)
    return vec ? launch<3, true>(a, b, c, M, N, K, st)
               : launch<3, false>(a, b, c, M, N, K, st);
  return vec ? launch<1, true>(a, b, c, M, N, K, st)
             : launch<1, false>(a, b, c, M, N, K, st);
}
