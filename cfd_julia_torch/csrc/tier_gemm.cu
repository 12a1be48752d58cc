// The cavity's bf16 precision tiers: a split-bf16 matrix product on the
// tensor cores for Hopper (sm_90a), in two kernels.
//
// Replaces the TPU matrix unit's bf16 dots that XLA emits for
// jnp.matmul(..., precision="high" | "default") in the JAX package's Poisson
// solves (cfd_julia_tpu/poisson/direct.py:99-102 and :133, and the packed
// step's cfd_julia_tpu/models/cavity_fused.py:120).  Those are not Pallas
// kernels; no library call computes them on the card (cuBLAS has no 3-pass
// bf16 mode, and a bf16 torch.matmul rounds its output to bf16).
//
//   C[M, N] = A[M, K] @ B[K, N], fp32 in and out
//   passes = 3 (XLA's bf16_3x, precision "high"):
//            x_hi = bf16(x), x_lo = bf16(x - x_hi) for x in A and B;
//            C = sum_k a_lo b_hi + a_hi b_lo + a_hi b_hi
//   passes = 1 (precision "default"): C = sum_k bf16(a) bf16(b)
//
// bf16 rounds to nearest even, as torch's .to(torch.bfloat16) does; x - hi
// is exact in fp32.
//
// 1. tier_split: one fp32 operand, read in place through its row stride,
//    into bf16 hi (and lo) planes, K-major for both roles and zero-padded
//    to whole tiles: an A operand (M, K) as (Mp, Kp), a B operand (K, N)
//    transposed through a shared-memory tile as (Np, Kp), Mp, Np, Kp
//    multiples of kBM, kBN and kBK.  The pass writes the pad's zeros itself.
//    Memory-bound: 4 MB in and 4 MB out at 1024^2 for 3 passes.  In the
//    Poisson solves one operand of every product is a constant sine
//    matrix, split once when the solver is built (ops/cuda_kernels.
//    TierPlan); only the field operand is split a call.
// 2. tier_gemm_tn_planes: C from the split planes, a block per kBM x kBN
//    tile of C
//    (8 x 16 = 128 blocks at 1024^2, one wave on 132 SMs).  One producer
//    warp keeps a ring of kStages stages full by TMA (cp.async.bulk.tensor,
//    128-byte swizzle, mbarrier full / empty pairs); a stage holds a k-block
//    of kBK = 64 (128-byte rows) of A's and B's planes, 48 KB for 3 passes.
//    Two consumer warpgroups own 64 x 64 of C each and multiply on
//    wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulators) straight from
//    the swizzled tiles through shared-memory descriptors.  A k-block's
//    passes (lo hi, hi lo, hi hi: the small terms first) go into a fresh
//    set of accumulators that is added to the tile's fp32 sums once the
//    k-block is done, two sets in turn so that one k-block's promotion
//    overlaps the next one's products: the tensor cores' own additions keep
//    fewer bits than an fp32 add, and with one accumulator across K = 1024
//    a kernel sat 4e-6 of max|C| from the twin, 3x cuBLAS's fp32
//    error (measured on an H100 80GB HBM3 at 700 W).  Masked fp32 stores to
//    the exact (M, N); no split-K and no atomics, so two calls are bitwise
//    equal.
// 3. its other epilogues (the same main loop, so the same fp32 C), for
//    the chained products of a sine-matrix Poisson solve, where each
//    product's output is the next one's field operand (ops/cuda_kernels.
//    TierSolve).  op(C) (C / t for an fp32 (M, N) table t, or C * scale:
//    the solve's / den and * scale, IEEE-rounded as torch's / and * are)
//    is stored as the bf16
//    planes the split pass would write of it, in the next plan's layout:
//    an A operand's (Mp, Kp) rows, or a B operand's transposed (Np, Kp)
//    rows; or as fp32 C.  A thread loads its 32 table values before the
//    main loop and applies op in registers after it.  Once both consumer
//    warpgroups are done with the ring, the tile op(C) goes into the
//    ring's shared memory (transposed for a B operand, rows padded
//    against bank conflicts), and each thread reads back 8 consecutive
//    values of a plane row, splits them with split8 (the split pass's
//    rounding) and stores 16 B of hi and of lo; fp32 C leaves from the
//    fragments as epilogue 2 stores it (C staged through shared memory
//    in 16-byte rows timed slower on the H100: 17.2 against 15.7 us at
//    1024^3, 3 passes).  Every element of the planes' padded extents is
//    written, the pad's zeros included, so a solve is one split (its
//    input field) and four GEMMs, where it was four splits, four GEMMs
//    and two elementwise passes: at 1024^2 a product writes 4 MB of
//    planes (3 passes) where its GEMM wrote 4 MB of C, the split read
//    them and wrote 4 MB of planes, and / den or * scale read 4 or 8 MB
//    and wrote 4.  The division costs ~4 us of the epilogue (IEEE / with
//    its per-element range check); the transposition ~0.2 us.
//
// What bounds it at the cavity's 1024^3: a pass is 2.15 GFLOP, 2.17 us at
// the H100's 989 TFLOP/s of dense bf16, so three passes 6.51 us; the GEMM
// reads 8 MB of bf16 planes and writes 4 MB (3.6 us at 3.35 TB/s).  Each
// block reads its 128-row A panel and 64-row B panel from L2, 768 KB for 3
// passes: ~96 MB a call from L2.
//
// C ABI (bound with ctypes by cfd_julia_torch/ops/cuda_kernels.py): the
// launchers run on the caller's stream, allocate nothing, do not
// synchronise (so a CUDA graph can capture them), and return
// cudaGetLastError() of the launch; tier_encode fills a TMA descriptor on
// the host (cuTensorMapEncodeTiled, looked up at run time, so the library
// does not link libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kBM = 128;      // rows of C a block
constexpr int kBN = 64;       // columns of C a block
constexpr int kBK = 64;       // k a stage: a 128-byte bf16 row
constexpr int kStages = 4;    // depth of the ring
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kChunk = 8;      // bf16 values a split thread writes: 16 B
constexpr int kSplitTile = 64;  // the transposing split's square tile
constexpr int kSplitThreads = 256;
// the planes epilogue's tile in the ring's shared memory, row pitches in
// floats: an A operand's kBM rows of kBN (8 floats of pad: a warp's float2
// stores of its 8 fragment rows fall in distinct banks) or, transposed for
// a B operand, kBN rows of kBM (4 of pad: its 4 x 8 scalar stores do)
constexpr int kTilePitch = kBN + 8;
constexpr int kTilePitchT = kBM + 4;

// the epilogue: fp32 C from the fragments, or op(C)'s bf16 planes as an A
// operand or a transposed B operand
enum Epilogue : int { kDirectC = 0, kPlanesA = 1, kPlanesB = 2 };
// the op on C before the store: none, / t (t an fp32 (M, N) table),
// * scale
enum Op : int { kOpNone = 0, kOpDivide = 1, kOpScale = 2 };

struct EpilogueArgs {
  void* out;            // fp32 C, or the planes (hi, then lo)
  int ld;               // C's row stride, or the planes' kp
  int out_rows;         // rows of a plane (C: unused)
  const float* table;   // op's table, row stride ldt
  int ldt;
  int op;
  float scale;
  int vec;              // C's rows take 8-byte stores
};

__host__ __device__ constexpr int planes(int passes) {
  return passes == 3 ? 2 : 1;
}
constexpr uint32_t kABytes = kBM * kBK * 2;  // one plane's A tile, 16 KB
constexpr uint32_t kBBytes = kBN * kBK * 2;  // one plane's B tile, 8 KB
__host__ __device__ constexpr uint32_t stage_bytes(int passes) {
  return planes(passes) * (kABytes + kBBytes);
}
// the ring, 1024-byte aligned (the 128-byte swizzle's period), and a full
// and an empty barrier a stage
constexpr size_t smem_bytes(int passes) {
  return 1024 + kStages * stage_bytes(passes) + 2 * kStages * 8;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// eight consecutive values into 16 B of hi and 16 B of lo bf16
__device__ __forceinline__ void split8(const float (&v)[kChunk], uint4& hi,
                                       uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const __nv_bfloat162 ll = __floats2bfloat162_rn(
        v[2 * i] - __low2float(hh), v[2 * i + 1] - __high2float(hh));
    h[i] = bits(hh);
    l[i] = bits(ll);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

template <int kPasses>
__device__ __forceinline__ void store8(__nv_bfloat16* out, size_t plane,
                                       size_t at, const float (&v)[kChunk]) {
  uint4 hi, lo;
  split8(v, hi, lo);
  *reinterpret_cast<uint4*>(out + at) = hi;
  if (kPasses == 3) *reinterpret_cast<uint4*>(out + plane + at) = lo;
}

// A role: out[r, c] = split(x[r, c]) on the (rows, cols) operand, 0 in the
// pad; a thread writes one 16-byte chunk of a row
template <int kPasses, bool kVec>
__global__ void __launch_bounds__(kSplitThreads)
    split_rows_kernel(const float* __restrict__ x, int rows, int cols,
                      int ld, __nv_bfloat16* __restrict__ out, int out_rows,
                      int kp) {
  const int chunks = kp / kChunk;
  const long q = static_cast<long>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (q >= static_cast<long>(out_rows) * chunks) return;
  const int r = static_cast<int>(q / chunks);
  const int c0 = static_cast<int>(q % chunks) * kChunk;
  const float* row = x + static_cast<size_t>(r) * ld;
  float v[kChunk];
  if (kVec && r < rows && c0 + kChunk <= cols) {
    const float4 u = *reinterpret_cast<const float4*>(row + c0);
    const float4 w = *reinterpret_cast<const float4*>(row + c0 + 4);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = r < rows && c0 + e < cols ? row[c0 + e] : 0.f;
  }
  store8<kPasses>(out, static_cast<size_t>(out_rows) * kp,
                  static_cast<size_t>(r) * kp + c0, v);
}

// B role: out[n, k] = split(x[k, n]) on the (rows, cols) = (K, N) operand,
// 0 in the pad; a block transposes a 64 x 64 tile through shared memory
template <int kPasses>
__global__ void __launch_bounds__(kSplitThreads)
    split_cols_kernel(const float* __restrict__ x, int rows, int cols,
                      int ld, __nv_bfloat16* __restrict__ out, int out_rows,
                      int kp) {
  __shared__ float tile[kSplitTile][kSplitTile + 1];  // [k][n]
  const int n0 = blockIdx.x * kSplitTile, k0 = blockIdx.y * kSplitTile;
  for (int i = threadIdx.x; i < kSplitTile * kSplitTile; i += kSplitThreads) {
    const int k = k0 + i / kSplitTile, n = n0 + i % kSplitTile;
    tile[i / kSplitTile][i % kSplitTile] =
        k < rows && n < cols ? x[static_cast<size_t>(k) * ld + n] : 0.f;
  }
  __syncthreads();
  constexpr int kRowChunks = kSplitTile / kChunk;
  for (int i = threadIdx.x; i < kSplitTile * kRowChunks; i += kSplitThreads) {
    const int nn = i / kRowChunks, kc = (i % kRowChunks) * kChunk;
    float v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = tile[kc + e][nn];
    store8<kPasses>(out, static_cast<size_t>(out_rows) * kp,
                    static_cast<size_t>(n0 + nn) * kp + k0 + kc, v);
  }
}

// ------------------------------------------------------------ the ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// a wait that outlasts ~2 s of clock cycles (a stage that never arrives)
// traps, a launch error, instead of hanging the card
constexpr long long kWaitCycles = 4000000000LL;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// a (kBK, rows) box at (k, row) of a tensor map into shared memory at dst,
// completing on the barrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// ------------------------------------------------------------ consumers

// wgmma's shared-memory descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle (as TMA wrote it): start address / 16 (bits 0-13),
// leading byte offset 16 B / 16 (unused by this layout), stride byte offset
// 1024 B / 16 (from one 8-row group to the next, bits 32-45), layout 1 =
// 128-byte swizzle (bits 62-63).  The k16 slice j of a 64-k row starts 32 j
// bytes in: the descriptor + 2 j.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B (scale_d 0) or d += A B: A 64 x 16 at descriptor da (m rows, K
// major), B 16 x 64 at db (n rows, K major), bf16 in, fp32 d; a thread of
// the warpgroup holds rows 16 w + l / 4 (+ 8) and columns 8 i + 2 (l % 4)
// (+ 1) of warp w, lane l: d[4 i + 2 h + e] at (16 w + l / 4 + 8 h,
// 8 i + 2 (l % 4) + e)
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// a k-block's products for the warpgroup's 64 rows into d, which they
// overwrite: the passes in the order lo hi, hi lo, hi hi, 4 k16 slices each
template <int kPasses>
__device__ __forceinline__ void kblock_products(float (&d)[32], uint32_t st,
                                                int wg) {
  constexpr int P = planes(kPasses);
  const uint64_t ah = desc_sw128(st + wg * (kABytes / 2));
  const uint64_t bh = desc_sw128(st + P * kABytes);
  if (kPasses == 3) {
    const uint64_t al = ah + (kABytes >> 4), bl = bh + (kBBytes >> 4);
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) wgmma64(d, al + 2 * j, bh + 2 * j, j);
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) wgmma64(d, ah + 2 * j, bl + 2 * j, 1);
  }
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    wgmma64(d, ah + 2 * j, bh + 2 * j, kPasses == 3 || j > 0);
}

// k-block kb's products into cur once its stage is full; then, for kb > 0,
// k-block kb - 1's (in prev) waited for, promoted into acc, and its stage
// released to the producer: one k-block's promotion overlaps the next one's
// products
template <int kPasses>
__device__ __forceinline__ void consume(float (&cur)[32], float (&prev)[32],
                                        float (&acc)[32], int kb,
                                        uint32_t ring, uint32_t full,
                                        uint32_t empty, int wg, int lane) {
  const int s = kb % kStages;
  mbar_wait(full + 8 * s, (kb / kStages) & 1);
  fence_regs(cur);
  wgmma_fence();
  kblock_products<kPasses>(cur, ring + s * stage_bytes(kPasses), wg);
  wgmma_commit();
  fence_regs(cur);
  if (kb > 0) {
    wgmma_wait<1>();
    fence_regs(prev);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += prev[i];
    if (lane == 0) mbar_arrive(empty + 8 * ((kb - 1) % kStages));
  }
}

// the op's table at a thread's 32 fragment elements (acc's layout; 1 past
// (M, N)), loaded before the main loop so that the loads overlap the
// products (loaded in the epilogue, each waited behind the previous
// element's division: 32 round trips, ~5 us a call on the H100)
__device__ __forceinline__ void load_table(float (&t)[32],
                                           const EpilogueArgs& e, int M,
                                           int N, int row0, int col0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = row0 + 8 * h, col = col0 + 8 * i + j;
        const bool read = e.op == kOpDivide && row < M && col < N;
        t[4 * i + 2 * h + j] =
            read ? e.table[static_cast<size_t>(row) * e.ldt + col] : 1.f;
      }
    }
  }
}

// acc = op(acc), rounded as torch rounds C / t and C * float32(scale):
// IEEE division (its range check ends a basic block at every use, ~3 us a
// call for the 32 here; div_rn.cuh's fast path from a reciprocal table,
// exact inside a guarded range, timed slower on the H100: the second
// table's loads and registers) and multiplication, __fmul_rn keeping a
// product out of the split's subtraction (no FMA contraction)
__device__ __forceinline__ void apply_op(float (&acc)[32],
                                         const float (&t)[32],
                                         const EpilogueArgs& e) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (e.op == kOpDivide)
      acc[i] = __fdiv_rn(acc[i], t[i]);
    else if (e.op == kOpScale)
      acc[i] = __fmul_rn(acc[i], e.scale);
  }
}

// fp32 C's stores: straight from the fragments, masked to (M, N),
// column pairs as 8-byte stores where rows are 8-byte aligned
__device__ __forceinline__ void store_direct(const float (&acc)[32],
                                             const EpilogueArgs& e, int M,
                                             int N, int row0, int col0) {
  float* C = static_cast<float*>(e.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= M) continue;
    float* crow = C + static_cast<size_t>(row) * e.ld;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = col0 + 8 * i;
      const float x = acc[4 * i + 2 * h], y = acc[4 * i + 2 * h + 1];
      if (e.vec && col + 1 < N) {
        *reinterpret_cast<float2*>(crow + col) = make_float2(x, y);
      } else {
        if (col < N) crow[col] = x;
        if (col + 1 < N) crow[col + 1] = y;
      }
    }
  }
}

// the planes epilogue: the block's tile of C (0 outside (M, N): the
// planes' pad) into the ring's shared memory, then out in rows of 16 bytes
template <int kPasses, int kEpi>
__device__ __forceinline__ void store_planes(const float (&acc)[32],
                                             const EpilogueArgs& e,
                                             float* tile, int M, int N,
                                             int m0, int n0, int wg, int warp,
                                             int lane) {
  // both warpgroups' products have read their last stage: the ring is free
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int c = c0 + 8 * i;
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = m0 + r, col = n0 + c + j;
        v[j] = row < M && col < N ? acc[4 * i + 2 * h + j] : 0.f;
      }
      if constexpr (kEpi == kPlanesB) {
        tile[c * kTilePitchT + r] = v[0];
        tile[(c + 1) * kTilePitchT + r] = v[1];
      } else {
        *reinterpret_cast<float2*>(tile + r * kTilePitch + c) =
            make_float2(v[0], v[1]);
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const int t = threadIdx.x;
  // 8 values of a plane row a thread a turn (an A operand's row
  // of C, a B operand's column), split as the split pass splits them
  auto* out = static_cast<__nv_bfloat16*>(e.out);
  const size_t plane = static_cast<size_t>(e.out_rows) * e.ld;
  constexpr bool kT = kEpi == kPlanesB;
  constexpr int kRows = kT ? kBN : kBM, kChunks = (kT ? kBM : kBN) / kChunk;
  constexpr int kPitch = kT ? kTilePitchT : kTilePitch;
  const int row_base = kT ? n0 : m0, k_base = kT ? m0 : n0;
  static_assert(kRows * kChunks % kConsumers == 0, "whole turns");
#pragma unroll
  for (int turn = 0; turn < kRows * kChunks / kConsumers; ++turn) {
    const int q = t + turn * kConsumers;
    const int r = q / kChunks, k = (q % kChunks) * kChunk;
    const int row = row_base + r, kk = k_base + k;
    if (row >= e.out_rows || kk >= e.ld) continue;
    const float4 u = *reinterpret_cast<const float4*>(tile + r * kPitch + k);
    const float4 w = *reinterpret_cast<const float4*>(tile + r * kPitch + k
                                                      + 4);
    const float v[kChunk] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    store8<kPasses>(out, plane, static_cast<size_t>(row) * e.ld + kk, v);
  }
}

template <int kPasses, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    tier_gemm_kernel(__grid_constant__ const CUtensorMap map_a,
                     __grid_constant__ const CUtensorMap map_b,
                     const EpilogueArgs epi, int M, int N, int k_blocks,
                     int a_lo, int b_lo) {
  constexpr int P = planes(kPasses);
  constexpr uint32_t kStage = stage_bytes(kPasses);
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * kStage, empty = full + 8 * kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread loads
    if (threadIdx.x == kConsumers) {
      for (int kb = 0; kb < k_blocks; ++kb) {
        const int s = kb % kStages;
        const uint32_t st = ring + s * kStage, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((kb / kStages) & 1) ^ 1);
        mbar_expect_tx(bar, kStage);
        tma_load(st, &map_a, bar, kb * kBK, m0);
        if (kPasses == 3) tma_load(st + kABytes, &map_a, bar, kb * kBK,
                                   a_lo + m0);
        tma_load(st + P * kABytes, &map_b, bar, kb * kBK, n0);
        if (kPasses == 3) tma_load(st + P * kABytes + kBBytes, &map_b, bar,
                                   kb * kBK, b_lo + n0);
      }
    }
    return;
  }

  // two consumer warpgroups, 64 rows of C each; ping-pong products
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
  float tv[32];
  load_table(tv, epi, M, N, row0, col0);
  float acc[32], p0[32], p1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = p0[i] = p1[i] = 0.f;
  for (int kb = 0; kb < k_blocks; kb += 2) {
    consume<kPasses>(p0, p1, acc, kb, ring, full, empty, wg, lane);
    if (kb + 1 < k_blocks)
      consume<kPasses>(p1, p0, acc, kb + 1, ring, full, empty, wg, lane);
  }
  wgmma_wait<0>();
  if ((k_blocks - 1) & 1) {
    fence_regs(p1);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += p1[i];
  } else {
    fence_regs(p0);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += p0[i];
  }

  apply_op(acc, tv, epi);
  if constexpr (kEpi == kDirectC) {
    store_direct(acc, epi, M, N, row0, col0);
  } else {
    // the ring as the tile (generic stores after the async proxy's reads
    // of the same bytes)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    store_planes<kPasses, kEpi>(
        acc, epi, reinterpret_cast<float*>(smem + (ring - smem_addr(smem))),
        M, N, m0, n0, wg, warp, lane);
  }
}

template <int kPasses, int kEpi>
int launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b,
                const EpilogueArgs& epi, int M, int N, int k_blocks,
                int a_lo, int b_lo, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(kPasses);
  static_assert(kBM * kTilePitch * 4 <= kStages * stage_bytes(kPasses) &&
                    kBN * kTilePitchT * 4 <= kStages * stage_bytes(kPasses),
                "the tile fits the ring");
  // dynamic shared memory above 48 KB must be allowed per kernel
  const cudaError_t e = cudaFuncSetAttribute(
      tier_gemm_kernel<kPasses, kEpi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  tier_gemm_kernel<kPasses, kEpi><<<grid, kThreads, bytes, stream>>>(
      map_a, map_b, epi, M, N, k_blocks, a_lo, b_lo);
  return static_cast<int>(cudaGetLastError());
}

template <int kPasses>
int launch_epilogue(const CUtensorMap& map_a, const CUtensorMap& map_b,
                    const EpilogueArgs& epi, int kind, int M, int N,
                    int k_blocks, int a_lo, int b_lo, cudaStream_t st) {
  switch (kind) {
    case kDirectC:
      return launch_gemm<kPasses, kDirectC>(map_a, map_b, epi, M, N,
                                            k_blocks, a_lo, b_lo, st);
    case kPlanesA:
      return launch_gemm<kPasses, kPlanesA>(map_a, map_b, epi, M, N,
                                            k_blocks, a_lo, b_lo, st);
    default:
      return launch_gemm<kPasses, kPlanesB>(map_a, map_b, epi, M, N,
                                            k_blocks, a_lo, b_lo, st);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace

// the split pass: x (rows, cols) fp32 with row stride ld (in elements) into
// out, planes hi (and lo for 3 passes) of (out_rows, kp) bf16; transpose = 0
// writes x as it is (an A operand), 1 transposed (a B operand, out_rows >=
// cols, kp >= rows); out_rows and kp multiples of 64
extern "C" int tier_split(const float* x, int rows, int cols, int ld,
                          int transpose, void* out, int out_rows, int kp,
                          int passes, void* stream) {
  const int need_rows = transpose ? cols : rows;
  const int need_k = transpose ? rows : cols;
  if (rows < 1 || cols < 1 || ld < cols || (passes != 1 && passes != 3) ||
      out_rows < need_rows || kp < need_k || out_rows % kSplitTile != 0 ||
      kp % kSplitTile != 0 || out_rows / kSplitTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (transpose) {
    const dim3 grid(out_rows / kSplitTile, kp / kSplitTile);
    if (passes == 3)
      split_cols_kernel<3><<<grid, kSplitThreads, 0, st>>>(x, rows, cols, ld,
                                                           o, out_rows, kp);
    else
      split_cols_kernel<1><<<grid, kSplitThreads, 0, st>>>(x, rows, cols, ld,
                                                           o, out_rows, kp);
    return static_cast<int>(cudaGetLastError());
  }
  const long chunks = static_cast<long>(out_rows) * (kp / kChunk);
  const unsigned blocks =
      static_cast<unsigned>((chunks + kSplitThreads - 1) / kSplitThreads);
  const bool vec = ld % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (passes == 3 && vec)
    split_rows_kernel<3, true><<<blocks, kSplitThreads, 0, st>>>(
        x, rows, cols, ld, o, out_rows, kp);
  else if (passes == 3)
    split_rows_kernel<3, false><<<blocks, kSplitThreads, 0, st>>>(
        x, rows, cols, ld, o, out_rows, kp);
  else if (vec)
    split_rows_kernel<1, true><<<blocks, kSplitThreads, 0, st>>>(
        x, rows, cols, ld, o, out_rows, kp);
  else
    split_rows_kernel<1, false><<<blocks, kSplitThreads, 0, st>>>(
        x, rows, cols, ld, o, out_rows, kp);
  return static_cast<int>(cudaGetLastError());
}

// the TMA descriptor (128 bytes at map) of a split buffer of an A (role 0)
// or B (role 1) operand: `rows` rows of kp bf16, read in boxes of kBK x kBM
// (A) or kBK x kBN (B) with the 128-byte swizzle
extern "C" int tier_encode(void* map, const void* base, int rows, int kp,
                           int role) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (rows < 1 || kp < kBK || kp % kBK != 0 || (role != 0 && role != 1) ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp) * 2};
  const cuuint32_t box[2] = {kBK, role == 0 ? kBM : kBN};
  const cuuint32_t steps[2] = {1, 1};
  CUtensorMap m;
  const CUresult r = fn(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(map, &m, sizeof m);
  return 0;
}

// C (M, N) = A @ B from the split planes behind map_a (A: hi rows 0.., lo
// rows a_lo..; a multiple of kBM rows a plane) and map_b (B transposed: hi
// rows 0.., lo rows b_lo..; a multiple of kBN rows a plane), k_blocks
// k-blocks of kBK, with op(C) stored by the epilogue `kind`: op 0 none, 1
// C / table (table fp32 with row stride ldt >= N), 2 C * float32(scale);
// kind 0 fp32 C from the fragments (out (M, N) with row stride ld >= N),
// 1 the bf16 planes of an A operand (out (planes, out_rows, ld) with M <=
// out_rows <= M rounded up to kBM and N <= ld <= N rounded up to kBN), 2
// those of a B operand, transposed (N <= out_rows <= N rounded up to kBN,
// M <= ld <= M rounded up to kBM); out_rows and ld (kp) multiples of 64,
// every element of the planes written, 0 outside op(C); out 16-byte
// aligned
extern "C" int tier_gemm_tn_planes(const void* map_a, const void* map_b,
                                   void* out, int M, int N, int ld,
                                   int out_rows, int k_blocks, int a_lo,
                                   int b_lo, int passes, int kind,
                                   const float* table, int ldt, int op,
                                   double scale, void* stream) {
  const int gm = (M + kBM - 1) / kBM * kBM, gn = (N + kBN - 1) / kBN * kBN;
  const bool planes_ok =
      kind == kPlanesA
          ? out_rows >= M && out_rows <= gm && ld >= N && ld <= gn
          : out_rows >= N && out_rows <= gn && ld >= M && ld <= gm;
  if (M < 1 || N < 1 || k_blocks < 1 || (passes != 1 && passes != 3) ||
      kind < kDirectC || kind > kPlanesB || op < kOpNone || op > kOpScale ||
      gm / kBM > 65535 ||
      (op == kOpDivide && (table == nullptr || ldt < N)) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (kind == kDirectC ? ld < N
                        : !planes_ok || out_rows % 64 != 0 || ld % 64 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  std::memcpy(&ma, map_a, sizeof ma);
  std::memcpy(&mb, map_b, sizeof mb);
  const int vec = ld % 2 == 0;
  const EpilogueArgs epi{out, ld, out_rows, table, ldt, op,
                         static_cast<float>(scale), vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return passes == 3 ? launch_epilogue<3>(ma, mb, epi, kind, M, N, k_blocks,
                                          a_lo, b_lo, st)
                     : launch_epilogue<1>(ma, mb, epi, kind, M, N, k_blocks,
                                          a_lo, b_lo, st);
}
