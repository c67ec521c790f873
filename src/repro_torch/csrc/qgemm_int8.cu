// Quantized int8 GEMM for Hopper (sm_90a):
//     C[m, n] = ((float)(A[m, :] . B[:, n]) * a_scale[m]) * b_scale[n]
// with A (M, K) and B (K, N) int8, the dot product accumulated exactly in
// int32, the scales float32, C float32 or bfloat16.
//
// Replaces the TPU kernel src/repro/kernels/qgemm_int8/kernel.py
// (qgemm_int8_pallas: _qgemm_kernel), the int8 edge datapath.  Same
// function: the int32 accumulator of one output tile stays on chip while
// K streams through, and the scales are applied once at the end, in the
// reference's order and rounding (two float32 multiplies, no FMA), so the
// output equals the plain version's bit for bit.
//
// Bound on the card.  At llama3.2-1b's ffn_in site in prefill (M 1024,
// K 2048, N 8192) the 34.4 G int8 operations bound it, 0.017 ms at the
// int8 tensor rate; the 52 MB it moves take 0.016 ms, two thirds of them
// the float32 output.
//
// Two routes, chosen by the wrapper from the shape and the pointers'
// alignment (kernels/qgemm_int8/kernel.py: route), one C entry point each:
//
// repro_qgemm_int8_tc, the tensor-core route: K and N multiples of 16 (TMA
// row strides) and 16-byte aligned pointers.  What the design does:
//   * A block owns a 256 x 128 tile of C, run by two consumer warpgroups
//     of 128 rows each, as two m64 halves on wgmma.mma_async m64n128k32
//     .s32.s8.s8, whose int32 sums are exact (|sum| <= K * 128^2 < 2^31
//     by the wrapper's K limit); 128 int32 accumulators a thread.
//   * One producer warp fills a ring of 4 stages by TMA, each a tile of A
//     (256 x 128 k) and of B (128 k x 128), both 128-byte swizzled, and
//     signals them through mbarriers; a stage goes back to the producer
//     once the wgmma groups that read it have completed.  The loads bound
//     it: every block reads its A rows and B columns from L2, and a
//     256-row tile reads B half as often as a 128-row one.
//   * B is (K, N) row-major, i.e. N-major, and wgmma reads 8-bit operands
//     from shared memory K-major only (no transpose for 8-bit types;
//     mma.sync s8 is row.col only and ldmatrix.trans moves 16-bit
//     elements).  So the transpose happens in the block: the consumers
//     rewrite each stage's B tile, as TMA brought it, into one of two
//     K-major swizzled tiles, in 4 x 4 byte blocks (four 32-bit shared
//     loads, eight __byte_perm, four 32-bit stores), dealt to the lanes
//     so that both the loads and the stores hit 32 distinct banks.  The
//     rewrite of k-tile k + 1 runs while the wgmma of k does, and it adds
//     no device-memory traffic, where a separate transpose kernel would
//     add a launch and 2 x 16.8 MB a call at the ffn_in site.
//   * TMA fills out-of-bounds parts of a box with zeros, which add
//     nothing to an integer sum, so ragged M, N and K need no masking in
//     the loads.
//   * Epilogue: the scaled float32 tile goes through shared memory (the
//     drained ring, rows padded to 136 floats so that the fragment's
//     stores hit distinct banks) and leaves in whole 512-byte rows, 16
//     bytes a lane, rows past M masked.
//
// repro_qgemm_int8, the SIMT route: every other shape (K or N not a
// multiple of 16, unaligned pointers), on __dp4a, four int8 products and
// their sum into an int32 per instruction.
//   * A block owns a 128 x 128 tile of C; each of its 256 threads keeps an
//     8 x 8 int32 micro-tile in registers for the whole K loop.
//   * Per step of BK = 32, the block stages A and B in shared memory as
//     int32 words of four consecutive k (A's rows are contiguous in k; B's
//     four k of one column are gathered byte by byte), stored k-major, so
//     each thread reads 8 + 8 words per four k as int4s and does 64 dp4a.
//   * The kernel masks the ragged edges of M, N and K itself: bytes past
//     an edge read 0, which adds nothing to an integer sum.
//   * K past kMaxK = (2^31 - 1) / 128^2 (the wrapper routes it here): the
//     int32 sum of a dot product may leave int32's range, where the
//     reference's int32 accumulator wraps.  The kernel is instantiated
//     with kWrap then: it sums K in chunks of kChunkK <= kMaxK, each exact
//     in int32, and adds the chunks' sums into a second accumulator in
//     uint32, whose addition wraps modulo 2^32.  Int32 addition is
//     associative modulo 2^32, so the total is the reference's word for
//     word, wraps included.
//
// Up to kMaxK no int32 sum can wrap on either route; the tensor-core route
// takes only K <= kMaxK.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "hopper.cuh"

namespace {

using repro::from_float;

namespace simt {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int BQ = BK / 4;  // int32 words of four k in a step
constexpr int TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;
// The largest K whose int32 sums cannot wrap, and the chunk of K (a whole
// number of BK steps, at most kMaxK) that the wrapping instantiation sums
// exactly before it adds the chunk into its uint32 total.
constexpr int kMaxK = 2147483647 / (128 * 128);
constexpr int kChunkK = kMaxK / BK * BK;

// The byte at p (0 when not in range), as the low byte of a word.
__device__ __forceinline__ uint32_t byte_at(const int8_t* p, bool in) {
  return in ? static_cast<uint32_t>(static_cast<uint8_t>(*p)) : 0u;
}

// Four bytes, the first lowest: the word __dp4a reads as four int8.
__device__ __forceinline__ int pack(uint32_t b0, uint32_t b1, uint32_t b2,
                                    uint32_t b3) {
  return static_cast<int>(b0 | b1 << 8 | b2 << 16 | b3 << 24);
}

// grid (gn, gm); kThreads threads.  kWrap: K > kMaxK, summed in chunks
// (see the note at the top).
template <typename TO, bool kWrap>
__global__ void __launch_bounds__(kThreads)
    qgemm_int8_kernel(const int8_t* __restrict__ A,
                      const int8_t* __restrict__ B,
                      const float* __restrict__ a_scale,
                      const float* __restrict__ b_scale, TO* __restrict__ C,
                      int M, int N, int K) {
  __shared__ __align__(16) int As[BQ][BM + kPad];
  __shared__ __align__(16) int Bs[BQ][BN + kPad];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  // With K a multiple of 4, a row's word of four k is one aligned load.
  const bool k_words = (K % 4) == 0;

  int acc[TM][TN];
  uint32_t total[kWrap ? TM : 1][kWrap ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  // The chunk's exact int32 sums into the wrapping total; acc restarts.
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if constexpr (kWrap) total[i][j] += static_cast<uint32_t>(acc[i][j]);
        acc[i][j] = 0;
      }
  };
  if constexpr (kWrap) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) total[i][j] = 0u;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (kWrap) {
      if (k0 > 0 && k0 % kChunkK == 0) fold();
    }
    // A: word q of row r, for q = tid % 8 and r = tid / 8 + 32 i.
#pragma unroll
    for (int i = 0; i < BM * BQ / kThreads; ++i) {
      const int q = tid % BQ, r = tid / BQ + (kThreads / BQ) * i;
      const int k = k0 + 4 * q;
      const bool row_in = m0 + r < M;
      const int8_t* p = A + static_cast<size_t>(m0 + r) * K + k;
      int word;
      if (k_words) {
        word = (row_in && k < K) ? __ldg(reinterpret_cast<const int*>(p)) : 0;
      } else {
        word = pack(byte_at(p, row_in && k < K),
                    byte_at(p + 1, row_in && k + 1 < K),
                    byte_at(p + 2, row_in && k + 2 < K),
                    byte_at(p + 3, row_in && k + 3 < K));
      }
      As[q][r] = word;
    }
    // B: word q of column c (B[k0 + 4q + 0..3][n0 + c]), for c = tid % 128
    // and q = tid / 128 + 2 i.
#pragma unroll
    for (int i = 0; i < BN * BQ / kThreads; ++i) {
      const int c = tid % BN, q = tid / BN + (kThreads / BN) * i;
      const int k = k0 + 4 * q, n = n0 + c;
      const bool col_in = n < N;
      const int8_t* p = B + static_cast<size_t>(k) * N + n;
      Bs[q][c] = pack(byte_at(p, col_in && k < K),
                      byte_at(p + N, col_in && k + 1 < K),
                      byte_at(p + 2 * static_cast<size_t>(N), col_in && k + 2 < K),
                      byte_at(p + 3 * static_cast<size_t>(N), col_in && k + 3 < K));
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < BQ; ++q) {
      int a[TM], b[TN];
      const int4 a0 = *reinterpret_cast<const int4*>(&As[q][ty * TM]);
      const int4 a1 = *reinterpret_cast<const int4*>(&As[q][ty * TM + 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Bs[q][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Bs[q][BN / 2 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if constexpr (kWrap) {
    fold();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = static_cast<int>(total[i][j]);
  }

  // Epilogue: rows m0 + ty * 8 + i, columns n0 + tx * 4 + j and
  // n0 + 64 + tx * 4 + j (j < 4), as in gemm_os.cu.
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
    if (n >= N) continue;
    const float sb = b_scale[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
      const float x =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), a_scale[m]), sb);
      C[static_cast<size_t>(m) * N + n] = from_float<TO>(x);
    }
  }
}

template <typename TO>
int launch(const int8_t* a, const int8_t* b, const float* sa,
           const float* sb, void* c, int M, int N, int K,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (K > kMaxK)
    qgemm_int8_kernel<TO, true><<<grid, kThreads, 0, stream>>>(
        a, b, sa, sb, static_cast<TO*>(c), M, N, K);
  else
    qgemm_int8_kernel<TO, false><<<grid, kThreads, 0, stream>>>(
        a, b, sa, sb, static_cast<TO*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

namespace tc {

using repro::hopper::EncodeTiled;
using repro::hopper::encoder;
using repro::hopper::fence_proxy_async;
using repro::hopper::fence_regs;
using repro::hopper::mbar_arrive;
using repro::hopper::mbar_expect_tx;
using repro::hopper::mbar_init;
using repro::hopper::mbar_wait;
using repro::hopper::named_barrier;
using repro::hopper::smem_desc;
using repro::hopper::smem_u32;
using repro::hopper::tma_load_2d;
using repro::hopper::wgmma_commit;
using repro::hopper::wgmma_fence;
using repro::hopper::wgmma_wait;

constexpr int BM = 256, BN = 128;
constexpr int BK = 128;                  // k per stage: one 128-byte swizzle row
constexpr int STAGES = 4;                // TMA stages: A and B as loaded
constexpr int kConsumers = 256;          // two warpgroups of 128 rows
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int A_BYTES = BM * BK;         // 32 KB
constexpr int B_BYTES = BK * BN;         // 16 KB, as loaded or K-major
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_STRIDE = BN + 8;       // floats a staged output row
constexpr int kSmem =
    STAGES * STAGE_BYTES + 2 * B_BYTES + 1024;  // + alignment
static_assert(BM * OUT_STRIDE * 4 <= STAGES * STAGE_BYTES,
              "the output tile is staged in the drained ring");

// D[64 x 128] += A[64 x 32] @ B[32 x 128], int8 in, int32 accumulate;
// both operands K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Rows r[i] = B[k + i][n .. n + 3] (byte j of r[i] is column n + j) to
// t[j] = B[k .. k + 3][n + j] (byte i of t[j] is row k + i).
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&t)[4]) {
  const uint32_t x0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t x1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t y0 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t y1 = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// Rewrites one stage's B tile, 128 k rows x 128 n bytes as TMA laid it
// out (byte (k, n) at k * 128 + ((n / 16) ^ (k % 8)) * 16 + n % 16), as
// 128 n rows x 128 k bytes in the same swizzle, the K-major layout wgmma
// reads.  The 32 x 32 blocks of 4 x 4 bytes, (w, q) = (n / 4, k / 4), are
// dealt so that a warp's 32 loads, and its 32 stores, hit 32 distinct
// banks: lane l takes w = l % 16 + 16 (o % 2) and q = l / 16 + 2 ((l %
// 16) ^ (o / 2)), for o = 4 warp + it over the 8 consumer warps and 4
// iterations.
__device__ __forceinline__ void transpose_b(const uint8_t* src, uint8_t* dst,
                                            int warp, int lane) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int o = 4 * warp + it;
    const int w = (lane & 15) | ((o & 1) << 4);
    const int q = (lane >> 4) | (((lane & 15) ^ (o >> 1)) << 1);
    uint32_t r[4], t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * q + i;
      r[i] = *reinterpret_cast<const uint32_t*>(
          src + k * 128 + ((((w >> 2) ^ (k & 7)) << 4) | ((w & 3) << 2)));
    }
    transpose4x4(r, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * w + j;
      *reinterpret_cast<uint32_t*>(
          dst + n * 128 + ((((q >> 2) ^ (n & 7)) << 4) | ((q & 3) << 2))) =
          t[j];
    }
  }
}

// Two consumer warpgroups, then one producer warp; grid (gn, gm).  Shared
// memory, from the first 1024-byte boundary: a ring of STAGES TMA stages,
// each a tile of A (256 m rows of 128 k) and one of B as loaded (128 k
// rows of 128 n), then two tiles of B K-major (128 n rows of 128 k).  A
// TMA stage passes from the producer (full: landed) to the consumers
// (empty: the wgmma groups that read it are done) and back.  In trip kt
// the consumers issue the wgmma of k-tile kt and, while it runs, rewrite
// the B of kt + 1 into the other K-major tile, whose last reader, the
// wgmma of kt - 1, both warpgroups completed before the trip's barrier.
template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    qgemm_int8_tc_kernel(const __grid_constant__ CUtensorMap tmA,
                         const __grid_constant__ CUtensorMap tmB,
                         const float* __restrict__ a_scale,
                         const float* __restrict__ b_scale,
                         TO* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bt_ring = ring + STAGES * STAGE_BYTES;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  uint8_t* bt_ptr = ring_ptr + STAGES * STAGE_BYTES;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp
    if (lane == 0) {  // one lane issues every load
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t sa = ring + s * STAGE_BYTES;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(sa, &tmA, kt * BK, m0, bar);
        tma_load_2d(sa + A_BYTES, &tmB, n0, kt * BK, bar);
      }
    }
    return;
  }

  // Rewrites k-tile kt's B into K-major tile kt % 2, visible to the async
  // proxy that wgmma reads through once the next barrier has passed.
  auto rewrite = [&](int kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    transpose_b(ring_ptr + s * STAGE_BYTES + A_BYTES,
                bt_ptr + (kt % 2) * B_BYTES, warp, lane);
    fence_proxy_async();
  };

  // Consumers: warpgroup wg owns rows m0 + 128 wg .. + 127, as two
  // m64 halves with 64 int32 accumulators each.
  const int wg = warp / 4;
  int acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;

  rewrite(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    // Both warpgroups' wgmma of kt - 1 are done: release its stage, and
    // meet, so that its K-major tile may be rewritten and kt's is visible.
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
    named_barrier(1, kConsumers);
    const uint32_t sa = ring + s * STAGE_BYTES + wg * 128 * 128;
    const uint32_t sb = bt_ring + (kt % 2) * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // 32 k further is 32 bytes along both swizzled rows; 8-row groups
      // are 1024 bytes apart, the second m64 half 8192 bytes on.
      const uint64_t db = smem_desc(sb + kk * 32, 16, 1024);
      wgmma_s8_m64n128(acc0, smem_desc(sa + kk * 32, 16, 1024), db);
      wgmma_s8_m64n128(acc1, smem_desc(sa + 64 * 128 + kk * 32, 16, 1024), db);
    }
    wgmma_commit();
    fence_regs(acc0);
    fence_regs(acc1);
    if (kt + 1 < k_tiles) rewrite(kt + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  named_barrier(1, kConsumers);  // no wgmma reads the ring any more

  // Scale the fragments into the staged tile: register 4 j + 2 h + e of
  // a thread holds row (warp % 4) * 16 + lane / 4 + 8 h of its m64 half,
  // column 8 j + 2 (lane % 4) + e.
  float* out_s = reinterpret_cast<float*>(ring_ptr);
  auto stage_half = [&](const int (&acc)[64], int half) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 128 + half * 64 + (warp % 4) * 16 + lane / 4 + 8 * h;
      const float sm = m0 + r < M ? a_scale[m0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        float2 x = make_float2(0.f, 0.f);
        if (n0 + c < N) {  // N % 16 == 0, so n0 + c + 1 < N as well
          x.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sm),
                          b_scale[n0 + c]);
          x.y = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sm),
              b_scale[n0 + c + 1]);
        }
        *reinterpret_cast<float2*>(&out_s[r * OUT_STRIDE + c]) = x;
      }
    }
  };
  stage_half(acc0, 0);
  stage_half(acc1, 1);
  named_barrier(1, kConsumers);
  // A warp stores one 128-column row at a time, 16 bytes a lane.
  for (int i = threadIdx.x; i < BM * (BN / 4); i += kConsumers) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    if (m0 + r < M && n0 + c < N)  // N % 16 == 0: the four are in or out
      repro::store4(C + static_cast<size_t>(m0 + r) * N + n0 + c,
                    *reinterpret_cast<const float4*>(&out_s[r * OUT_STRIDE + c]));
  }
}

template <typename TO>
int launch(const void* a, const void* b, const float* sa, const float* sb,
           void* c, int M, int N, int K, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap ta, tb;
  if (!repro::hopper::encode_2d(fn, &ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a,
                                M, K, BM, BK) ||
      !repro::hopper::encode_2d(fn, &tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b,
                                K, N, BK, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qgemm_int8_tc_kernel<TO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, kSmem, stream>>>(ta, tb, sa, sb,
                                            static_cast<TO*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc


bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The SIMT route.  a (M, K), b (K, N) int8 and c (M, N) of out_dtype (0
// float32, 1 bfloat16), row-major and contiguous; a_scale (M,), b_scale
// (N,) float32; any K >= 1 (past kMaxK summed in wrapping chunks).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an out_dtype or shape the kernel does not take.
extern "C" int repro_qgemm_int8(const void* a, const void* b,
                                const void* a_scale, const void* b_scale,
                                void* c, int M, int N, int K, int out_dtype,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + simt::BM - 1) / simt::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return simt::launch<float>(ap, bp, sa, sb, c, M, N, K, st);
  if (out_dtype == 1)
    return simt::launch<__nv_bfloat16>(ap, bp, sa, sb, c, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route: as repro_qgemm_int8 with K and N multiples of 16,
// K <= kMaxK (no int32 sum can wrap), and a, b and c 16-byte aligned.
// Returns cudaErrorInvalidValue for anything else, and
// cudaErrorSharedObjectSymbolNotFound when libcuda's tensor-map encoder
// cannot be found.
extern "C" int repro_qgemm_int8_tc(const void* a, const void* b,
                                   const void* a_scale, const void* b_scale,
                                   void* c, int M, int N, int K,
                                   int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 16 != 0 ||
      K > simt::kMaxK || !aligned16(a) || !aligned16(b) || !aligned16(c) ||
      (M + tc::BM - 1) / tc::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return tc::launch<float>(a, b, sa, sb, c, M, N, K, st);
  if (out_dtype == 1)
    return tc::launch<__nv_bfloat16>(a, b, sa, sb, c, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
