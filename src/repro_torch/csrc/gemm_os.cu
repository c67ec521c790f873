// Output-stationary GEMM with a fused epilogue, for Hopper (sm_90a):
//     C[M, N] = act(A[M, K] @ B[K, N] + bias[N])
// with act one of none, relu, gelu (tanh form) or silu; A and B float32
// or bfloat16 (one type), bias float32 or null, C float32 or bfloat16.
//
// Replaces the TPU kernel src/repro/kernels/gemm_os/kernel.py
// (gemm_os_pallas: _gemm_kernel, _gemm_bias_kernel, _apply_act), the
// paper's Listing 1.  Same function: the float32 accumulator of one
// output tile stays on chip while K streams through, and the epilogue
// (bias, then the activation) runs once on it before the single store.
//
// Three routes, chosen by the wrapper from the shape, the dtype and the
// pointers' alignment (kernels/gemm_os/kernel.py: route), one C entry
// point each:
//
// repro_gemm_os_tc, the tensor-core route: bfloat16 A and B with K and N
// multiples of 8 and 16-byte aligned pointers (what TMA takes).  At
// llama3.2-1b's ffn_in site in prefill (M 1024, K 2048, N 8192) the 34.4
// GFLOP bound it, 0.035 ms at the H100's bf16 tensor rate; at decode
// (M 8) the 33.6 MB of B, 0.010 ms at the HBM rate.  What the design does:
//   * A block owns a BM x BN tile of C: 128 x 128 for M > 64, run by two
//     consumer warpgroups of 64 rows each; 64 x 64 for M <= 64, one
//     consumer warpgroup, so that a decode GEMM at N 8192 has 128 blocks
//     streaming B.  The f32 accumulator lives in the consumers' registers
//     (wgmma.mma_async m64nBNk16, 64 or 32 floats a thread).
//   * A ring of shared-memory stages, each a BM x 64 tile of A and a
//     64 x BN tile of B in bf16, is filled by TMA (cp.async.bulk.tensor)
//     from one producer warp and signalled through mbarriers, so loads
//     run ahead of the math; a consumer releases a stage once the wgmma
//     group that read it has completed.  128 x 128 keeps 3 stages (97 KB,
//     two blocks an SM, so that one block's epilogue overlaps the other's
//     main loop); 64 x 64 keeps 12 (193 KB), so that decode has 96 KB of
//     B in flight per SM.
//   * Both tiles use the 128-byte swizzle.  A is K-major (rows of 64 k);
//     B is (K, N) row-major, i.e. N-major: its TMA boxes are 64 n wide
//     (128 bytes) and the wgmma takes it through the transpose flag, with
//     descriptor strides of 1024 bytes between groups of 8 k rows and
//     8192 bytes between 64-column boxes.
//   * TMA fills out-of-bounds boxes with zeros, so ragged M, N and K need
//     no masking in the loads; the epilogue masks the stores.
//   * The tensor maps are encoded on the host per call, through
//     libcuda's cuTensorMapEncodeTiled (hopper.cuh: encoder, encode_2d).
//
// repro_gemm_os_tf32x3, the float32 tensor-core route: float32 A and B
// with K and N multiples of 4 (16-byte rows) and 16-byte aligned
// pointers.  One TF32 product keeps 10 of float32's 23 mantissa bits and
// breaks the 1e-4 float32 bar, so each operand is split into two TF32
// numbers, x = hi + lo (hopper.cuh: split_tf32, to 2^-22 relative), and
// each product is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi: three TF32
// products at 495 TFLOP/s in place of one float32 FMA at 67.  At the
// ffn_in site the bound is the 34.4 GFLOP at TF32's rate, the card's
// fastest for float32 inputs: 0.0694 ms; the design's three products put
// its own ceiling at 0.208 ms.  What the design does:
//   * For .tf32, wgmma reads both shared-memory operands K-major only (the
//     transpose flag exists only for 16-bit types), and B is N-major.  Of
//     the ways round that, a split pass (option a): one extra launch in
//     the same call (split_kernel) writes A as [A_hi; A_lo], (2M, K), and
//     B transposed as [B_hi^T; B_lo^T], (2N, K), into scratch the wrapper
//     allocates.  At ffn_in that moves 8 + 64 MB in and 16 + 128 MB out,
//     about 0.065 ms at the HBM rate, and leaves the main kernel a plain
//     K-major TF32 GEMM: rewriting N-major tiles inside the block (as
//     qgemm_int8.cu does for int8) would cost shared-memory passes under
//     every k step, and mma.sync from registers reaches about 60% of the
//     wgmma rate.  The split values have their low 13 bits 0, so wgmma
//     reads them exactly.
//   * The scratch is capped (kernel.py: TF32X3_SCRATCH_BYTES, 2 GiB, 2.5%
//     of the card; ffn_in's 151 MB is one panel).  A product whose
//     2 (M + N) K floats pass the cap runs as panel products, one call of
//     this entry each, on the caller's stream: a row panel of A times a
//     column panel of B, whole tiles and the whole K, B read and C
//     written at their row strides ldb and ldc.  A panel's split operand
//     is written once for all the panel products that use it (split_a,
//     split_b), and every C tile is computed as in one whole call: the
//     same tile, the same K loop, so the two agree bit for bit.  Offsets
//     are 64-bit: at M = K = N = 60000, M K is 3.6e9.
//   * The main kernel is the bf16 route's block (producer warp, TMA ring,
//     128-byte swizzle, one or two consumer warpgroups) with float32
//     stages of 32 k: A_hi, A_lo, B_hi and B_lo tiles, 64 KB a stage at
//     128 x 128 (3 stages, one block an SM), 32 KB at 64 x 64 (3 stages,
//     two blocks an SM).  The 64 x 64 tile is taken for M <= 64 and
//     wherever 128 x 128 tiles would not fill the card (256^3: 16 blocks
//     in place of 4).
//   * Per stage the three products run as 12 wgmma m64nBNk8 into a
//     partial accumulator (the two cross terms first), which is then
//     added to the block's float32 sum with IEEE adds: the tensor cores'
//     float32 accumulation truncates, a bias that grows with K past
//     float32's own error (conv2d_os.cu measures it); over one stage of
//     32 k it is negligible.  Registers: two accumulators, 128 floats a
//     consumer thread at 128 x 128.
//   * Tiles walk M fastest (grid (gm, gn)): a wave of blocks then shares
//     each (2 x 128) x K tile of B^T across the M tiles, so B^T (128 MB at
//     ffn_in, more than the 50 MB L2) is read from memory about once.
//   * An output that comes out infinite or NaN (a non-finite input, or a
//     float32 overflow) is recomputed in the epilogue as a plain float32
//     dot product of A's row and B's column, so that it is what the plain
//     version gives: ∞ x b through the split would add ∞ b_hi and ∞ b_lo,
//     which is NaN where b_lo's sign differs from b's.  Finite inputs
//     never take that path.
//
// repro_gemm_os, the SIMT route: the shapes the tensor-core routes cannot
// take (K or N not a multiple of 4 in float32 or of 8 in bfloat16, or an
// unaligned pointer).  Every product and sum is an IEEE float32 FMA on
// the CUDA cores (no TF32), so the float32 rate caps it at 0.51 ms at
// the ffn_in site.  A block owns a 128 x 128 tile of C; each of its 256
// threads keeps an 8 x 8 float32 micro-tile in registers for the whole K
// loop.  Per step of BK = 8 the block stages an A tile (k-major) and a B
// tile in shared memory as float32, converting bf16 on the way, and masks
// ragged edges itself (out of range loads read 0).
//
// On every route coalesce_grid (Listing 4) launches a 1-D grid over
// gm * gn tiles and recovers the tile's (row, column) from the flat
// index; the per-tile arithmetic is the 2-D launch's, so the two results
// are equal bit for bit.  Two calls are equal bit for bit too: no atomics,
// no split K.  Not built with fast math: the epilogue uses IEEE tanhf and
// expf.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "hopper.cuh"

namespace {

using repro::from_float;
using repro::store2;
using repro::to_float;

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

// As the reference's _apply_act, in float32.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kGelu:
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
    case kSilu:
      return x * (1.f / (1.f + expf(-x)));
  }
  return x;
}

// The tile (row, column) of this block on a (gn, gm) or a flat grid.
__device__ __forceinline__ void tile_of(int N, int BN, int coalesce,
                                        int* tile_m, int* tile_n) {
  if (coalesce) {
    const int gn = (N + BN - 1) / BN;
    *tile_m = blockIdx.x / gn;
    *tile_n = blockIdx.x % gn;
  } else {
    *tile_m = blockIdx.y;
    *tile_n = blockIdx.x;
  }
}

namespace simt {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;  // keeps the transposed A stores off one bank

// grid (gn, gm) or, with coalesce, (gm * gn); kThreads threads.
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
    gemm_os_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ bias, TO* __restrict__ C, int M,
                   int N, int K, int act, int coalesce) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN];

  int tile_m, tile_n;
  tile_of(N, BN, coalesce, &tile_m, &tile_n);
  const int m0 = tile_m * BM, n0 = tile_n * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);

  // Staging: thread tid loads A[m0 + tid / 2][k0 + (tid % 2) * 4 + 0..3]
  // and B[k0 + tid / 32][n0 + (tid % 32) * 4 + 0..3].
  const int a_row = tid / 2, a_col = (tid % 2) * 4;
  const int b_row = tid / 32, b_col = (tid % 32) * 4;
  const bool a_in = m0 + a_row < M;
  const T* a_ptr = A + static_cast<size_t>(m0 + a_row) * K;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + a_col + j;
      As[a_col + j][a_row] = (a_in && k < K) ? to_float(a_ptr[k]) : 0.f;
    }
    {
      const int k = k0 + b_row;
      const T* b_ptr = B + static_cast<size_t>(k) * N + n0 + b_col;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Bs[b_row][b_col + j] =
            (k < K && n0 + b_col + j < N) ? to_float(b_ptr[j]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue.  Thread (tx, ty) holds rows m0 + ty * 8 + i and columns
  // n0 + tx * 4 + j and n0 + 64 + tx * 4 + j (j < 4).
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
    if (n >= N) continue;
    const float bn = bias ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
      float x = acc[i][j];
      if (bias) x += bn;
      C[static_cast<size_t>(m) * N + n] = from_float<TO>(activate(x, act));
    }
  }
}

template <typename T, typename TO>
int launch(const void* a, const void* b, const float* bias, void* c, int M,
           int N, int K, int act, int coalesce, cudaStream_t stream) {
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  const dim3 grid = coalesce ? dim3(gm * gn) : dim3(gn, gm);
  gemm_os_kernel<T, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), bias,
      static_cast<TO*>(c), M, N, K, act, coalesce);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_out(int out_dtype, const void* a, const void* b,
                 const float* bias, void* c, int M, int N, int K, int act,
                 int coalesce, cudaStream_t st) {
  if (out_dtype == 0)
    return launch<T, float>(a, b, bias, c, M, N, K, act, coalesce, st);
  if (out_dtype == 1)
    return launch<T, __nv_bfloat16>(a, b, bias, c, M, N, K, act, coalesce, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

namespace tc {

constexpr int BK = 64;         // k per stage: one 128-byte swizzle row of bf16
constexpr int kRowBytes = 128;  // a swizzled row: 64 bf16

using repro::hopper::EncodeTiled;
using repro::hopper::encoder;
using repro::hopper::fence_regs;
using repro::hopper::mbar_arrive;
using repro::hopper::mbar_expect_tx;
using repro::hopper::mbar_init;
using repro::hopper::mbar_wait;
using repro::hopper::smem_desc;
using repro::hopper::smem_u32;
using repro::hopper::tma_load_2d;
using repro::hopper::wgmma_commit;
using repro::hopper::wgmma_fence;
using repro::hopper::wgmma_wait;

// D[64 x N] += A[64 x 16] (K-major) @ B[16 x N] (N-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  wgmma_m64n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  wgmma_m64n128(d, da, db);
}

// NC consumer warpgroups (BM = 64 NC rows), then one producer warp; a
// ring of STAGES stages of A (BM x 64) and B (64 x BN), bf16, 128-byte
// swizzled, the ring starting at the first 1024-byte boundary of dynamic
// shared memory.  grid (gn, gm) or, with coalesce, (gm * gn).
template <int NC, int BN, int STAGES, typename TO>
__global__ void __launch_bounds__(128 * NC + 32, 1)
    gemm_os_tc_kernel(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmB,
                      const float* __restrict__ bias, TO* __restrict__ C,
                      int M, int N, int K, int act, int coalesce) {
  constexpr int BM = 64 * NC;
  constexpr int A_BYTES = BM * kRowBytes;
  constexpr int B_BOX_BYTES = BK * kRowBytes;  // 64 k rows x 64 n
  constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_BOX_BYTES;
  constexpr int kAcc = BN / 2;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  int tile_m, tile_n;
  tile_of(N, BN, coalesce, &tile_m, &tile_n);
  const int m0 = tile_m * BM, n0 = tile_n * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * NC);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t sa = ring + s * STAGE_BYTES, sb = sa + A_BYTES;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(sa, &tmA, kt * BK, m0, bar);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(sb + j * B_BOX_BYTES, &tmB, n0 + 64 * j, kt * BK, bar);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows m0 + 64 wg .. + 63.
  const int wg = warp / 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    const uint32_t sa = ring + s * STAGE_BYTES + wg * 64 * kRowBytes;
    const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: 16 k further is 32 bytes along the swizzled row; B: 16 k rows
      // further is 2048 bytes.  A's leading offset is unused (K-major,
      // swizzled); B's is the next 64-column box.
      wgmma_tile<BN>(acc, smem_desc(sa + kk * 32, 16, 1024),
                     smem_desc(sb + kk * 16 * kRowBytes, B_BOX_BYTES, 1024));
    wgmma_commit();
    fence_regs(acc);
    // The previous stage's products are done: release its buffers.
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue on the fragment: register 4 j + 2 h + e of a thread holds
  // row (warp % 4) * 16 + lane / 4 + 8 h of its warpgroup's 64, column
  // 8 j + 2 (lane % 4) + e.
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= N) continue;  // N % 8 == 0, so n + 1 < N as well
    const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m >= M) continue;
      float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (bias) {
        x0 += b0;
        x1 += b1;
      }
      store2(C + static_cast<size_t>(m) * N + n, activate(x0, act),
             activate(x1, act));
    }
  }
}

// A 2-D bf16 tensor map over a row-major (rows, cols) matrix with boxes of
// box_rows x 64 columns (128 bytes, swizzled).
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
            int cols, int box_rows) {
  return repro::hopper::encode_2d(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr,
                           rows, cols, box_rows, 64);
}

template <int NC, int BN, int STAGES, typename TO>
int launch(const void* a, const void* b, const float* bias, void* c, int M,
           int N, int K, int act, int coalesce, cudaStream_t stream) {
  constexpr int BM = 64 * NC;
  constexpr int smem =
      STAGES * (BM + (BN / 64) * BK) * kRowBytes + 1024;  // + alignment
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap ta, tb;
  if (!encode(fn, &ta, a, M, K, BM) || !encode(fn, &tb, b, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_os_tc_kernel<NC, BN, STAGES, TO>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  const dim3 grid = coalesce ? dim3(gm * gn) : dim3(gn, gm);
  kernel<<<grid, 128 * NC + 32, smem, stream>>>(
      ta, tb, bias, static_cast<TO*>(c), M, N, K, act, coalesce);
  return static_cast<int>(cudaGetLastError());
}

// (block_m, block_n) = (128, 128): two consumer warpgroups, 3 stages (97
// KB, so two blocks share an SM and one's epilogue overlaps the other's
// loads); (64, 64): one consumer warpgroup, 12 stages (193 KB).
template <typename TO>
int dispatch_tile(int block_m, int block_n, const void* a, const void* b,
                  const float* bias, void* c, int M, int N, int K, int act,
                  int coalesce, cudaStream_t st) {
  if (block_m == 128 && block_n == 128)
    return launch<2, 128, 3, TO>(a, b, bias, c, M, N, K, act, coalesce, st);
  if (block_m == 64 && block_n == 64)
    return launch<1, 64, 12, TO>(a, b, bias, c, M, N, K, act, coalesce, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

namespace tf32x3 {

constexpr int BK = 32;          // k per stage: a 128-byte swizzle row of float32
constexpr int kRowBytes = 128;  // a swizzled row: 32 float32
constexpr int kSplitThreads = 256;

using repro::hopper::EncodeTiled;
using repro::hopper::encoder;
using repro::hopper::fence_regs;
using repro::hopper::is_finite;
using repro::hopper::mbar_arrive;
using repro::hopper::mbar_expect_tx;
using repro::hopper::mbar_init;
using repro::hopper::mbar_wait;
using repro::hopper::smem_desc;
using repro::hopper::smem_u32;
using repro::hopper::split_tf32;
using repro::hopper::tma_load_2d;
using repro::hopper::wgmma_commit;
using repro::hopper::wgmma_fence;
using repro::hopper::wgmma_wait;

// The split pass.  Blocks [0, a_blocks): A2[i] = hi(A[i]) and A2[M K + i]
// = lo(A[i]), four floats a thread.  The rest: one 32 x 32 tile of B each
// (B's rows ldb floats apart), transposed through shared memory,
// B2[n][k] = hi(B[k][n]) and B2[N + n][k] = lo(B[k][n]).  kSplitThreads
// threads.  Offsets are 64-bit: M K passes 2^31 at M = K = 60000.
__global__ void __launch_bounds__(kSplitThreads)
    split_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ A2, float* __restrict__ B2, int M, int N,
                 int K, int ldb, long long a_blocks) {
  if (static_cast<long long>(blockIdx.x) < a_blocks) {
    const size_t mk = static_cast<size_t>(M) * K;
    const size_t i = (static_cast<size_t>(blockIdx.x) * kSplitThreads +
                      threadIdx.x) * 4;
    if (i >= mk) return;  // M K % 4 == 0: whole float4s
    const float4 v = *reinterpret_cast<const float4*>(A + i);
    float4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(A2 + i) = hi;
    *reinterpret_cast<float4*>(A2 + mk + i) = lo;
    return;
  }
  __shared__ float t[32][33];
  const long long tile = static_cast<long long>(blockIdx.x) - a_blocks;
  const int tiles_n = (N + 31) / 32;
  const int k0 = static_cast<int>(tile / tiles_n) * 32;
  const int n0 = static_cast<int>(tile % tiles_n) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < 32; r += kSplitThreads / 32) {
    const int k = k0 + r, n = n0 + tx;
    t[r][tx] = (k < K && n < N) ? B[static_cast<size_t>(k) * ldb + n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += kSplitThreads / 32) {
    const int n = n0 + r, k = k0 + tx;
    if (n >= N || k >= K) continue;
    float hi, lo;
    split_tf32(t[tx][r], hi, lo);
    B2[static_cast<size_t>(n) * K + k] = hi;
    B2[(static_cast<size_t>(N) + n) * K + k] = lo;
  }
}

// D[64 x N] += A[64 x 8] (K-major) @ B[8 x N] (K-major), TF32; scale_d 0
// writes D = A B.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  wgmma_m64n64k8(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  wgmma_m64n128k8(d, da, db, scale_d);
}

// sum_k A[m][k] B[k][n] by IEEE float32 FMAs, k in order, B's rows ldb
// floats apart: the epilogue's value for an output whose split sum is not
// finite.
__device__ __noinline__ float dot_f32(const float* __restrict__ A,
                                      const float* __restrict__ B, int m,
                                      int n, int ldb, int K) {
  const float* a = A + static_cast<size_t>(m) * K;
  float s = 0.f;
  for (int k = 0; k < K; ++k)
    s = fmaf(a[k], B[static_cast<size_t>(k) * ldb + n], s);
  return s;
}

// NC consumer warpgroups (BM = 64 NC rows), then one producer warp; a
// ring of STAGES stages, each [A_hi | A_lo] (BM x 32 float32 each) and
// [B_hi | B_lo] (BN x 32 each, K-major), 128-byte swizzled, the ring
// starting at the first 1024-byte boundary of dynamic shared memory.
// tmA maps A2 (2M, K), tmB B2 (2N, K); A and B are the panel's own inputs
// (B's rows ldb floats apart), read only to recompute a non-finite output;
// C's rows are ldc apart.  grid (gm, gn) or, with coalesce, (gm * gn), M
// fastest.
template <int NC, int BN, int STAGES, typename TO>
__global__ void __launch_bounds__(128 * NC + 32, NC == 1 ? 2 : 1)
    gemm_os_tf32x3_kernel(const __grid_constant__ CUtensorMap tmA,
                          const __grid_constant__ CUtensorMap tmB,
                          const float* __restrict__ A,
                          const float* __restrict__ B,
                          const float* __restrict__ bias, TO* __restrict__ C,
                          int M, int N, int K, int ldb, int ldc, int act,
                          int coalesce) {
  constexpr int BM = 64 * NC;
  constexpr int A_BYTES = BM * kRowBytes;  // one of A_hi, A_lo
  constexpr int B_BYTES = BN * kRowBytes;  // one of B_hi, B_lo
  constexpr int STAGE_BYTES = 2 * (A_BYTES + B_BYTES);
  constexpr int kAcc = BN / 2;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  int tile_m, tile_n;
  if (coalesce) {
    const int gm = (M + BM - 1) / BM;
    tile_m = blockIdx.x % gm;
    tile_n = blockIdx.x / gm;
  } else {
    tile_m = blockIdx.x;
    tile_n = blockIdx.y;
  }
  const int m0 = tile_m * BM, n0 = tile_n * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * NC);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)
          mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) - 1) & 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t sa = ring + s * STAGE_BYTES, sb = sa + 2 * A_BYTES;
        mbar_expect_tx(bar, STAGE_BYTES);
        // Rows past M (N) of the hi box read the first lo rows: they feed
        // only outputs past M (N), which are never stored.  Past 2M (2N)
        // and K, TMA fills zeros.
        tma_load_2d(sa, &tmA, kt * BK, m0, bar);
        tma_load_2d(sa + A_BYTES, &tmA, kt * BK, M + m0, bar);
        tma_load_2d(sb, &tmB, kt * BK, n0, bar);
        tma_load_2d(sb + B_BYTES, &tmB, kt * BK, N + n0, bar);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows m0 + 64 wg .. + 63.
  const int wg = warp / 4;
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    const uint32_t a_hi = ring + s * STAGE_BYTES + wg * 64 * kRowBytes;
    const uint32_t a_lo = a_hi + A_BYTES;
    const uint32_t b_hi = ring + s * STAGE_BYTES + 2 * A_BYTES;
    const uint32_t b_lo = b_hi + B_BYTES;
    fence_regs(part);
    wgmma_fence();
    // 8 k further is 32 bytes along both swizzled rows; the leading
    // offset is unused (K-major, swizzled), 1024 bytes a group of 8 rows.
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_tile<BN>(part, smem_desc(a_lo + kk * 32, 16, 1024),
                     smem_desc(b_hi + kk * 32, 16, 1024), kk);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_tile<BN>(part, smem_desc(a_hi + kk * 32, 16, 1024),
                     smem_desc(b_lo + kk * 32, 16, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_tile<BN>(part, smem_desc(a_hi + kk * 32, 16, 1024),
                     smem_desc(b_hi + kk * 32, 16, 1024), 1);
    wgmma_commit();
    fence_regs(part);
    wgmma_wait<0>();
    fence_regs(part);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
  }

  // Epilogue on the fragment: register 4 j + 2 h + e of a thread holds
  // row (warp % 4) * 16 + lane / 4 + 8 h of its warpgroup's 64, column
  // 8 j + 2 (lane % 4) + e.
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= N) continue;  // N % 4 == 0 and n even, so n + 1 < N as well
    const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m >= M) continue;
      float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (!is_finite(x0)) x0 = dot_f32(A, B, m, n, ldb, K);
      if (!is_finite(x1)) x1 = dot_f32(A, B, m, n + 1, ldb, K);
      if (bias) {
        x0 += b0;
        x1 += b1;
      }
      store2(C + static_cast<size_t>(m) * ldc + n, activate(x0, act),
             activate(x1, act));
    }
  }
}

// One panel product: the split pass over the operands it is asked to split
// (none, either or both), then the product.
template <int NC, int BN, int STAGES, typename TO>
int launch(const float* a, const float* b, const float* bias, void* c,
           float* a2, float* b2, int M, int N, int K, int ldb, int ldc,
           bool split_a, bool split_b, int act, int coalesce,
           cudaStream_t stream) {
  constexpr int BM = 64 * NC;
  constexpr int smem =
      STAGES * 2 * (BM + BN) * kRowBytes + 1024;  // + alignment
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const long long a_blocks =
      split_a ? (static_cast<long long>(M) * K / 4 + kSplitThreads - 1) /
                    kSplitThreads
              : 0;
  const long long b_tiles =
      split_b ? static_cast<long long>((K + 31) / 32) * ((N + 31) / 32) : 0;
  if (a_blocks + b_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  if (!repro::hopper::encode_2d(fn, &ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                a2, 2 * M, K, BM, BK) ||
      !repro::hopper::encode_2d(fn, &tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                b2, 2 * N, K, BN, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemm_os_tf32x3_kernel<NC, BN, STAGES, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a_blocks + b_tiles > 0) {
    split_kernel<<<static_cast<unsigned>(a_blocks + b_tiles), kSplitThreads,
                   0, stream>>>(a, b, a2, b2, M, N, K, ldb, a_blocks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  const dim3 grid = coalesce ? dim3(gm * gn) : dim3(gm, gn);
  kernel<<<grid, 128 * NC + 32, smem, stream>>>(ta, tb, a, b, bias,
                                                static_cast<TO*>(c), M, N, K,
                                                ldb, ldc, act, coalesce);
  return static_cast<int>(cudaGetLastError());
}

// (block_m, block_n) = (128, 128): two consumer warpgroups, 3 stages of 64
// KB (193 KB, one block an SM); (64, 64): one consumer warpgroup, 3 stages
// of 32 KB (97 KB, two blocks an SM).
template <typename TO>
int dispatch_tile(int block_m, int block_n, const float* a, const float* b,
                  const float* bias, void* c, float* a2, float* b2, int M,
                  int N, int K, int ldb, int ldc, bool split_a, bool split_b,
                  int act, int coalesce, cudaStream_t st) {
  if (block_m == 128 && block_n == 128)
    return launch<2, 128, 3, TO>(a, b, bias, c, a2, b2, M, N, K, ldb, ldc,
                                 split_a, split_b, act, coalesce, st);
  if (block_m == 64 && block_n == 64)
    return launch<1, 64, 3, TO>(a, b, bias, c, a2, b2, M, N, K, ldb, ldc,
                                split_a, split_b, act, coalesce, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tf32x3

bool bad_grid(int M, int N, int bm, int bn, int coalesce) {
  const long long gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  return coalesce ? gm * gn > 2147483647LL : gm > 65535;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The SIMT route.  a (M, K), b (K, N), c (M, N) row-major and contiguous;
// a and b of one dtype (0 float32, 1 bfloat16), c of out_dtype (the
// same codes); bias (N,) float32 or null; act 0 none, 1 relu, 2 gelu,
// 3 silu; coalesce nonzero for the 1-D tile grid.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// dtype, activation or shape the kernel does not take.
extern "C" int repro_gemm_os(const void* a, const void* b, const void* bias,
                             void* c, int M, int N, int K, int dtype,
                             int out_dtype, int act, int coalesce,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < kNone || act > kSilu ||
      bad_grid(M, N, simt::BM, simt::BN, coalesce))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch_out<float>(out_dtype, a, b, bf, c, M, N, K, act,
                                     coalesce, st);
  if (dtype == 1)
    return simt::dispatch_out<__nv_bfloat16>(out_dtype, a, b, bf, c, M, N, K,
                                             act, coalesce, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route: as repro_gemm_os with a and b bfloat16, K and N
// multiples of 8, a, b and c 16-byte aligned, and the tile (block_m,
// block_n) one of (128, 128) and (64, 64).  Returns cudaErrorInvalidValue
// for anything else, and cudaErrorSharedObjectSymbolNotFound when
// libcuda's tensor-map encoder cannot be found.
extern "C" int repro_gemm_os_tc(const void* a, const void* b,
                                const void* bias, void* c, int M, int N,
                                int K, int out_dtype, int act, int coalesce,
                                int block_m, int block_n, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      act < kNone || act > kSilu || block_m <= 0 || block_n <= 0 ||
      !aligned16(a) || !aligned16(b) || !aligned16(c) ||
      bad_grid(M, N, block_m, block_n, coalesce))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return tc::dispatch_tile<float>(block_m, block_n, a, b, bf, c, M, N, K,
                                    act, coalesce, st);
  if (out_dtype == 1)
    return tc::dispatch_tile<__nv_bfloat16>(block_m, block_n, a, b, bf, c, M,
                                            N, K, act, coalesce, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 tensor-core route, one panel product: C[m0 + i][n0 + j] =
// act(sum_k A[m0 + i][k] B[k][n0 + j] + bias[n0 + j]) for i < M, j < N,
// where a is A (rows of K floats), b is B (rows of ldb floats), c is C
// (rows of ldc, of out_dtype) and bias, when not null, B's columns' bias;
// a whole call is the panel m0 = n0 = 0, M and N the whole, ldb = ldc = N.
// a and b float32, K, N, ldb and ldc multiples of 4, n0 + N at most ldb and
// ldc, a, b, c, a2 and b2 16-byte aligned, the tile (block_m, block_n) one
// of (128, 128) and (64, 64).  a2 holds a2_floats floats, at least 2 M K
// (the panel's split A, (2M, K)), b2 b2_floats, at least 2 N K (its split
// B^T, (2N, K)); split_a / split_b nonzero writes them from a and b first,
// zero reuses what an earlier panel product on the stream left there.  Up
// to two launches on the stream: the split pass, if it has work, then the
// product.  Offsets are taken in 64 bits.  Returns cudaErrorInvalidValue
// for anything else, and cudaErrorSharedObjectSymbolNotFound when libcuda's
// tensor-map encoder cannot be found.
extern "C" int repro_gemm_os_tf32x3(
    const void* a, const void* b, const void* bias, void* c, void* a2,
    long long a2_floats, void* b2, long long b2_floats, long long m0,
    long long n0, int M, int N, int K, int ldb, int ldc, int split_a,
    int split_b, int out_dtype, int act, int coalesce, int block_m,
    int block_n, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || N % 4 != 0 ||
      ldb % 4 != 0 || ldc % 4 != 0 || m0 < 0 || n0 < 0 || n0 + N > ldb ||
      n0 + N > ldc || act < kNone || act > kSilu || block_m <= 0 ||
      block_n <= 0 || M >= (1 << 30) || N >= (1 << 30) || !aligned16(a) ||
      !aligned16(b) || !aligned16(c) || !aligned16(a2) || !aligned16(b2) ||
      a2_floats < 2LL * M * K || b2_floats < 2LL * N * K ||
      (coalesce ? bad_grid(M, N, block_m, block_n, 1)
                : (N + block_n - 1) / block_n > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a) + m0 * K;
  const float* bf = static_cast<const float*>(b) + n0;
  const float* biasf = bias ? static_cast<const float*>(bias) + n0 : nullptr;
  const long long c_off = m0 * ldc + n0;
  float* a2f = static_cast<float*>(a2);
  float* b2f = static_cast<float*>(b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return tf32x3::dispatch_tile<float>(
        block_m, block_n, af, bf, biasf, static_cast<float*>(c) + c_off, a2f,
        b2f, M, N, K, ldb, ldc, split_a, split_b, act, coalesce, st);
  if (out_dtype == 1)
    return tf32x3::dispatch_tile<__nv_bfloat16>(
        block_m, block_n, af, bf, biasf,
        static_cast<__nv_bfloat16*>(c) + c_off, a2f, b2f, M, N, K, ldb, ldc,
        split_a, split_b, act, coalesce, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
