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
// int8 tensor rate; the 52 MB it moves take 0.016 ms.  This first version
// does not use the tensor cores: it runs on __dp4a, four int8 products
// and their sum into an int32 per instruction.  What the design does:
//   * A block owns a 128 x 128 tile of C; each of its 256 threads keeps an
//     8 x 8 int32 micro-tile in registers for the whole K loop.
//   * Per step of BK = 32, the block stages A and B in shared memory as
//     int32 words of four consecutive k (A's rows are contiguous in k; B's
//     four k of one column are gathered byte by byte), stored k-major, so
//     each thread reads 8 + 8 words per four k as int4s and does 64 dp4a.
//   * The kernel masks the ragged edges of M, N and K itself: bytes past
//     an edge read 0, which adds nothing to an integer sum.
//   * int32 cannot wrap: the wrapper takes K <= (2^31 - 1) / 128^2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

using repro::from_float;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int BQ = BK / 4;  // int32 words of four k in a step
constexpr int TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;

// The byte at p (0 when not in range), as the low byte of a word.
__device__ __forceinline__ uint32_t byte_at(const int8_t* p, bool in) {
  return in ? static_cast<uint32_t>(static_cast<uint8_t>(*p)) : 0u;
}

// Four bytes, the first lowest: the word __dp4a reads as four int8.
__device__ __forceinline__ int pack(uint32_t b0, uint32_t b1, uint32_t b2,
                                    uint32_t b3) {
  return static_cast<int>(b0 | b1 << 8 | b2 << 16 | b3 << 24);
}

// grid (gn, gm); kThreads threads.
template <typename TO>
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
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
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
  qgemm_int8_kernel<TO><<<grid, kThreads, 0, stream>>>(
      a, b, sa, sb, static_cast<TO*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K), b (K, N) int8 and c (M, N) of out_dtype (0 float32, 1
// bfloat16), row-major and contiguous; a_scale (M,), b_scale (N,) float32.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for an out_dtype or shape the kernel does not take.
extern "C" int repro_qgemm_int8(const void* a, const void* b,
                                const void* a_scale, const void* b_scale,
                                void* c, int M, int N, int K, int out_dtype,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch<float>(ap, bp, sa, sb, c, M, N, K, st);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(ap, bp, sa, sb, c, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
