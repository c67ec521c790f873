// Output-stationary GEMM with a fused epilogue, for Hopper (sm_90a):
//     C[M, N] = act(A[M, K] @ B[K, N] + bias[N])
// with act one of none, relu, gelu (tanh form) or silu; A and B float32
// or bfloat16 (one type), bias float32 or null, C float32 or bfloat16.
// Every product and sum is an IEEE float32 FMA, so a float32 call agrees
// with a float32 matrix product to about 1e-6 relative (no TF32).
//
// Replaces the TPU kernel src/repro/kernels/gemm_os/kernel.py
// (gemm_os_pallas: _gemm_kernel, _gemm_bias_kernel, _apply_act), the
// paper's Listing 1.  Same function: the float32 accumulator of one
// output tile stays on chip while K streams through, and the epilogue
// (bias, then the activation) runs once on it before the single store.
//
// Bound on the card.  At llama3.2-1b's ffn_in site in prefill (M 1024,
// K 2048, N 8192) the 34.4 GFLOP bound it: 0.035 ms at the bf16 tensor
// rate, 0.51 ms at the float32 rate.  At decode (M 8) the 33.6 MB of B
// bound it.  This first version is a block-tiled SIMT kernel; it does not
// use the tensor cores, so in bf16 it runs at the float32 rate.  What the
// design does:
//   * A block owns a BM x BN = 128 x 128 tile of C; each of its 256
//     threads keeps an 8 x 8 float32 micro-tile in registers for the whole
//     K loop (the output-stationary accumulator), so C is written once.
//   * Per step of BK = 8, the block stages an A tile (stored transposed,
//     k-major) and a B tile in shared memory as float32, converting bf16
//     on the way; each thread then reads 8 + 8 values per k as float4s
//     and does 64 FMAs.
//   * The kernel masks the ragged edges of M, N and K itself (out of
//     range loads read 0, out of range stores are skipped): no padded
//     copy of the operands is made.
//   * coalesce_grid (Listing 4) launches a 1-D grid over gm * gn tiles and
//     recovers the tile's (row, column) as (t / gn, t % gn); the per-tile
//     arithmetic is the same as the 2-D launch, so the two results are
//     equal bit for bit.
// Not built with fast math: the epilogue uses IEEE tanhf and expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;  // keeps the transposed A stores off one bank

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

// grid (gn, gm) or, with coalesce, (gm * gn); kThreads threads.
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
    gemm_os_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ bias, TO* __restrict__ C, int M,
                   int N, int K, int act, int coalesce) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN];

  int tile_m, tile_n;
  if (coalesce) {
    const int gn = (N + BN - 1) / BN;
    tile_m = blockIdx.x / gn;
    tile_n = blockIdx.x % gn;
  } else {
    tile_m = blockIdx.y;
    tile_n = blockIdx.x;
  }
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

}  // namespace

// a (M, K), b (K, N), c (M, N) row-major and contiguous; a and b of one
// dtype, c of out_dtype (0 float32, 1 bfloat16); bias (N,) float32 or null;
// act 0 none, 1 relu, 2 gelu, 3 silu; coalesce nonzero for the 1-D tile
// grid.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a dtype, activation or shape the kernel does
// not take.
extern "C" int repro_gemm_os(const void* a, const void* b, const void* bias,
                             void* c, int M, int N, int K, int dtype,
                             int out_dtype, int act, int coalesce,
                             void* stream) {
  const long long gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  if (M <= 0 || N <= 0 || K <= 0 || act < kNone || act > kSilu ||
      (coalesce ? gm * gn > 2147483647LL : gm > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_out<float>(out_dtype, a, b, bf, c, M, N, K, act, coalesce, st);
  if (dtype == 1)
    return dispatch_out<__nv_bfloat16>(out_dtype, a, b, bf, c, M, N, K, act,
                                       coalesce, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
