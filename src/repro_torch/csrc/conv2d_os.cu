// Output-stationary direct convolution for Hopper (sm_90a): valid,
// stride 1, NHWC,
//     out[n, oh, ow, co] = sum_{kh, kw, ci} x[n, oh + kh, ow + kw, ci]
//                                            * w[kh, kw, ci, co]
// with x and w float32 or bfloat16 (one type), every product and sum an
// IEEE float32 FMA, out float32 or bfloat16.
//
// Replaces the TPU kernel src/repro/kernels/conv2d_os/kernel.py
// (conv2d_os_pallas: _conv_kernel), the paper's Listings 2 and 5.  Same
// function: an output tile's float32 accumulator stays on chip while the
// KH x KW taps, each an implicit GEMM over Cin, add into it.  The TPU
// kernel holds a whole image and an (OH * OW, 128) accumulator in VMEM
// (2 MB at 64 x 64 x 128); an SM has 228 KB of shared memory, so here
// OH x OW is tiled across blocks.
//
// Bound on the card.  At the paper's Table-I CONV problem run as a batched
// edge layer (N 32, 66 x 66 x 64 in, 3 x 3 taps, 64 out) the 9.66 GFLOP
// take 0.144 ms at the float32 rate; in bf16 the 34.7 MB moved (0.010 ms)
// and the operations at the tensor rate (0.0098 ms) are about even.  This
// first version does not use the tensor cores.  What the design does:
//   * A block owns a 16 x 16 patch of output pixels of one image and 64
//     output channels; each of its 256 threads keeps 8 pixels (one column
//     of the patch) x 8 channels of float32 accumulator in registers.
//   * Cin is walked in chunks of 8: the block stages the input patch with
//     its (KH - 1, KW - 1) halo, 8 channels deep, and all KH x KW taps'
//     weights for those 8 channels and its 64 outputs in shared memory as
//     float32, then every thread does 64 FMAs per (tap, channel) from one
//     float per pixel (shared by the 8 threads of a column) and two float4
//     of weights.
//   * Ragged edges are masked: input and weights past Cin or Cout, and
//     input past H or W, stage as zeros (which add nothing); pixels past
//     OH or OW and channels past Cout are not stored.  Cin = 1 (Listing 2)
//     and a Cout that is not a multiple of 64 need no padded copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int TH = 16, TW = 16;  // output pixels of a block
constexpr int BCO = 64;          // output channels of a block
constexpr int CC = 8;            // input channels staged per step
constexpr int PX = 8, PC = 8;    // pixels x channels of a thread
constexpr int kThreads = (TH * TW / PX) * (BCO / PC);  // 256
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// Shared memory of a launch with KH x KW taps, in bytes (the wrapper
// repeats this sum to refuse taps that need more than kMaxSmem).
int smem_bytes(int KH, int KW) {
  return ((TH + KH - 1) * (TW + KW - 1) * CC + KH * KW * CC * BCO) *
         static_cast<int>(sizeof(float));
}

// grid (tiles of the output plane, Cout tiles, N); kThreads threads.
// Dynamic shared memory: the patch (TH + KH - 1, TW + KW - 1, CC), then
// the weights (KH * KW, CC, BCO), float32.
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
    conv2d_os_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     TO* __restrict__ out, int H, int W, int Cin, int Cout,
                     int KH, int KW) {
  extern __shared__ __align__(16) float smem[];
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int PH = TH + KH - 1, PW = TW + KW - 1;
  float* patch = smem;
  float* ws = smem + PH * PW * CC;

  const int tiles_w = (OW + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * TH, ow0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BCO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  // Thread (tx, ty): channels tx * 4 + 0..3 and 32 + tx * 4 + 0..3; the
  // pixel column ty % 16, rows (ty / 16) * 8 + 0..7 of the patch.
  const int tx = tid % (BCO / PC), ty = tid / (BCO / PC);
  const int col = ty % TW, row0 = (ty / TW) * PX;

  const T* xn = x + static_cast<size_t>(n) * H * W * Cin;
  const int taps = KH * KW;

  float acc[PX][PC];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    __syncthreads();  // the previous chunk is consumed
    for (int idx = tid; idx < PH * PW * CC; idx += kThreads) {
      const int cc = idx % CC, pos = idx / CC;
      const int h = oh0 + pos / PW, ww = ow0 + pos % PW, ci = c0 + cc;
      patch[idx] = (h < H && ww < W && ci < Cin)
                       ? to_float(xn[(static_cast<size_t>(h) * W + ww) * Cin + ci])
                       : 0.f;
    }
    for (int idx = tid; idx < taps * CC * BCO; idx += kThreads) {
      const int co = idx % BCO, rest = idx / BCO;
      const int ci = c0 + rest % CC, tap = rest / CC;
      ws[idx] = (ci < Cin && co0 + co < Cout)
                    ? to_float(w[(static_cast<size_t>(tap) * Cin + ci) * Cout +
                                 co0 + co])
                    : 0.f;
    }
    __syncthreads();

    for (int kh = 0; kh < KH; ++kh) {
      for (int kw = 0; kw < KW; ++kw) {
        const float* xp = patch + ((row0 + kh) * PW + col + kw) * CC;
        const float* wp = ws + (kh * KW + kw) * CC * BCO;
#pragma unroll
        for (int ci = 0; ci < CC; ++ci) {
          float xv[PX], wv[PC];
#pragma unroll
          for (int i = 0; i < PX; ++i) xv[i] = xp[i * PW * CC + ci];
          const float4 w0 =
              *reinterpret_cast<const float4*>(wp + ci * BCO + tx * 4);
          const float4 w1 =
              *reinterpret_cast<const float4*>(wp + ci * BCO + BCO / 2 + tx * 4);
          wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
          wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
#pragma unroll
          for (int i = 0; i < PX; ++i)
#pragma unroll
            for (int j = 0; j < PC; ++j)
              acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
    }
  }

  const int ow = ow0 + col;
  if (ow >= OW) return;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int oh = oh0 + row0 + i;
    if (oh >= OH) continue;
    TO* op = out + ((static_cast<size_t>(n) * OH + oh) * OW + ow) * Cout;
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int co = co0 + (j < 4 ? tx * 4 + j : BCO / 2 + tx * 4 + j - 4);
      if (co < Cout) op[co] = from_float<TO>(acc[i][j]);
    }
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* w, void* out, int N, int H, int W,
           int Cin, int Cout, int KH, int KW, cudaStream_t stream) {
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int tiles = ((OH + TH - 1) / TH) * ((OW + TW - 1) / TW);
  const int smem = smem_bytes(KH, KW);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_os_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(tiles, (Cout + BCO - 1) / BCO, N);
  conv2d_os_kernel<T, TO><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<TO*>(out), H, W, Cin, Cout, KH, KW);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_out(int out_dtype, const void* x, const void* w, void* out,
                 int N, int H, int W, int Cin, int Cout, int KH, int KW,
                 cudaStream_t st) {
  if (out_dtype == 0)
    return launch<T, float>(x, w, out, N, H, W, Cin, Cout, KH, KW, st);
  if (out_dtype == 1)
    return launch<T, __nv_bfloat16>(x, w, out, N, H, W, Cin, Cout, KH, KW, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (N, H, W, Cin) and w (KH, KW, Cin, Cout) of one dtype, out (N, H - KH
// + 1, W - KW + 1, Cout) of out_dtype (0 float32, 1 bfloat16), all
// contiguous.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a dtype or shape the kernel does not take.
extern "C" int repro_conv2d_os(const void* x, const void* w, void* out, int N,
                               int H, int W, int Cin, int Cout, int KH,
                               int KW, int dtype, int out_dtype,
                               void* stream) {
  if (N <= 0 || N > 65535 || Cin <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 ||
      KH > H || KW > W || (Cout + BCO - 1) / BCO > 65535 ||
      smem_bytes(KH, KW) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_out<float>(out_dtype, x, w, out, N, H, W, Cin, Cout, KH,
                               KW, st);
  if (dtype == 1)
    return dispatch_out<__nv_bfloat16>(out_dtype, x, w, out, N, H, W, Cin,
                                       Cout, KH, KW, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
