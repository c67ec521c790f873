// Output-stationary direct convolution for Hopper (sm_90a): valid,
// stride 1, NHWC,
//     out[n, oh, ow, co] = sum_{kh, kw, ci} x[n, oh + kh, ow + kw, ci]
//                                            * w[kh, kw, ci, co]
// with x and w float32 or bfloat16 (one type), every sum in float32, out
// float32 or bfloat16.
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
// edge layer (N 32, 66 x 66 x 64 in, 3 x 3 taps, 64 out) float32 inputs
// move 69.4 MB (0.0207 ms at the HBM rate), more than the 9.66 GFLOP take
// at the card's fastest rate for float32 inputs, TF32's (0.0195 ms); the
// tf32x3 route below does three TF32 products of each, a design ceiling
// of 0.0586 ms.  In bf16 the 34.7 MB moved (0.010 ms) and the operations
// at the tensor rate (0.0098 ms) are about even.
//
// Four routes, chosen by the wrapper from the shape, the dtype and the
// pointers' alignment (kernels/conv2d_os/kernel.py: route), one C entry
// point each:
//
// repro_conv2d_os_tc, the tensor-core route: bfloat16 with Cin and Cout
// multiples of 8, 16-byte aligned pointers and taps whose two patch
// buffers fit in shared memory (all up to 10 x 10; not 1 x 32 or wider),
// an implicit GEMM on mma.sync.m16n8k16 (bf16 in, float32 accumulate).
//   * A block owns 16 x 16 output pixels of one image (the GEMM's M, 256)
//     and 64 output channels (N); each of its 8 warps holds 2 output rows
//     (two m16 fragments of 16 pixels) x 64 channels, 64 floats a thread.
//   * K runs over Cin chunks of 64 and, within a chunk, over the taps.
//     The chunk's input patch with its (KH - 1, KW - 1) halo is staged in
//     bf16 by 16-byte cp.async copies, Cin-contiguous as NHWC lays it
//     out, at 144 bytes a pixel (128 of data), so the 8 row addresses of
//     an ldmatrix fall on 8 distinct bank groups.
//   * A tap (kh, kw) is only a shift of each pixel's row address into the
//     patch: ldmatrix loads every tap's A fragments from the same staged
//     patch.  B fragments come from the tap's (ci, co) weights, staged
//     co-contiguous at 144 bytes a row, by ldmatrix.trans.
//   * Weights stream through 2 stages, one (tap, chunk) of 64 x 64 each,
//     and patches through 2 buffers, one per chunk in flight, so the
//     loads of the next step overlap the products of this one.  Shared
//     memory: 109 KB at 3 x 3 taps (two blocks an SM), 194 KB at 10 x 10.
//   * Input past H or W, Cin or Cout stages as zeros (cp.async with no
//     source bytes); pixels past OH or OW and channels past Cout are not
//     stored.
//
// repro_conv2d_os_tf32x3, the float32 tensor-core route: float32 with Cin
// and Cout multiples of 4, 16-byte aligned pointers and taps whose patch
// buffers fit in shared memory (all up to 10 x 10; not 1 x 25 or wider).
// One TF32 product breaks the 1e-4 float32 bar, so each operand is split
// into two TF32 numbers, x = hi + lo (hopper.cuh: split_tf32, to 2^-22
// relative), and each product is taken as x_lo w_hi + x_hi w_lo + x_hi
// w_hi: three TF32 products, the cross terms first.  An implicit GEMM on
// wgmma:
//   * A block owns 16 x 16 output pixels of one image (M, 4 x 64) and 64
//     output channels (N).  Each of its 4 warpgroups takes 4 output rows,
//     one m64n64 float32 accumulator (32 floats a thread).
//   * A is the input.  Each thread loads its wgmma A fragment (mma.m16n8k8's
//     layout: a warp's 16 rows are 16 pixels of one output row) from the
//     staged patch at the tap's shift, by 32-bit loads, and splits it in
//     registers; wgmma takes A from registers.  B, the weights, must be
//     K-major in shared memory for .tf32.  A split pass (one extra
//     launch) writes each (tap, chunk of 32 input channels, tile of 64
//     output channels) as a hi and a lo tile in wgmma's K-major layout
//     without swizzle (core matrices of 8 output x 4 input channels) into
//     scratch the wrapper allocates, so that a step's weights are one
//     contiguous 16 KB copy.
//   * Cin goes in chunks of 32.  A chunk's patch with its halo is staged
//     by 16-byte cp.async at 144 bytes a pixel (128 of data), so a warp's
//     A loads fall on 32 distinct banks.  2 patch buffers and 3 weight
//     stages: a chunk's patch is issued two steps before its first tap,
//     with that step's weights.  Shared memory 139 KB at 3 x 3 (one block
//     of 16 warps an SM), 224 KB at 10 x 10.
//   * Per step (a tap, 32 channels) the 12 wgmma m64n64k8 go into a zeroed
//     partial sum, which IEEE adds carry into the accumulator.  The tensor
//     cores' float32 accumulation truncates: summed straight into the
//     accumulator, the error against float64 grows with the taps and
//     channels summed, past the 8x of cuDNN's float32 error that the
//     route is held to (PERF.md).
//   * Each step ends in a barrier and a wait for its wgmma, so deeper
//     steps pay.
//   * An output that comes out infinite or NaN (a non-finite input, or a
//     float32 overflow) is recomputed in the epilogue by a plain float32
//     sum over its taps and channels, so that it is what the plain
//     version gives (∞ x w through the split adds ∞ w_hi and ∞ w_lo, NaN
//     where their signs differ).  Finite inputs never take that path.
//
// repro_conv2d_os, the SIMT route: float32 (IEEE FMAs, no TF32) and
// bfloat16 with Cin or Cout not a multiple of 4 or 8 (Listing 2's Cin =
// 1 among them), unaligned pointers, and taps too wide for the
// tensor-core routes.
//   * A block owns a 16 x 16 patch of output pixels of one image and 64
//     output channels; each of its 256 threads keeps 8 pixels (one column
//     of the patch) x 8 channels of float32 accumulator in registers.
//   * Cin is walked in chunks of 8: the block stages the input patch with
//     its halo, 8 channels deep, and all KH x KW taps' weights for those 8
//     channels and its 64 outputs in shared memory as float32, then every
//     thread does 64 FMAs per (tap, channel).
//   * Ragged edges are masked as on the other route.
//
// repro_conv2d_os_stream, the streaming route: taps whose SIMT block
// (the patch with its halo and all KH x KW taps' weights, for 8 channels)
// would not fit in a block's shared memory (11 x 11 and larger).  The
// SIMT kernel's thread layout and sum order (Cin chunk, kh, kw, ci), so
// its output is the SIMT route's bit for bit, but per (Cin chunk, tap
// row kh, group of KWG taps of that row) the block stages only the 16
// input rows that row needs, 16 + KWG - 1 columns wide, and the group's
// weights: 48,640 bytes whatever the taps.
//
// Every route takes any N: the batch is the grid's z axis, at most 65535,
// so a launch covers at most 65535 images and a larger batch is launched
// in slices of that many (one C call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "hopper.cuh"

namespace {

using repro::from_float;
using repro::store2;
using repro::to_float;

constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kMaxGridZ = 65535;  // images a launch covers (grid.z)

namespace simt {

constexpr int TH = 16, TW = 16;  // output pixels of a block
constexpr int BCO = 64;          // output channels of a block
constexpr int CC = 8;            // input channels staged per step
constexpr int PX = 8, PC = 8;    // pixels x channels of a thread
constexpr int kThreads = (TH * TW / PX) * (BCO / PC);  // 256

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
  for (int n0 = 0; n0 < N; n0 += kMaxGridZ) {
    const dim3 grid(tiles, (Cout + BCO - 1) / BCO, N - n0 < kMaxGridZ ? N - n0 : kMaxGridZ);
    conv2d_os_kernel<T, TO><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x) + static_cast<size_t>(n0) * H * W * Cin,
        static_cast<const T*>(w),
        static_cast<TO*>(out) + static_cast<size_t>(n0) * OH * OW * Cout, H,
        W, Cin, Cout, KH, KW);
  }
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

// The streaming route (see the note at the top): simt's tile, threads and
// sum order, the taps streamed through a fixed-size tile.
constexpr int KWG = 16;           // taps of one row staged together
constexpr int SPW = TW + KWG - 1; // columns of a staged patch row

int stream_smem_bytes() {
  return (TH * SPW * CC + KWG * CC * BCO) * static_cast<int>(sizeof(float));
}

// grid (tiles of the output plane, Cout tiles, images); kThreads threads.
// Dynamic shared memory: the patch (TH, SPW, CC), then the weights (KWG,
// CC, BCO), float32.
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
    conv2d_os_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            TO* __restrict__ out, int H, int W, int Cin,
                            int Cout, int KH, int KW) {
  extern __shared__ __align__(16) float smem[];
  const int OH = H - KH + 1, OW = W - KW + 1;
  float* patch = smem;
  float* ws = smem + TH * SPW * CC;

  const int tiles_w = (OW + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * TH, ow0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BCO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % (BCO / PC), ty = tid / (BCO / PC);
  const int col = ty % TW, row0 = (ty / TW) * PX;

  const T* xn = x + static_cast<size_t>(n) * H * W * Cin;

  float acc[PX][PC];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    for (int kh = 0; kh < KH; ++kh) {
      for (int kw0 = 0; kw0 < KW; kw0 += KWG) {
        const int nk = min(KWG, KW - kw0);
        __syncthreads();  // the previous group is consumed
        for (int idx = tid; idx < TH * SPW * CC; idx += kThreads) {
          const int cc = idx % CC, pos = idx / CC;
          const int h = oh0 + kh + pos / SPW, ww = ow0 + kw0 + pos % SPW;
          const int ci = c0 + cc;
          patch[idx] = (h < H && ww < W && ci < Cin)
                           ? to_float(xn[(static_cast<size_t>(h) * W + ww) * Cin + ci])
                           : 0.f;
        }
        for (int idx = tid; idx < nk * CC * BCO; idx += kThreads) {
          const int co = idx % BCO, rest = idx / BCO;
          const int ci = c0 + rest % CC, tap = kh * KW + kw0 + rest / CC;
          ws[idx] = (ci < Cin && co0 + co < Cout)
                        ? to_float(w[(static_cast<size_t>(tap) * Cin + ci) * Cout +
                                     co0 + co])
                        : 0.f;
        }
        __syncthreads();

        for (int j = 0; j < nk; ++j) {
          const float* xp = patch + (row0 * SPW + col + j) * CC;
          const float* wp = ws + j * CC * BCO;
#pragma unroll
          for (int ci = 0; ci < CC; ++ci) {
            float xv[PX], wv[PC];
#pragma unroll
            for (int i = 0; i < PX; ++i) xv[i] = xp[i * SPW * CC + ci];
            const float4 w0 =
                *reinterpret_cast<const float4*>(wp + ci * BCO + tx * 4);
            const float4 w1 =
                *reinterpret_cast<const float4*>(wp + ci * BCO + BCO / 2 + tx * 4);
            wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
            wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
#pragma unroll
            for (int i = 0; i < PX; ++i)
#pragma unroll
              for (int q = 0; q < PC; ++q)
                acc[i][q] = fmaf(xv[i], wv[q], acc[i][q]);
          }
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
int launch_stream(const void* x, const void* w, void* out, int N, int H,
                  int W, int Cin, int Cout, int KH, int KW,
                  cudaStream_t stream) {
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int tiles = ((OH + TH - 1) / TH) * ((OW + TW - 1) / TW);
  const int smem = stream_smem_bytes();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_os_stream_kernel<T, TO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int n0 = 0; n0 < N; n0 += kMaxGridZ) {
    const dim3 grid(tiles, (Cout + BCO - 1) / BCO, N - n0 < kMaxGridZ ? N - n0 : kMaxGridZ);
    conv2d_os_stream_kernel<T, TO><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x) + static_cast<size_t>(n0) * H * W * Cin,
        static_cast<const T*>(w),
        static_cast<TO*>(out) + static_cast<size_t>(n0) * OH * OW * Cout, H,
        W, Cin, Cout, KH, KW);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_stream(int out_dtype, const void* x, const void* w, void* out,
                    int N, int H, int W, int Cin, int Cout, int KH, int KW,
                    cudaStream_t st) {
  if (out_dtype == 0)
    return launch_stream<T, float>(x, w, out, N, H, W, Cin, Cout, KH, KW, st);
  if (out_dtype == 1)
    return launch_stream<T, __nv_bfloat16>(x, w, out, N, H, W, Cin, Cout, KH,
                                           KW, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TH = 16, TW = 16;     // output pixels of a block: M = 256
constexpr int BCO = 64;             // output channels of a block: N
constexpr int CC = 64;              // input channels of a step: K = 4 x 16
constexpr int PSTR = CC * 2 + 16;   // bytes a staged pixel: 144
constexpr int WSTR = BCO * 2 + 16;  // bytes a staged weight row (one ci): 144
constexpr int WBYTES = CC * WSTR;   // one (tap, chunk) of weights
constexpr int STAGES = 2;
constexpr int kThreads = 256;       // 8 warps of 2 output rows x 64 channels

// Shared memory of a launch with KH x KW taps, in bytes (the wrapper
// repeats this sum): STAGES patch buffers, then STAGES weight stages.
int smem_bytes(int KH, int KW) {
  return STAGES * ((TH + KH - 1) * (TW + KW - 1) * PSTR + WBYTES);
}

using repro::hopper::cp_async16;
using repro::hopper::cp_async_commit;
using repro::hopper::cp_async_wait;
using repro::hopper::ldmatrix_x4;
using repro::hopper::ldmatrix_x4_trans;
using repro::hopper::mma_bf16;

// grid (tiles of the output plane, Cout tiles, N); kThreads threads.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
    conv2d_os_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        TO* __restrict__ out, int H, int W, int Cin, int Cout,
                        int KH, int KW) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int PW = TW + KW - 1;
  const int patch_bytes = (TH + KH - 1) * PW * PSTR;
  const uint32_t patches = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t weights = patches + STAGES * patch_bytes;

  const int tiles_w = (OW + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * TH, ow0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BCO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* xn = x + static_cast<size_t>(n) * H * W * Cin;
  const int taps = KH * KW;
  const int steps = ((Cin + CC - 1) / CC) * taps;

  // Issues the copies of step s (chunk s / taps, tap s % taps): its
  // weights into stage s % STAGES and, at a chunk's first tap, the
  // chunk's patch into buffer chunk % STAGES.  Always commits a group, so
  // that the group count stays one a step.
  auto load = [&](int s) {
    if (s < steps) {
      const int chunk = s / taps, tap = s % taps, ci0 = chunk * CC;
      if (tap == 0) {
        const uint32_t pb = patches + (chunk % STAGES) * patch_bytes;
        const int groups = (TH + KH - 1) * PW * (CC / 8);
        for (int i = tid; i < groups; i += kThreads) {
          const int g = i % (CC / 8), pos = i / (CC / 8);
          const int h = oh0 + pos / PW, ww = ow0 + pos % PW, ci = ci0 + 8 * g;
          const bool in = h < H && ww < W && ci < Cin;  // Cin % 8 == 0
          cp_async16(pb + pos * PSTR + 16 * g,
                     in ? xn + (static_cast<size_t>(h) * W + ww) * Cin + ci : x,
                     in ? 16 : 0);
        }
      }
      const uint32_t wb = weights + (s % STAGES) * WBYTES;
      for (int i = tid; i < CC * (BCO / 8); i += kThreads) {
        const int g = i % (BCO / 8), r = i / (BCO / 8);
        const int ci = ci0 + r, co = co0 + 8 * g;
        const bool in = ci < Cin && co < Cout;  // Cout % 8 == 0
        cp_async16(wb + r * WSTR + 16 * g,
                   in ? w + (static_cast<size_t>(tap) * Cin + ci) * Cout + co
                      : w,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8.  For
  // A the matrices are (pixels 0-7 | 8-15) x (k 0-7 | 8-15), pixels
  // first; for B (k 0-7 | 8-15) x (co 0-7 | 8-15), k first.
  const int a_pix = lane % 8 + 8 * ((lane / 8) % 2), a_k = 8 * (lane / 16);
  const int b_k = lane % 8 + 8 * ((lane / 8) % 2), b_co = 8 * (lane / 16);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed; every warp is done with s - 1
    load(s + STAGES - 1);
    const int chunk = s / taps, tap = s % taps, kh = tap / KW, kw = tap % KW;
    const uint32_t pb = patches + (chunk % STAGES) * patch_bytes;
    const uint32_t wb = weights + (s % STAGES) * WBYTES;
#pragma unroll
    for (int k16 = 0; k16 < CC / 16; ++k16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], pb + ((warp * 2 + i + kh) * PW + a_pix + kw) * PSTR +
                              (k16 * 16 + a_k) * 2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wb + (k16 * 16 + b_k) * WSTR + (16 * jj + b_co) * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Fragment (i, j): rows are the pixels ow0 + lane / 4 (+ 8) of output
  // row oh0 + 2 warp + i, columns the channels co0 + 8 j + 2 (lane % 4)
  // and the next.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oh = oh0 + warp * 2 + i;
    if (oh >= OH) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ow = ow0 + lane / 4 + 8 * h;
      if (ow >= OW) continue;
      TO* op = out + ((static_cast<size_t>(n) * OH + oh) * OW + ow) * Cout;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + 8 * j + 2 * (lane % 4);
        if (co < Cout)  // Cout % 8 == 0, so co + 1 < Cout as well
          store2(op + co, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <typename TO>
int launch(const void* x, const void* w, void* out, int N, int H, int W,
           int Cin, int Cout, int KH, int KW, cudaStream_t stream) {
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int tiles = ((OH + TH - 1) / TH) * ((OW + TW - 1) / TW);
  const int smem = smem_bytes(KH, KW);
  const cudaError_t e = cudaFuncSetAttribute(
      conv2d_os_tc_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int n0 = 0; n0 < N; n0 += kMaxGridZ) {
    const dim3 grid(tiles, (Cout + BCO - 1) / BCO, N - n0 < kMaxGridZ ? N - n0 : kMaxGridZ);
    conv2d_os_tc_kernel<TO><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x) + static_cast<size_t>(n0) * H * W * Cin,
        static_cast<const bf16*>(w),
        static_cast<TO*>(out) + static_cast<size_t>(n0) * OH * OW * Cout, H,
        W, Cin, Cout, KH, KW);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

namespace tf32x3 {

constexpr int TH = 16, TW = 16;     // output pixels of a block: M = 4 x 64
constexpr int BCO = 64;             // output channels of a block: N
constexpr int CC = 32;              // input channels of a step: K = 4 x 8
constexpr int PSTR = CC + 4;        // floats a staged pixel: 36 (144 bytes)
constexpr int WTILE = CC * BCO;     // floats of a step's hi (or lo) weights
constexpr int WFLOATS = 2 * WTILE;  // a step's split weights: hi, then lo
constexpr int PATCHES = 2;          // patch buffers: chunks in flight
constexpr int WSTAGES = 3;          // weight stages: steps in flight
constexpr int kThreads = 512;       // 4 warpgroups of 4 rows x 64 channels
constexpr int kSplitThreads = 256;

// Shared memory of a launch with KH x KW taps, in bytes (the wrapper
// repeats this sum): PATCHES patch buffers, then WSTAGES weight stages.
int smem_bytes(int KH, int KW) {
  return (PATCHES * (TH + KH - 1) * (TW + KW - 1) * PSTR +
          WSTAGES * WFLOATS) *
         static_cast<int>(sizeof(float));
}

using repro::hopper::cp_async16;
using repro::hopper::cp_async_commit;
using repro::hopper::cp_async_wait;
using repro::hopper::fence_proxy_async;
using repro::hopper::fence_regs;
using repro::hopper::is_finite;
using repro::hopper::split_tf32;
using repro::hopper::wgmma_commit;
using repro::hopper::wgmma_fence;
using repro::hopper::wgmma_wait;

// wgmma shared-memory descriptor without swizzle (the interleaved
// canonical layout): core matrices of 8 rows x 16 bytes, K-adjacent ones
// lbo bytes apart, 8-row groups sbo bytes apart.
__device__ __forceinline__ uint64_t desc_noswizzle(uint32_t addr,
                                                   uint32_t lbo,
                                                   uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D[64 x 64] += A[64 x 8] @ B[8 x 64], TF32, A from registers (each warp
// of the warpgroup 16 rows, as mma.m16n8k8's A fragment), B K-major in
// shared memory; scale_d 0 writes D = A B.
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32],
                                                  const float* a,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(db),
        "r"(scale_d));
}

// Floats of the split weights of a call (the scratch the wrapper
// allocates): per (tap, chunk of CC input channels, tile of BCO output
// channels) a hi and a lo tile of CC x BCO, each laid out for wgmma as
// [CC / 4][BCO][4] (four input channels of one output channel are 16
// bytes; zeros past Cin and Cout).
long long split_weight_floats(int KH, int KW, int Cin, int Cout) {
  return static_cast<long long>(KH) * KW * ((Cin + CC - 1) / CC) *
         ((Cout + BCO - 1) / BCO) * WFLOATS;
}

// The weights' split pass: one thread a (hi, lo) pair of w2's layout.
__global__ void __launch_bounds__(kSplitThreads)
    split_weights_kernel(const float* __restrict__ w, float* __restrict__ w2,
                         int Cin, int Cout, int chunks, int ctiles,
                         long long pairs) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (i >= pairs) return;
  const int off = static_cast<int>(i % WTILE);  // (kk BCO + co) 4 + e
  const long long tile = i / WTILE;  // ((tap chunks + chunk) ctiles + ct)
  const int e = off % 4, co_l = (off / 4) % BCO, kk = off / (4 * BCO);
  const int ct = static_cast<int>(tile % ctiles);
  const int chunk = static_cast<int>((tile / ctiles) % chunks);
  const int tap = static_cast<int>(tile / ctiles / chunks);
  const int ci = chunk * CC + 4 * kk + e, co = ct * BCO + co_l;
  const float v = (ci < Cin && co < Cout)
                      ? w[(static_cast<size_t>(tap) * Cin + ci) * Cout + co]
                      : 0.f;
  float hi, lo;
  split_tf32(v, hi, lo);
  w2[tile * WFLOATS + off] = hi;
  w2[tile * WFLOATS + WTILE + off] = lo;
}

// out[n, oh, ow, co] by IEEE float32 FMAs over (kh, kw, ci) in order: the
// epilogue's value for an output whose split sum is not finite.
__device__ __noinline__ float conv_f32(const float* __restrict__ xn,
                                       const float* __restrict__ w, int oh,
                                       int ow, int co, int W, int Cin,
                                       int Cout, int KH, int KW) {
  float s = 0.f;
  for (int kh = 0; kh < KH; ++kh)
    for (int kw = 0; kw < KW; ++kw) {
      const float* xp = xn + (static_cast<size_t>(oh + kh) * W + ow + kw) * Cin;
      const float* wp =
          w + (static_cast<size_t>(kh * KW + kw) * Cin) * Cout + co;
      for (int ci = 0; ci < Cin; ++ci)
        s = fmaf(xp[ci], wp[static_cast<size_t>(ci) * Cout], s);
    }
  return s;
}

// grid (tiles of the output plane, Cout tiles, N); kThreads threads.  w2
// is the split pass's output; w the weights themselves, read only to
// recompute a non-finite output.
template <typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    conv2d_os_tf32x3_kernel(const float* __restrict__ x,
                            const float* __restrict__ w2,
                            const float* __restrict__ w, TO* __restrict__ out,
                            int H, int W, int Cin, int Cout, int KH, int KW) {
  extern __shared__ __align__(16) float smf[];
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int PW = TW + KW - 1;
  const int patch_floats = (TH + KH - 1) * PW * PSTR;
  const uint32_t patches = static_cast<uint32_t>(__cvta_generic_to_shared(smf));
  const uint32_t weights = patches + PATCHES * patch_floats * 4;

  const int tiles_w = (OW + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * TH, ow0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BCO;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* xn = x + static_cast<size_t>(n) * H * W * Cin;
  const int taps = KH * KW;
  const int chunks = (Cin + CC - 1) / CC;
  const int ctiles = (Cout + BCO - 1) / BCO;
  const int steps = chunks * taps;

  // Step s is (chunk s / taps, tap s % taps).  Its split weights (8 KB,
  // contiguous in w2) go to stage s % WSTAGES; a chunk's patch with its
  // halo to buffer chunk % PATCHES.  One cp.async group is committed per
  // step (the prologue's, then each loop step's), so a step's group is
  // done once all but the WSTAGES - 2 newest are.
  auto load_patch = [&](int chunk) {
    const uint32_t pb = patches + (chunk % PATCHES) * patch_floats * 4;
    const int ci0 = chunk * CC;
    const int groups = (TH + KH - 1) * PW * (CC / 4);
    for (int i = tid; i < groups; i += kThreads) {
      const int g = i % (CC / 4), pos = i / (CC / 4);
      const int h = oh0 + pos / PW, ww = ow0 + pos % PW, ci = ci0 + 4 * g;
      const bool in = h < H && ww < W && ci < Cin;  // Cin % 4 == 0
      cp_async16(pb + (pos * PSTR + 4 * g) * 4,
                 in ? xn + (static_cast<size_t>(h) * W + ww) * Cin + ci : x,
                 in ? 16 : 0);
    }
  };
  auto load_weights = [&](int s) {
    const float* src =
        w2 + (static_cast<size_t>((s % taps) * chunks + s / taps) * ctiles +
              blockIdx.y) * WFLOATS;
    const uint32_t dst = weights + (s % WSTAGES) * WFLOATS * 4;
    for (int i = tid; i < WFLOATS / 4; i += kThreads)
      cp_async16(dst + 16 * i, src + 4 * i, 16);
  };
  // The step at which chunk c + 1's patch is issued: WSTAGES - 1 steps
  // before its first, so that it lands with that step's weights; but not
  // before chunk c's first step, when its buffer is freed.  With one tap
  // that is one step before: the step waits for it (wait_group 0).
  auto patch_step = [&](int c) {
    return max(c * taps, (c + 1) * taps - (WSTAGES - 1));
  };

  // Warpgroup wg computes output rows 4 wg .. 4 wg + 3 of the tile (its
  // m64: 16 pixels a warp), all BCO channels.  In the A fragment g = lane
  // / 4 picks the pixel (rows g, g + 8 of the warp's 16), t = lane % 4
  // the input channel (k t, t + 4).
  const int row = warp;  // 4 (warp / 4) + warp % 4
  const int g = lane / 4, t = lane % 4;
  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;

  load_patch(0);
#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < steps) load_weights(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int chunk = s / taps, tap = s % taps, kh = tap / KW, kw = tap % KW;
    if (chunk > 0 && tap == 0 && patch_step(chunk - 1) + WSTAGES - 1 > s)
      cp_async_wait<0>();
    else
      cp_async_wait<WSTAGES - 2>();
    fence_proxy_async();  // the weights, for wgmma's reads
    __syncthreads();  // step s has landed; every warp is done with s - 1
    if (s + WSTAGES - 1 < steps) load_weights(s + WSTAGES - 1);
    if (chunk + 1 < chunks && s == patch_step(chunk)) load_patch(chunk + 1);
    cp_async_commit();
    const float* pb = smf + (chunk % PATCHES) * patch_floats;
    const uint32_t wb = weights + (s % WSTAGES) * WFLOATS * 4;
    float ahi[CC / 2], alo[CC / 2];  // [k8][4]
#pragma unroll
    for (int j = 0; j < CC / 8; ++j) {
      const float* ap = pb + ((row + kh) * PW + g + kw) * PSTR + j * 8 + t;
      split_tf32(ap[0], ahi[4 * j], alo[4 * j]);
      split_tf32(ap[8 * PSTR], ahi[4 * j + 1], alo[4 * j + 1]);
      split_tf32(ap[4], ahi[4 * j + 2], alo[4 * j + 2]);
      split_tf32(ap[8 * PSTR + 4], ahi[4 * j + 3], alo[4 * j + 3]);
    }
    // The step's three products into a zeroed partial sum, then IEEE adds
    // into the accumulator (see the note at the top).  In a weight tile
    // the core matrices of 4 input channels are 64 x 16 bytes apart (lbo),
    // those of 8 output channels 128 bytes (sbo).
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < CC / 8; ++j) {
      const uint64_t bh = desc_noswizzle(wb + j * 2048, 1024, 128);
      const uint64_t bl = desc_noswizzle(wb + WTILE * 4 + j * 2048, 1024, 128);
      wgmma_m64n64k8_rs(part, alo + 4 * j, bh, j);
      wgmma_m64n64k8_rs(part, ahi + 4 * j, bl, 1);
      wgmma_m64n64k8_rs(part, ahi + 4 * j, bh, 1);
    }
    wgmma_commit();
    fence_regs(part);
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(ahi);  // the A registers stay live until the wgmma read them
    fence_regs(alo);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // Register 4 j + 2 h + e holds pixel ow0 + g + 8 h of output row oh0 +
  // row, channel co0 + 8 j + 2 t + e.
  const int oh = oh0 + row;
  if (oh >= OH) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ow = ow0 + g + 8 * h;
    if (ow >= OW) continue;
    TO* op = out + ((static_cast<size_t>(n) * OH + oh) * OW + ow) * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + 8 * j + 2 * t;
      if (co >= Cout) continue;  // Cout % 4 == 0, so co + 1 < Cout as well
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (!is_finite(v0))
        v0 = conv_f32(xn, w, oh, ow, co, W, Cin, Cout, KH, KW);
      if (!is_finite(v1))
        v1 = conv_f32(xn, w, oh, ow, co + 1, W, Cin, Cout, KH, KW);
      store2(op + co, v0, v1);
    }
  }
}

template <typename TO>
int launch(const float* x, const float* w, void* out, float* scratch, int N,
           int H, int W, int Cin, int Cout, int KH, int KW,
           cudaStream_t stream) {
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int tiles = ((OH + TH - 1) / TH) * ((OW + TW - 1) / TW);
  const int smem = smem_bytes(KH, KW);
  const int chunks = (Cin + CC - 1) / CC, ctiles = (Cout + BCO - 1) / BCO;
  const long long pairs = split_weight_floats(KH, KW, Cin, Cout) / 2;
  if ((pairs + kSplitThreads - 1) / kSplitThreads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      conv2d_os_tf32x3_kernel<TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  split_weights_kernel<<<static_cast<int>((pairs + kSplitThreads - 1) /
                                          kSplitThreads),
                         kSplitThreads, 0, stream>>>(w, scratch, Cin, Cout,
                                                     chunks, ctiles, pairs);
  for (int n0 = 0; n0 < N; n0 += kMaxGridZ) {
    const dim3 grid(tiles, ctiles, N - n0 < kMaxGridZ ? N - n0 : kMaxGridZ);
    conv2d_os_tf32x3_kernel<TO><<<grid, kThreads, smem, stream>>>(
        x + static_cast<size_t>(n0) * H * W * Cin, scratch, w,
        static_cast<TO*>(out) + static_cast<size_t>(n0) * OH * OW * Cout, H,
        W, Cin, Cout, KH, KW);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32x3

bool bad_shape(int N, int H, int W, int Cin, int Cout, int KH, int KW,
               int bco) {
  return N <= 0 || Cin <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 ||
         KH > H || KW > W || (Cout + bco - 1) / bco > 65535;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The SIMT route.  x (N, H, W, Cin) and w (KH, KW, Cin, Cout) of one
// dtype (0 float32, 1 bfloat16), out (N, H - KH + 1, W - KW + 1, Cout) of
// out_dtype (the same codes), all contiguous.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a dtype or shape the
// kernel does not take.
extern "C" int repro_conv2d_os(const void* x, const void* w, void* out, int N,
                               int H, int W, int Cin, int Cout, int KH,
                               int KW, int dtype, int out_dtype,
                               void* stream) {
  if (bad_shape(N, H, W, Cin, Cout, KH, KW, simt::BCO) ||
      simt::smem_bytes(KH, KW) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch_out<float>(out_dtype, x, w, out, N, H, W, Cin, Cout,
                                     KH, KW, st);
  if (dtype == 1)
    return simt::dispatch_out<__nv_bfloat16>(out_dtype, x, w, out, N, H, W,
                                             Cin, Cout, KH, KW, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The streaming route: as repro_conv2d_os, for any taps (the wrapper
// sends it the taps whose SIMT block would not fit in shared memory).
extern "C" int repro_conv2d_os_stream(const void* x, const void* w,
                                      void* out, int N, int H, int W,
                                      int Cin, int Cout, int KH, int KW,
                                      int dtype, int out_dtype,
                                      void* stream) {
  if (bad_shape(N, H, W, Cin, Cout, KH, KW, simt::BCO))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch_stream<float>(out_dtype, x, w, out, N, H, W, Cin,
                                        Cout, KH, KW, st);
  if (dtype == 1)
    return simt::dispatch_stream<__nv_bfloat16>(out_dtype, x, w, out, N, H,
                                                W, Cin, Cout, KH, KW, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route: as repro_conv2d_os with x and w bfloat16, Cin and
// Cout multiples of 8, and x, w and out 16-byte aligned.  Returns
// cudaErrorInvalidValue for anything else.
extern "C" int repro_conv2d_os_tc(const void* x, const void* w, void* out,
                                  int N, int H, int W, int Cin, int Cout,
                                  int KH, int KW, int out_dtype,
                                  void* stream) {
  if (bad_shape(N, H, W, Cin, Cout, KH, KW, tc::BCO) || Cin % 8 != 0 ||
      Cout % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(out) ||
      tc::smem_bytes(KH, KW) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return tc::launch<float>(x, w, out, N, H, W, Cin, Cout, KH, KW, st);
  if (out_dtype == 1)
    return tc::launch<__nv_bfloat16>(x, w, out, N, H, W, Cin, Cout, KH, KW,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 tensor-core route: as repro_conv2d_os with x and w float32,
// Cin and Cout multiples of 4, x, w, out and scratch 16-byte aligned, taps
// whose patch buffers fit in shared memory, and scratch_floats, the
// floats at scratch, at least tf32x3::split_weight_floats: 4096 KH KW
// ceil(Cin / 32) ceil(Cout / 64).  Two launches on the stream: the
// weights' split pass, then the convolution.  Returns
// cudaErrorInvalidValue for anything else.
extern "C" int repro_conv2d_os_tf32x3(const void* x, const void* w,
                                      void* out, void* scratch,
                                      long long scratch_floats, int N, int H,
                                      int W, int Cin, int Cout, int KH,
                                      int KW, int out_dtype, void* stream) {
  if (bad_shape(N, H, W, Cin, Cout, KH, KW, tf32x3::BCO) || Cin % 4 != 0 ||
      Cout % 4 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(out) ||
      !aligned16(scratch) || tf32x3::smem_bytes(KH, KW) > kMaxSmem ||
      scratch_floats < tf32x3::split_weight_floats(KH, KW, Cin, Cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* sf = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return tf32x3::launch<float>(xf, wf, out, sf, N, H, W, Cin, Cout, KH, KW,
                                 st);
  if (out_dtype == 1)
    return tf32x3::launch<__nv_bfloat16>(xf, wf, out, sf, N, H, W, Cin, Cout,
                                         KH, KW, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
