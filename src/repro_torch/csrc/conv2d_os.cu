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
// edge layer (N 32, 66 x 66 x 64 in, 3 x 3 taps, 64 out) the 9.66 GFLOP
// take 0.144 ms at the float32 rate; in bf16 the 34.7 MB moved (0.010 ms)
// and the operations at the tensor rate (0.0098 ms) are about even.
//
// Two routes, chosen by the wrapper from the shape, the dtype and the
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
// repro_conv2d_os, the SIMT route: float32 (IEEE FMAs, no TF32), the
// bfloat16 shapes with Cin or Cout not a multiple of 8 (Listing 2's
// Cin = 1 among them), and bfloat16 taps too wide for the other route.
//   * A block owns a 16 x 16 patch of output pixels of one image and 64
//     output channels; each of its 256 threads keeps 8 pixels (one column
//     of the patch) x 8 channels of float32 accumulator in registers.
//   * Cin is walked in chunks of 8: the block stages the input patch with
//     its halo, 8 channels deep, and all KH x KW taps' weights for those 8
//     channels and its 64 outputs in shared memory as float32, then every
//     thread does 64 FMAs per (tap, channel).
//   * Ragged edges are masked as on the other route.

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
  const dim3 grid(tiles, (Cout + BCO - 1) / BCO, N);
  conv2d_os_tc_kernel<TO><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<TO*>(out), H, W, Cin, Cout, KH, KW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool bad_shape(int N, int H, int W, int Cin, int Cout, int KH, int KW,
               int bco) {
  return N <= 0 || N > 65535 || Cin <= 0 || Cout <= 0 || KH <= 0 || KW <= 0 ||
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
