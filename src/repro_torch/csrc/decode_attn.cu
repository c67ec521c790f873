// GQA flash-decode attention for Hopper (sm_90a): one new token per batch
// row against a KV cache of S positions, of which the first lengths[b]
// are valid.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/kernel.py
// (_decode_kernel, launched by decode_attn_pallas).  Same function:
// scale 1/sqrt(D), positions >= length masked out, online softmax in
// float32, denominator clamped at 1e-30, output in q's dtype.
//
// Bound on the card: memory.  The K and V rows a call must read are
// sum_b 2 * Hkv * len_b * D * sizeof(T) bytes, read once; the arithmetic
// is 4 * G flops per cached element, far below the H100's ~295 flops/byte
// ridge.  What the design does about it:
//   * K/V rows stream from global memory once, each thread pulling one
//     16-byte vector per row; the positions of a warp are adjacent, so
//     every load is a full, coalesced 128-byte line.  Rows at or past
//     len_b are never read.
//   * The G query heads that share one KV head (G = H / Hkv) are served
//     by the same pass over K/V, so K/V are read once per KV head, not
//     once per query head.
//   * At decode shapes B * Hkv is a few dozen blocks against 132 SMs, so
//     the S axis is split across blocks (the TPU ran it as a sequential
//     grid axis).  Each split writes a partial (max, denominator, sum);
//     a second small kernel merges them.
//   * Each thread group keeps kKeys rows in flight per step and rescales
//     its running sums once per step rather than once per row.
// Tensor cores are not used: at G <= 8 query rows a tile would be mostly
// empty, and the kernel waits on memory either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads of a split block
constexpr int kKeys = 4;       // rows each thread group holds in flight
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// One 16-byte vector of T, widened to float.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

// grid (splits, Hkv, B).  Block (split, h, b) covers cache positions
// [split * chunk, min((split + 1) * chunk, len_b)).  Threads form groups of
// TPK = D / VEC; a group reads one row with one vector load per thread.
// Scores are kept in base 2 (q is pre-scaled by scale * log2(e)).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int Hkv, int S,
                        int chunk, float scale_log2) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPK = D / VEC;
  constexpr int NG = kThreads / TPK;
  static_assert(D % VEC == 0 && TPK <= 32 && 32 % TPK == 0, "bad D");

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int start = split * chunk;
  if (start >= len) return;  // the merge reads only splits that hold rows
  const int end = min(start + chunk, len);

  const int grp = threadIdx.x / TPK;
  const int lane = threadIdx.x % TPK;
  const int d0 = lane * VEC;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  const T* kb = k + bh * S * D + d0;
  const T* vb = v + bh * S * D + d0;

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Vec<T>::load(q + (bh * G + g) * D + d0, qr[g]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qr[g][i] *= scale_log2;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // The loop bound is the same for every thread of the block, so the
  // shuffles below always run with the full warp.
  for (int it = start; it < end; it += NG * kKeys) {
    const int base = it + grp * kKeys;
    float kr[kKeys][VEC], vr[kKeys][VEC];
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      if (base + c < end) {
        Vec<T>::load(kb + static_cast<size_t>(base + c) * D, kr[c]);
        Vec<T>::load(vb + static_cast<size_t>(base + c) * D, vr[c]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kr[c][i] = vr[c][i] = 0.f;
      }
    }
    float s[kKeys][G];
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qr[g][i], kr[c][i], dot);
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[c][g] = dot;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        if (base + c < end) mx = fmaxf(mx, s[c][g]);
      const float corr = exp2f(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = base + c < end ? exp2f(s[c][g] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vr[c][i], acc[g][i]);
      }
      m[g] = mx;
    }
  }

  // Merge the NG groups of the block through shared memory.
  __shared__ float sm_m[NG][G];
  __shared__ float sm_l[NG][G];
  __shared__ float sm_acc[NG][G][D];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = kNeg;
    for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j][g]);
    const float sc = exp2f(m[g] - mx);
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[grp][g][d0 + i] = acc[g][i] * sc;
  }
  __syncthreads();
  const size_t part = bh * gridDim.x + split;
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float sum = 0.f;
    for (int j = 0; j < NG; ++j) sum += sm_acc[j][g][d];
    part_acc[(part * G + g) * D + d] = sum;
  }
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNeg;
    for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j][g]);
    float tot = 0.f;
    for (int j = 0; j < NG; ++j) tot += sm_l[j][g] * exp2f(sm_m[j][g] - mx);
    part_m[part * G + g] = mx;
    part_l[part * G + g] = tot;
  }
}

// grid (B * Hkv).  Merges the splits that hold rows; a row with length 0
// has none and gets zeros.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int Hkv, int G, int D,
                                    int S, int splits, int chunk) {
  const int bh = blockIdx.x;
  const int len = min(max(lengths[bh / Hkv], 0), S);
  const int used = min(splits, (len + chunk - 1) / chunk);
  const size_t part0 = static_cast<size_t>(bh) * splits;
  for (int t = threadIdx.x; t < G * D; t += blockDim.x) {
    const int g = t / D, d = t % D;
    float mx = kNeg;
    for (int s = 0; s < used; ++s) mx = fmaxf(mx, part_m[(part0 + s) * G + g]);
    float tot = 0.f, o = 0.f;
    for (int s = 0; s < used; ++s) {
      const size_t p = (part0 + s) * G + g;
      const float w = exp2f(part_m[p] - mx);
      tot += part_l[p] * w;
      o += part_acc[p * D + d] * w;
    }
    out[(static_cast<size_t>(bh) * G + g) * D + d] =
        Vec<T>::store(o / fmaxf(tot, 1e-30f));
  }
}

template <typename T, int D, int G>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, float* part_m, float* part_l, float* part_acc, int B,
            int Hkv, int S, int splits, int chunk, float scale,
            cudaStream_t stream) {
  decode_split_kernel<T, D, G><<<dim3(splits, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_m, part_l, part_acc, Hkv, S,
      chunk, scale * kLog2e);
  const int threads = G * D < 256 ? G * D : 256;
  decode_merge_kernel<T><<<B * Hkv, threads, 0, stream>>>(
      part_m, part_l, part_acc, lengths, static_cast<T*>(out), Hkv, G, D, S,
      splits, chunk);
}

template <typename T, int D>
bool dispatch_g(int G, const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* pm, float* pl,
                float* pa, int B, int Hkv, int S, int splits, int chunk,
                float scale, cudaStream_t st) {
  switch (G) {
    case 1: launch<T, D, 1>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st); return true;
    case 2: launch<T, D, 2>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st); return true;
    case 4: launch<T, D, 4>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st); return true;
    case 8: launch<T, D, 8>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st); return true;
  }
  return false;
}

template <typename T>
bool dispatch_d(int D, int G, const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* pm, float* pl,
                float* pa, int B, int Hkv, int S, int splits, int chunk,
                float scale, cudaStream_t st) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
    case 32: return dispatch_g<T, 32>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
    case 64: return dispatch_g<T, 64>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
  }
  return false;
}

}  // namespace

// q (B, Hkv, G, D), k/v (B, Hkv, S, D), out (B, Hkv, G, D): contiguous, of
// one dtype (0 float32, 1 bfloat16).  lengths (B,) int32.  Partials:
// part_m/part_l (B, Hkv, splits, G), part_acc (B, Hkv, splits, G, D) float32.
// Returns cudaGetLastError() after both launches, or cudaErrorInvalidValue
// for a dtype, D or G the kernel is not built for.
extern "C" int repro_decode_attn(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, void* part_m,
                                 void* part_l, void* part_acc, int B, int Hkv,
                                 int G, int S, int D, int splits, int chunk,
                                 float scale, int dtype, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_d<float>(D, G, q, k, v, len, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
  else if (dtype == 1)
    ok = dispatch_d<__nv_bfloat16>(D, G, q, k, v, len, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
