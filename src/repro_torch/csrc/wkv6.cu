// RWKV6 ("Finch") WKV recurrence with data-dependent decay, for Hopper
// (sm_90a).  Per (batch b, head h), with a D x D float32 state S:
//     o_t = r_t (S + diag(u) k_t^T v_t)
//     S  <- diag(w_t) S + k_t^T v_t
// from state0 (zeros when null) over T steps; the final state is written
// to state_out.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py (_make_kernel,
// launched by wkv6_pallas).  Same function: every step in float32, the
// output rounded once to r's dtype, the state float32.
//
// Bound on the card.  At decode (T = 1, B = 8) memory: the state, 4 D^2
// bytes per (b, h), is read and written once, and the step does 7 D^2
// flops on it.  At prefill (B = 1, T in the hundreds) the 7 D^2 flops per
// (b, h, t) at the float32 rate bound it, but only B * H * D columns of
// work exist, each a chain of T dependent steps.  What the design does
// about it:
//   * Columns of S are independent: column e updates from w, k and v_e
//     alone, and o_e needs only that column.  One thread owns S[:, e] in
//     D registers for the whole call, so the state is read once and
//     written once, in coalesced rows (neighbouring threads hold
//     neighbouring columns), and never touches memory in between.
//   * The e axis is split across blocks of kCols columns, so a batch-1
//     prefill runs on (D / kCols) * H blocks instead of H.
//   * A block stages a chunk of CT time steps of r, k and w (all D of them)
//     and of its own v columns in shared memory, converted to float32 with
//     16-byte loads; every thread then reads the same r/k/w row (a
//     broadcast) as float4 while it walks the chunk's steps in order.
//   * The dot product over d keeps four accumulators, so the chain of D
//     dependent adds does not set the step time.
//   * Inputs are read in the model's (B, T, H, D) layout, with no
//     transpose.  T needs no divisor: the last chunk is cut short.
// state_out may alias state0: each thread reads its column before any
// write, and no other thread reads it.
// Tensor cores are not used: the recurrence is a rank-1 update per step,
// and the chunked matrix form divides by cumulative decays (see the TPU
// kernel's note).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // columns of S a block owns, one thread each

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

// One d of one step for one column: as the reference, o += r (s + u kv)
// with kv = k v_e, then s <- w s + kv.
__device__ __forceinline__ float step(float& s, float r, float k, float w,
                                      float u, float ve, float acc) {
  const float kv = k * ve;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
  return acc;
}

// grid (D / EC, H, B), EC threads.  Thread j of block (c, h, b) owns
// column e = c * EC + j of the state of (b, h).
template <typename T, int D>
__global__ void __launch_bounds__(D < kCols ? D : kCols)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* state0,
                T* __restrict__ out, float* state_out, int T_len, int H) {
  constexpr int EC = D < kCols ? D : kCols;
  constexpr int CT = 2048 / D;          // time steps staged per chunk
  constexpr int VEC = Vec<T>::N;
  constexpr int RV = D / VEC;           // vectors in a row of r, k, w
  constexpr int CV = EC / VEC;          // vectors in the block's v columns
  static_assert(D % 4 == 0 && RV >= 1 && CV >= 1, "bad D");

  __shared__ __align__(16) float sr[CT * D];
  __shared__ __align__(16) float sk[CT * D];
  __shared__ __align__(16) float sw[CT * D];
  __shared__ __align__(16) float su[D];
  __shared__ float sv[CT * EC];

  const int h = blockIdx.y, b = blockIdx.z;
  const int e0 = blockIdx.x * EC;
  const int e = e0 + threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row = static_cast<size_t>(H) * D;  // stride of t
  const size_t base = static_cast<size_t>(b) * T_len * row + h * D;

  for (int i = threadIdx.x; i < D; i += EC) su[i] = u[h * D + i];

  float S[D];
  const size_t s_col = bh * D * D + e;
#pragma unroll
  for (int d = 0; d < D; ++d)
    S[d] = state0 ? state0[s_col + static_cast<size_t>(d) * D] : 0.f;

  for (int t0 = 0; t0 < T_len; t0 += CT) {
    const int n = min(CT, T_len - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * RV; i += EC) {
      const int tt = i / RV, c = (i % RV) * VEC;
      const size_t off = base + static_cast<size_t>(t0 + tt) * row + c;
      Vec<T>::load(r + off, sr + tt * D + c);
      Vec<T>::load(k + off, sk + tt * D + c);
      Vec<T>::load(w + off, sw + tt * D + c);
    }
    for (int i = threadIdx.x; i < n * CV; i += EC) {
      const int tt = i / CV, c = (i % CV) * VEC;
      Vec<T>::load(v + base + static_cast<size_t>(t0 + tt) * row + e0 + c,
                   sv + tt * EC + c);
    }
    __syncthreads();

    const float4* u4 = reinterpret_cast<const float4*>(su);
    for (int tt = 0; tt < n; ++tt) {
      const float ve = sv[tt * EC + threadIdx.x];
      const float4* r4 = reinterpret_cast<const float4*>(sr + tt * D);
      const float4* k4 = reinterpret_cast<const float4*>(sk + tt * D);
      const float4* w4 = reinterpret_cast<const float4*>(sw + tt * D);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q], uu = u4[q];
        a0 = step(S[4 * q], rr.x, kk.x, ww.x, uu.x, ve, a0);
        a1 = step(S[4 * q + 1], rr.y, kk.y, ww.y, uu.y, ve, a1);
        a2 = step(S[4 * q + 2], rr.z, kk.z, ww.z, uu.z, ve, a2);
        a3 = step(S[4 * q + 3], rr.w, kk.w, ww.w, uu.w, ve, a3);
      }
      out[base + static_cast<size_t>(t0 + tt) * row + e] =
          Vec<T>::store((a0 + a1) + (a2 + a3));
    }
  }

#pragma unroll
  for (int d = 0; d < D; ++d)
    state_out[s_col + static_cast<size_t>(d) * D] = S[d];
}

template <typename T, int D>
void launch(const void* r, const void* k, const void* v, const void* w,
            const float* u, const float* s0, void* out, float* s_out, int B,
            int T_len, int H, cudaStream_t stream) {
  constexpr int EC = D < kCols ? D : kCols;
  wkv6_kernel<T, D><<<dim3(D / EC, H, B), EC, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(out), s_out, T_len, H);
}

template <typename T>
bool dispatch_d(int D, const void* r, const void* k, const void* v,
                const void* w, const float* u, const float* s0, void* out,
                float* s_out, int B, int T_len, int H, cudaStream_t st) {
  switch (D) {
    case 16: launch<T, 16>(r, k, v, w, u, s0, out, s_out, B, T_len, H, st); return true;
    case 32: launch<T, 32>(r, k, v, w, u, s0, out, s_out, B, T_len, H, st); return true;
    case 64: launch<T, 64>(r, k, v, w, u, s0, out, s_out, B, T_len, H, st); return true;
    case 128: launch<T, 128>(r, k, v, w, u, s0, out, s_out, B, T_len, H, st); return true;
  }
  return false;
}

}  // namespace

// r/k/v/w/out (B, T, H, D) contiguous, of one dtype (0 float32, 1
// bfloat16); u (H, D) float32; state0 (B, H, D, D) float32 or null for
// zeros; state_out (B, H, D, D) float32.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a dtype or D the kernel is not
// built for.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* state0,
                          void* out, void* state_out, int B, int T_len, int H,
                          int D, int dtype, void* stream) {
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_d<float>(D, r, k, v, w, uf, s0, out, so, B, T_len, H, st);
  else if (dtype == 1)
    ok = dispatch_d<__nv_bfloat16>(D, r, k, v, w, uf, s0, out, so, B, T_len, H, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
