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
// bytes per (b, h), is read and written once, and the step needs 5 D^2
// flops on it (r . S is 2 D^2, diag(w) S + k^T v 3 D^2; the u term,
// (sum_d r_d u_d k_d) v_e, is O(D)).  At prefill (B = 1, T in the
// hundreds) those 5 D^2 flops per (b, h, t) at the float32 rate bound
// it, but only B * H * D columns of work exist, each a chain of T
// dependent steps.  What the design does about it:
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
// and float32 products are needed (TF32 breaks the 1e-4 tolerance).
//
// Two routes, chosen by the wrapper from the shape (kernels/wkv6/kernel.py:
// route), one C entry each:
//
// repro_wkv6, the step route: the kernel above, one chain of T steps per
// column.  It serves decode (T = 1) and short prompts.
//
// repro_wkv6_chunked, the chunked route, for prefill: a batch-1 prompt has
// only (D / kCols) * H one-warp chains of T steps, too few to fill the
// card, so T is cut into chunks of ct steps that run in parallel.  The
// transition over a chunk is diagonal, diag(W_c) with W_c = prod w over
// the chunk, so the state carried into chunk c + 1 is
//     S_{c+1} = diag(W_c) S_c + L_c,
// L_c being the chunk's end state from a zero start.  Three launches:
//   1. wkv6_local_kernel, grid (B * chunks, H): the recurrence above over
//      one chunk, chunk 0 from state0 (its outputs final, written to out),
//      every other from zeros (outputs to the float32 scratch `local`, so
//      a bf16 output is still rounded once); each chunk writes L_c, W_c.
//   2. wkv6_scan_kernel, one thread per (b, h, d, e): S_{c+1} from S_c in
//      float32, written over L_c, so slot c then holds the entry state of
//      chunk c + 1; the last is state_out.
//   3. wkv6_correct_kernel, grid (B * (chunks - 1), H): out_t = local_t +
//      (r_t * p_t) . S_c for chunks c >= 1, where p_t is the product of
//      the chunk's decays before step t (recomputed from w), then rounded
//      once to r's dtype.
// A one-column thread, as in wkv6_kernel, reads 12 bytes of r, k and w
// from shared memory for each (d, column, step), and shared memory's
// bandwidth, not the float32 rate, then bounds the chunked kernels: a
// thread of 1 and 3 holds 4 columns, so each value read serves 4.
// Only products of decays in (0, 1) occur: nothing is divided, so this is
// not the chunked matrix form the TPU kernel's note rules out (it divides
// by cumulative decays).  The extra work, (ct x D) . (D x D) per chunk and
// an elementwise pass over the states, is the design's cost.

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
  // The 16 bytes of x, widened to float, to out (16-byte aligned).
  __device__ static void widen(uint4 x, float* out) {
    *reinterpret_cast<uint4*>(out) = x;
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
  __device__ static void widen(uint4 x, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
    reinterpret_cast<float4*>(out)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

// One block's share of CT consecutive time steps of a (B, T, H, D) input,
// W values of each step from a given offset, held in registers as raw
// 16-byte vectors: thread x takes vectors x, x + NT, ... of the CT * W / VEC.
// fetch issues all of a thread's loads at once (they are in flight while
// the block computes on the previous steps); put widens them to float32
// in shared memory, CT rows of W.
template <typename T, int W, int CT, int NT>
struct Rows {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int RV = W / VEC;                    // vectors a step
  static constexpr int PER = (CT * RV + NT - 1) / NT;  // vectors a thread
  uint4 x[PER];

  // p points at step 0's first value; row is the stride of t; n <= CT.
  __device__ void fetch(const T* p, size_t row, int n) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int i = threadIdx.x + m * NT;
      if (i < n * RV)
        x[m] = __ldg(reinterpret_cast<const uint4*>(
            p + static_cast<size_t>(i / RV) * row + (i % RV) * VEC));
    }
  }
  __device__ void put(float* s, int n) const {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int i = threadIdx.x + m * NT;
      if (i < n * RV) Vec<T>::widen(x[m], s + (i / RV) * W + (i % RV) * VEC);
    }
  }
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

// The chunked route's thread layout at head size D.  A block runs all D
// columns of one (b, h, chunk).  Thread x holds kCPT neighbouring columns
// e0 = kCPT * (x / split(D)) .. e0 + kCPT - 1 and kDP of their d: the
// float4 groups q with q % split(D) == x % split(D), its part.  So each
// r, k and w value a thread reads from shared memory serves kCPT columns
// (shared-memory bandwidth, not arithmetic, bounds a one-column thread),
// and the parts of a column sit on neighbouring lanes, which sum their
// partial outputs by shuffles.
constexpr int kCPT = 4;   // columns a thread holds
constexpr int kDP = 16;   // d a thread holds of each
__host__ __device__ constexpr int split_of(int D) { return D / kDP; }
__host__ __device__ constexpr int threads_of(int D) {
  return D / kCPT * split_of(D);
}
// Time steps a pass stages: D / 4 (each staged input D^2 / 4 values) up
// to 16, so that the local kernel's four inputs stay within 48 KB.
__host__ __device__ constexpr int pass_of(int D) { return D < 64 ? D / 4 : 16; }

// Chunk c of (b, h): steps [c * ct, min((c + 1) * ct, T)), grid
// (B * n_chunks, H), threads_of(D) threads laid out as above.  The
// recurrence of wkv6_kernel over the chunk, from state0 in chunk 0 and
// from zeros in every other.  The bonus term sum_d r_d u_d k_d v_e is v_e
// times a per-step scalar that no column changes, computed once per step
// for the block.  The next pass's inputs are fetched into registers while
// the current one is computed.  Chunk 0's outputs are final and go to
// out; the others' go to local (float32).  Writes the end state to L (B,
// n_chunks, H, D, D) and the chunk's decay product to W (B, n_chunks, H,
// D).
template <typename T, int D>
__global__ void __launch_bounds__(threads_of(D))
    wkv6_local_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ state0, T* __restrict__ out,
                      float* __restrict__ local, float* __restrict__ L,
                      float* __restrict__ W, int T_len, int H, int ct,
                      int n_chunks) {
  constexpr int SPLIT = split_of(D);
  constexpr int NT = threads_of(D);
  constexpr int CT = pass_of(D);
  constexpr int DW = (D + NT - 1) / NT;        // decays a thread multiplies
  constexpr int LPS = NT >= CT ? NT / CT : 1;  // threads a bonus term
  constexpr unsigned kMask = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  static_assert(D % kDP == 0 && 32 % LPS == 0 && (NT >= 32 || 32 % NT == 0),
                "bad D");

  __shared__ __align__(16) float sr[CT * D];
  __shared__ __align__(16) float sk[CT * D];
  __shared__ __align__(16) float sw[CT * D];
  __shared__ __align__(16) float sv[CT * D];
  __shared__ float su[D];
  __shared__ float sb[CT];              // sum_d r_d u_d k_d of each step

  const int h = blockIdx.y;
  const int b = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int part = threadIdx.x % SPLIT;
  const int e0 = kCPT * (threadIdx.x / SPLIT);
  const int t_begin = c * ct, t_end = min(T_len, t_begin + ct);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row + h * D;

  Rows<T, D, CT, NT> fr, fk, fw, fv;
  auto fetch = [&](int t0) {
    const int n = min(CT, t_end - t0);
    const size_t at = base + static_cast<size_t>(t0) * row;
    fr.fetch(r + at, row, n);
    fk.fetch(k + at, row, n);
    fw.fetch(w + at, row, n);
    fv.fetch(v + at, row, n);
  };
  fetch(t_begin);

  for (int i = threadIdx.x; i < D; i += NT) su[i] = u[h * D + i];
  // S[cc][4 i + x] is S[4 (SPLIT i + part) + x, e0 + cc]
  float S[kCPT][kDP];
#pragma unroll
  for (int i = 0; i < kDP / 4; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = 4 * (SPLIT * i + part) + x;
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c == 0 && state0)
        s4 = *reinterpret_cast<const float4*>(state0 + bh * D * D +
                                              static_cast<size_t>(d) * D + e0);
      S[0][4 * i + x] = s4.x;
      S[1][4 * i + x] = s4.y;
      S[2][4 * i + x] = s4.z;
      S[3][4 * i + x] = s4.w;
    }
  float wp[DW];
#pragma unroll
  for (int i = 0; i < DW; ++i) wp[i] = 1.f;

  for (int t0 = t_begin; t0 < t_end; t0 += CT) {
    const int n = min(CT, t_end - t0);
    __syncthreads();  // the previous pass is consumed
    fr.put(sr, n);
    fk.put(sk, n);
    fw.put(sw, n);
    fv.put(sv, n);
    __syncthreads();
    if (t0 + CT < t_end) fetch(t0 + CT);
    // The bonus terms: LPS threads of one warp a step, then a shuffle sum.
    for (int b0 = 0; b0 < CT; b0 += NT / LPS) {
      const int tt = b0 + threadIdx.x / LPS, sub = threadIdx.x % LPS;
      float bonus = 0.f;
      if (tt < n) {
#pragma unroll
        for (int d = sub; d < D; d += LPS)
          bonus = fmaf(sr[tt * D + d] * su[d], sk[tt * D + d], bonus);
      }
#pragma unroll
      for (int off = 1; off < LPS; off *= 2)
        bonus += __shfl_xor_sync(kMask, bonus, off);
      if (sub == 0 && tt < n) sb[tt] = bonus;
    }
    __syncthreads();

    // Unrolled by 4: a step's loads and products overlap its neighbours'.
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(sv + tt * D + e0);
      const float ve[kCPT] = {v4.x, v4.y, v4.z, v4.w};
      const float4* r4 = reinterpret_cast<const float4*>(sr + tt * D);
      const float4* k4 = reinterpret_cast<const float4*>(sk + tt * D);
      const float4* w4 = reinterpret_cast<const float4*>(sw + tt * D);
      float acc[kCPT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kDP / 4; ++i) {
        const int q = SPLIT * i + part;
        const float4 r4q = r4[q], k4q = k4[q], w4q = w4[q];
        const float rr[4] = {r4q.x, r4q.y, r4q.z, r4q.w};
        const float kk[4] = {k4q.x, k4q.y, k4q.z, k4q.w};
        const float ww[4] = {w4q.x, w4q.y, w4q.z, w4q.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int cc = 0; cc < kCPT; ++cc) {
            float& sv_ = S[cc][4 * i + x];
            acc[cc] = fmaf(rr[x], sv_, acc[cc]);
            sv_ = fmaf(ww[x], sv_, kk[x] * ve[cc]);
          }
      }
#pragma unroll
      for (int off = 1; off < SPLIT; off *= 2)
#pragma unroll
        for (int cc = 0; cc < kCPT; ++cc)
          acc[cc] += __shfl_xor_sync(kMask, acc[cc], off);
      const float bonus = sb[tt];
      const size_t at = base + static_cast<size_t>(t0 + tt) * row + e0;
#pragma unroll
      for (int cc = 0; cc < kCPT; ++cc) {
        if (cc % SPLIT != part) continue;  // the column's storing part
        const float o = fmaf(ve[cc], bonus, acc[cc]);
        if (c == 0)
          out[at + cc] = Vec<T>::store(o);
        else
          local[at + cc] = o;
      }
#pragma unroll
      for (int i = 0; i < DW; ++i)
        if (threadIdx.x + i * NT < D)
          wp[i] *= sw[tt * D + threadIdx.x + i * NT];
    }
  }

  const size_t slot = (static_cast<size_t>(b) * n_chunks + c) * H + h;
#pragma unroll
  for (int i = 0; i < kDP / 4; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = 4 * (SPLIT * i + part) + x;
      *reinterpret_cast<float4*>(L + slot * D * D +
                                 static_cast<size_t>(d) * D + e0) =
          make_float4(S[0][4 * i + x], S[1][4 * i + x], S[2][4 * i + x],
                      S[3][4 * i + x]);
    }
#pragma unroll
  for (int i = 0; i < DW; ++i)
    if (threadIdx.x + i * NT < D) W[slot * D + threadIdx.x + i * NT] = wp[i];
}

// One thread per element (b, h, d, e) of the states: S_1 = L_0, then
// S_{c+1} = W_c[d] S_c + L_c, each S_{c+1} written over L_c (c + 1 <
// n_chunks) and the last to state_out.  Reads and writes are coalesced
// (neighbouring threads take neighbouring e).
__global__ void wkv6_scan_kernel(float* __restrict__ L,
                                 const float* __restrict__ W,
                                 float* __restrict__ state_out, int B, int H,
                                 int D, int n_chunks) {
  const size_t per_b = static_cast<size_t>(H) * D * D;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * per_b) return;
  const size_t b = i / per_b, hde = i % per_b;
  const size_t hd = hde / D;  // h * D + d
  const size_t per_c = static_cast<size_t>(H) * D;  // stride of c in W
  float* Lb = L + b * n_chunks * per_b + hde;
  const float* Wb = W + b * n_chunks * per_c + hd;
  float S = Lb[0];
  // Groups of kAhead chunks: the group's loads are issued before its
  // stores, so that they are in flight together.
  constexpr int kAhead = 8;
  for (int c0 = 1; c0 < n_chunks; c0 += kAhead) {
    float l[kAhead], wc[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = c0 + j;
      l[j] = c < n_chunks ? Lb[c * per_b] : 0.f;
      wc[j] = c < n_chunks ? Wb[c * per_c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = c0 + j;
      if (c < n_chunks) {
        S = fmaf(wc[j], S, l[j]);
        if (c + 1 < n_chunks) Lb[c * per_b] = S;
      }
    }
  }
  state_out[i] = S;
}

// Chunk c >= 1 of (b, h), grid (B * (n_chunks - 1), H), threads_of(D)
// threads laid out as in wkv6_local_kernel, each holding its part of
// S_c[:, e0 .. e0 + kCPT - 1] (slot c - 1 of L after the scan).  For each
// step t of the chunk the parts sum (r_t * p_t) . S_c[:, e] and the
// column's storing part adds it to local_t[e] and writes out, rounded
// once.  The block stages r and w, then turns r_t into r_t * p_t in
// shared memory, p_t the exclusive product of the chunk's decays, each
// d's running product kept by one thread.  The next pass's r, w and local
// are fetched into registers while the current one is computed.
template <typename T, int D>
__global__ void __launch_bounds__(threads_of(D))
    wkv6_correct_kernel(const T* __restrict__ r, const T* __restrict__ w,
                        const float* __restrict__ local,
                        const float* __restrict__ L, T* __restrict__ out,
                        int T_len, int H, int ct, int n_chunks) {
  constexpr int SPLIT = split_of(D);
  constexpr int NT = threads_of(D);
  constexpr int CT = pass_of(D);
  constexpr int DW = (D + NT - 1) / NT;
  constexpr int NS = SPLIT < kCPT ? kCPT / SPLIT : 1;  // columns it stores
  constexpr unsigned kMask = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  __shared__ __align__(16) float srp[CT * D];
  __shared__ __align__(16) float sw[CT * D];

  const int h = blockIdx.y;
  const int b = blockIdx.x / (n_chunks - 1);
  const int c = 1 + blockIdx.x % (n_chunks - 1);
  const int part = threadIdx.x % SPLIT;
  const int e0 = kCPT * (threadIdx.x / SPLIT);
  const int t_begin = c * ct, t_end = min(T_len, t_begin + ct);
  const size_t row = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_len * row + h * D;

  Rows<T, D, CT, NT> fr, fw;
  float lo[NS][CT] = {};  // local_t of the columns it stores, next pass
  auto fetch = [&](int t0) {
    const int n = min(CT, t_end - t0);
    const size_t at = base + static_cast<size_t>(t0) * row;
    fr.fetch(r + at, row, n);
    fw.fetch(w + at, row, n);
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const int cc = part + m * SPLIT;
#pragma unroll
      for (int tt = 0; tt < CT; ++tt)
        if (cc < kCPT && tt < n) lo[m][tt] = local[at + tt * row + e0 + cc];
    }
  };
  fetch(t_begin);

  float S[kCPT][kDP];
  const size_t slot = (static_cast<size_t>(b) * n_chunks + c - 1) * H + h;
#pragma unroll
  for (int i = 0; i < kDP / 4; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = 4 * (SPLIT * i + part) + x;
      const float4 s4 = *reinterpret_cast<const float4*>(
          L + slot * D * D + static_cast<size_t>(d) * D + e0);
      S[0][4 * i + x] = s4.x;
      S[1][4 * i + x] = s4.y;
      S[2][4 * i + x] = s4.z;
      S[3][4 * i + x] = s4.w;
    }
  float p[DW];
#pragma unroll
  for (int i = 0; i < DW; ++i) p[i] = 1.f;

  for (int t0 = t_begin; t0 < t_end; t0 += CT) {
    const int n = min(CT, t_end - t0);
    __syncthreads();  // the previous pass is consumed
    fr.put(srp, n);
    fw.put(sw, n);
    float lc[NS][CT];
#pragma unroll
    for (int m = 0; m < NS; ++m)
#pragma unroll
      for (int tt = 0; tt < CT; ++tt) lc[m][tt] = lo[m][tt];
    __syncthreads();
    if (t0 + CT < t_end) fetch(t0 + CT);
#pragma unroll
    for (int i = 0; i < DW; ++i) {
      const int d = threadIdx.x + i * NT;
      if (d < D) {
#pragma unroll
        for (int tt = 0; tt < CT; ++tt) {
          if (tt < n) {
            srp[tt * D + d] *= p[i];
            p[i] *= sw[tt * D + d];
          }
        }
      }
    }
    __syncthreads();
    auto step = [&](int tt) {
      const float4* rp4 = reinterpret_cast<const float4*>(srp + tt * D);
      float acc[kCPT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kDP / 4; ++i) {
        const float4 x4 = rp4[SPLIT * i + part];
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int cc = 0; cc < kCPT; ++cc)
            acc[cc] = fmaf(xs[x], S[cc][4 * i + x], acc[cc]);
      }
#pragma unroll
      for (int off = 1; off < SPLIT; off *= 2)
#pragma unroll
        for (int cc = 0; cc < kCPT; ++cc)
          acc[cc] += __shfl_xor_sync(kMask, acc[cc], off);
      const size_t at = base + static_cast<size_t>(t0 + tt) * row + e0;
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const int cc = part + m * SPLIT;
        if (cc < kCPT) out[at + cc] = Vec<T>::store(lc[m][tt] + acc[cc]);
      }
    };
    if (n == CT) {  // a whole pass: no guard between the steps
#pragma unroll
      for (int tt = 0; tt < CT; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < n; ++tt) step(tt);
    }
  }
}

template <typename T, int D>
void launch_chunked(const void* r, const void* k, const void* v,
                    const void* w, const float* u, const float* s0, void* out,
                    float* s_out, float* local, float* L, float* W, int B,
                    int T_len, int H, int ct, cudaStream_t stream) {
  const int n_chunks = (T_len + ct - 1) / ct;
  wkv6_local_kernel<T, D>
      <<<dim3(B * n_chunks, H), threads_of(D), 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
          static_cast<T*>(out), local, L, W, T_len, H, ct, n_chunks);
  const size_t n = static_cast<size_t>(B) * H * D * D;
  wkv6_scan_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     stream>>>(L, W, s_out, B, H, D, n_chunks);
  if (n_chunks > 1)
    wkv6_correct_kernel<T, D>
        <<<dim3(B * (n_chunks - 1), H), threads_of(D), 0, stream>>>(
            static_cast<const T*>(r), static_cast<const T*>(w), local, L,
            static_cast<T*>(out), T_len, H, ct, n_chunks);
}

template <typename T>
bool dispatch_chunked(int D, const void* r, const void* k, const void* v,
                      const void* w, const float* u, const float* s0,
                      void* out, float* s_out, float* local, float* L,
                      float* W, int B, int T_len, int H, int ct,
                      cudaStream_t st) {
  switch (D) {
    case 16: launch_chunked<T, 16>(r, k, v, w, u, s0, out, s_out, local, L, W, B, T_len, H, ct, st); return true;
    case 32: launch_chunked<T, 32>(r, k, v, w, u, s0, out, s_out, local, L, W, B, T_len, H, ct, st); return true;
    case 64: launch_chunked<T, 64>(r, k, v, w, u, s0, out, s_out, local, L, W, B, T_len, H, ct, st); return true;
    case 128: launch_chunked<T, 128>(r, k, v, w, u, s0, out, s_out, local, L, W, B, T_len, H, ct, st); return true;
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

// The chunked route: as repro_wkv6, with chunks of ct steps (ct > 0) and
// three float32 scratch buffers from the caller, none aliasing another
// argument: local (B, T, H, D); L (B, n_chunks, H, D, D); W (B, n_chunks,
// H, D); n_chunks = cdiv(T, ct).  state_out may alias state0: state0 is
// read by the first launch only, state_out written by the second.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a dtype, D or ct the kernels are not built
// for.
extern "C" int repro_wkv6_chunked(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* state0,
                                  void* out, void* state_out, void* local,
                                  void* L, void* W, int B, int T_len, int H,
                                  int D, int ct, int dtype, void* stream) {
  if (ct < 1 || T_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  float* lo = static_cast<float*>(local);
  float* Lf = static_cast<float*>(L);
  float* Wf = static_cast<float*>(W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_chunked<float>(D, r, k, v, w, uf, s0, out, so, lo, Lf, Wf, B, T_len, H, ct, st);
  else if (dtype == 1)
    ok = dispatch_chunked<__nv_bfloat16>(D, r, k, v, w, uf, s0, out, so, lo, Lf, Wf, B, T_len, H, ct, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
