// Gradient of the RWKV6 WKV recurrence (csrc/wkv6.cu) for Hopper (sm_90a).
// Per (batch b, head h), with S_{t-1} the D x D float32 state before step t
// and G_t the gradient of the loss with respect to S_t (G_T = g_state, or
// zeros when it is null):
//     G_{t-1} = diag(w_t) G_t + r_t^T go_t
//     dr_t[d] = sum_e S_{t-1}[d,e] go_t[e] + u[d] k_t[d] (v_t . go_t)
//     dk_t[d] = sum_e G_t[d,e] v_t[e]     + u[d] r_t[d] (v_t . go_t)
//     dv_t[e] = sum_d G_t[d,e] k_t[d]     + go_t[e] sum_d r_t[d] u[d] k_t[d]
//     dw_t[d] = sum_e G_t[d,e] S_{t-1}[d,e]
//     du[d]   = sum_{b,t} r_t[d] k_t[d] (v_t . go_t)
//     dstate0 = G_0
// (kernels/wkv6/ref.py: wkv6_backward_ref derives them; autograd through
// wkv6_ref is the yardstick).  Every step in float32; each gradient is
// rounded once to its dtype: dr, dk, dv and dw to r's, du and dstate0
// float32.
//
// Replaces the gradient of the TPU kernel src/repro/kernels/wkv6/kernel.py
// (wkv6_pallas), which the reference takes by differentiating its
// lax.scan; the port's training path (models/rwkv6.py, through
// kernels/wkv6/ops.py's autograd Function) runs it once a layer and step.
//
// Bound on the card: the gradient needs 14 D^2 float32 flops per (b, h, t)
// (and 3 D^2 more for the chunk states; kernels/wkv6/ops.py:
// wkv6_backward_cost), over the inputs, g_out and the gradients read and
// written once: at rwkv6-1.6b's training shape (B 2, T 256, H 32, D 64)
// 1.14 GFLOP, the float32 rate bounds it.  This kernel does 21 D^2 a step
// (and 5 D^2 for the chunk states): the repeats are named below.  But the work is 2 B H D
// chains of T dependent steps each, like the forward's step route, and
// this first kernel is simple before it is fast: one thread a row or
// column, no tensor cores.  Each thread's row or column of G (and of S)
// lives in registers for D <= 64 (wkv6_backward_kernel, rwkv6's D 64), in
// device memory for every other D (wkv6_backward_any_kernel), so every D
// >= 1 and every T >= 1 runs.  What the design does about the rest:
//   * Memory bounded independently of T: the states S_{t-1} are never all
//     kept.  The wrapper first recomputes the state at each chunk's entry
//     (chunks of ct steps) with the forward's own chunked route (its local
//     and scan kernels, csrc/wkv6.cu: repro_wkv6_chunk_states; one float32
//     state a chunk), and the row pass below
//     recomputes one chunk's states at a time into a scratch of ct states
//     per (b, h), walking the chunks from the last.
//   * No reduction across threads, so nothing needs atomics and the result
//     is the same bit for bit on every run.  Each gradient element is
//     written by one thread, which sums its terms in a fixed order:
//       - the row pass: thread d owns row d of S and G.  dr_t[d], dk_t[d],
//         dw_t[d] and v_t . go_t sum over e inside the thread, and row d
//         of G updates from its own row alone (diag(w_t) scales rows);
//       - the column pass: thread e owns column e of G (the forward's
//         layout) and sums dv_t[e] over d inside the thread; G_0's column
//         is dstate0's column;
//       - du: each row thread sums its d over t; a last kernel sums the
//         batch in order.
//   The price of no cross-thread reduction is 7 D^2 flops a step of
//   repeated work: the column pass updates G again (3 D^2) and redoes
//   the u r go term (2 D^2), and every row thread computes v_t . go_t
//   (2 D^2); the chunk-state pass also writes outputs it does not need
//   (2 D^2 a step).  The two passes run as one launch, the row blocks
//   beside the column blocks.
//   * Device memory is read in coalesced rows: a thread's row of S and G
//     is stored transposed ([e][d]), so neighbouring threads (rows) touch
//     neighbouring words; the column pass reads G[d][e] with neighbouring
//     threads on neighbouring e.  r, k, v, w and go of one step are read
//     by broadcast (every thread of a warp the same address).
// Tensor cores, TMA and a chunked matrix form are for a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kThreads = 32;  // rows (row pass) or columns (column pass)
// Each thread walks its row or column of S and G in groups of kGroup
// elements: a group's loads are issued before its stores, so they are in
// flight together (the compiler cannot move a load past a store through
// the same pointer by itself).  Sums still run in order of the index.
constexpr int kGroup = 8;

// Both backward kernels: grid (2 cdiv(D, kThreads), H, B), the first
// cdiv(D, kThreads) blocks of x running the row pass of (b, h) = (z, y),
// the others its column pass.
//
// wkv6_backward_any_kernel, any D: each thread's row or column of G and S
// in device memory.
// Row pass, thread d of (b, h): G[d, :] in Gt (B, H, D, D) at Gd[e * D],
// from g_state's row d (or zeros).  For each chunk c from the last, its
// entry state S_c (state0 or zeros for c = 0, else slot (b * n_chunks + c
// - 1) * H + h of `entry`, where the forward's chunked route leaves the
// entry state of chunk c), row d, goes to the chunk's first slot of hist
// (B, H, span, D, D), span = min(ct, T): S_{t-1}[d, e] of the chunk's
// step j at Sd[(j * D + e) * D], each step's from the one before.  Then
// the chunk's steps from its last: dr, dk and dw of row d, G's row d
// updated to G_{t-1}; du's row d summed over t into du_part (B, H, D).
//
// Column pass, thread e of (b, h): G[:, e] in dstate0 (B, H, D, D), from
// g_state's column e (or zeros), at t = T - 1 .. 0: dv_t[e] = sum_d k_d
// (G[d, e] + u_d r_d go_e), then G[d, e] <- w_d G[d, e] + r_d go_e.  After
// step 0 the column is G_0's: dstate0 is written in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_backward_any_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ state0,
                         const T* __restrict__ go,
                         const float* __restrict__ g_state,
                         const float* __restrict__ entry, T* __restrict__ dr,
                         T* __restrict__ dk, T* __restrict__ dv,
                         T* __restrict__ dw, float* __restrict__ dstate0,
                         float* __restrict__ du_part, float* __restrict__ hist,
                         float* __restrict__ Gt, int T_len, int H, int D,
                         int ct, int n_chunks) {
  const int tiles = (D + kThreads - 1) / kThreads;
  const bool rows = static_cast<int>(blockIdx.x) < tiles;
  const int b = blockIdx.z, h = blockIdx.y;
  const int x = (rows ? blockIdx.x : blockIdx.x - tiles) * kThreads +
                threadIdx.x;  // d (rows) or e (columns)
  if (x >= D) return;  // no barrier follows
  const size_t DD = static_cast<size_t>(D) * D;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row = static_cast<size_t>(H) * D;  // stride of t
  const size_t base = static_cast<size_t>(b) * T_len * row +
                      static_cast<size_t>(h) * D;
  const float* uh = u + static_cast<size_t>(h) * D;

  if (!rows) {  // ---- column pass: dv, dstate0
    const int e = x;
    float* G = dstate0 + bh * DD + e;  // G[d, e] at G[d * D]
    const float* gs = g_state ? g_state + bh * DD + e : nullptr;
    for (int d = 0; d < D; ++d)
      G[static_cast<size_t>(d) * D] = gs ? gs[static_cast<size_t>(d) * D] : 0.f;
    for (int t = T_len - 1; t >= 0; --t) {
      const size_t at = base + static_cast<size_t>(t) * row;
      const float ge = to_float(go[at + e]);
      float acc = 0.f;
      for (int d0 = 0; d0 < D; d0 += kGroup) {
        float g[kGroup], rr[kGroup], kk[kGroup], ww[kGroup], uu[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int d = d0 + i;
          const bool in = d < D;
          g[i] = in ? G[static_cast<size_t>(d) * D] : 0.f;
          rr[i] = in ? to_float(r[at + d]) : 0.f;
          kk[i] = in ? to_float(k[at + d]) : 0.f;
          ww[i] = in ? to_float(w[at + d]) : 0.f;
          uu[i] = in ? __ldg(uh + d) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float rg = rr[i] * ge;
          acc = fmaf(kk[i], fmaf(uu[i], rg, g[i]), acc);
          g[i] = fmaf(ww[i], g[i], rg);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (d0 + i < D) G[static_cast<size_t>(d0 + i) * D] = g[i];
      }
      dv[at + e] = from_float<T>(acc);
    }
    return;
  }

  // ---- row pass: dr, dk, dw, du
  const int d = x;
  const int span = min(ct, T_len);
  float* Gd = Gt + bh * DD + d;                 // G[d, e] at Gd[e * D]
  float* Sd = hist + bh * span * DD + d;        // see above
  const float* gs = g_state ? g_state + bh * DD + static_cast<size_t>(d) * D
                            : nullptr;
  for (int e = 0; e < D; ++e) Gd[static_cast<size_t>(e) * D] = gs ? gs[e] : 0.f;
  const float ud = uh[d];
  float du = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * ct, n = min(ct, T_len - t0);
    const float* S0 =
        c == 0 ? (state0 ? state0 + bh * DD + static_cast<size_t>(d) * D
                         : nullptr)
               : entry + ((static_cast<size_t>(b) * n_chunks + c - 1) * H + h) *
                             DD +
                     static_cast<size_t>(d) * D;
    for (int e = 0; e < D; ++e) Sd[static_cast<size_t>(e) * D] = S0 ? S0[e] : 0.f;
    for (int j = 0; j + 1 < n; ++j) {  // S_{t-1} of each step of the chunk
      const size_t at = base + static_cast<size_t>(t0 + j) * row;
      const float wd = to_float(w[at + d]), kd = to_float(k[at + d]);
      const float* prev = Sd + static_cast<size_t>(j) * DD;
      float* next = Sd + static_cast<size_t>(j + 1) * DD;
      for (int e0 = 0; e0 < D; e0 += kGroup) {
        float sv[kGroup], vv[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int e = e0 + i;
          sv[i] = e < D ? prev[static_cast<size_t>(e) * D] : 0.f;
          vv[i] = e < D ? to_float(v[at + e]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (e0 + i < D)
            next[static_cast<size_t>(e0 + i) * D] = fmaf(wd, sv[i], kd * vv[i]);
      }
    }
    for (int j = n - 1; j >= 0; --j) {
      const size_t at = base + static_cast<size_t>(t0 + j) * row;
      const float rd = to_float(r[at + d]), kd = to_float(k[at + d]);
      const float wd = to_float(w[at + d]);
      const float* S = Sd + static_cast<size_t>(j) * DD;
      float a_r = 0.f, a_k = 0.f, a_w = 0.f, vgo = 0.f;
      for (int e0 = 0; e0 < D; e0 += kGroup) {
        float sv[kGroup], g[kGroup], ge[kGroup], ve[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int e = e0 + i;
          const bool in = e < D;
          sv[i] = in ? S[static_cast<size_t>(e) * D] : 0.f;
          g[i] = in ? Gd[static_cast<size_t>(e) * D] : 0.f;
          ge[i] = in ? to_float(go[at + e]) : 0.f;
          ve[i] = in ? to_float(v[at + e]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          a_r = fmaf(sv[i], ge[i], a_r);
          a_k = fmaf(g[i], ve[i], a_k);
          a_w = fmaf(g[i], sv[i], a_w);
          vgo = fmaf(ve[i], ge[i], vgo);
          g[i] = fmaf(wd, g[i], rd * ge[i]);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (e0 + i < D) Gd[static_cast<size_t>(e0 + i) * D] = g[i];
      }
      const float uv = ud * vgo;
      dr[at + d] = from_float<T>(fmaf(uv, kd, a_r));
      dk[at + d] = from_float<T>(fmaf(uv, rd, a_k));
      dw[at + d] = from_float<T>(a_w);
      du = fmaf(rd * kd, vgo, du);
    }
  }
  du_part[bh * D + d] = du;
}

// wkv6_backward_kernel, D <= DM (16, 32 or 64; the elements past D
// masked): the same passes, the same sums in the same order, with the
// thread's row or column of G in DM registers.  The row pass keeps its row
// of S in registers while it writes the chunk's states to hist, and reads
// one step's row back from hist into registers as a whole, DM loads in
// flight together; no thread touches Gt.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
    wkv6_backward_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ state0,
                         const T* __restrict__ go,
                         const float* __restrict__ g_state,
                         const float* __restrict__ entry, T* __restrict__ dr,
                         T* __restrict__ dk, T* __restrict__ dv,
                         T* __restrict__ dw, float* __restrict__ dstate0,
                         float* __restrict__ du_part, float* __restrict__ hist,
                         int T_len, int H, int D, int ct, int n_chunks) {
  const int tiles = (D + kThreads - 1) / kThreads;
  const bool rows = static_cast<int>(blockIdx.x) < tiles;
  const int b = blockIdx.z, h = blockIdx.y;
  const int x = (rows ? blockIdx.x : blockIdx.x - tiles) * kThreads +
                threadIdx.x;  // d (rows) or e (columns)
  if (x >= D) return;  // no barrier follows
  const size_t DD = static_cast<size_t>(D) * D;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row = static_cast<size_t>(H) * D;  // stride of t
  const size_t base = static_cast<size_t>(b) * T_len * row +
                      static_cast<size_t>(h) * D;
  const float* uh = u + static_cast<size_t>(h) * D;
  float g[DM];

  if (!rows) {  // ---- column pass: dv, dstate0
    const int e = x;
    const float* gs = g_state ? g_state + bh * DD + e : nullptr;
#pragma unroll
    for (int d = 0; d < DM; ++d)
      g[d] = gs && d < D ? gs[static_cast<size_t>(d) * D] : 0.f;
    for (int t = T_len - 1; t >= 0; --t) {
      const size_t at = base + static_cast<size_t>(t) * row;
      const float ge = to_float(go[at + e]);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        const bool in = d < D;
        const float rg = (in ? to_float(r[at + d]) : 0.f) * ge;
        acc = fmaf(in ? to_float(k[at + d]) : 0.f,
                   fmaf(in ? __ldg(uh + d) : 0.f, rg, g[d]), acc);
        g[d] = fmaf(in ? to_float(w[at + d]) : 0.f, g[d], rg);
      }
      dv[at + e] = from_float<T>(acc);
    }
#pragma unroll
    for (int d = 0; d < DM; ++d)
      if (d < D) dstate0[bh * DD + static_cast<size_t>(d) * D + e] = g[d];
    return;
  }

  // ---- row pass: dr, dk, dw, du
  const int d = x;
  const int span = min(ct, T_len);
  float* Sd = hist + bh * span * DD + d;  // S_{t-1}[d, e] at Sd[(j D + e) D]
  const float* gs = g_state ? g_state + bh * DD + static_cast<size_t>(d) * D
                            : nullptr;
#pragma unroll
  for (int e = 0; e < DM; ++e) g[e] = gs && e < D ? gs[e] : 0.f;
  const float ud = uh[d];
  float du = 0.f;
  float s[DM];
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * ct, n = min(ct, T_len - t0);
    const float* S0 =
        c == 0 ? (state0 ? state0 + bh * DD + static_cast<size_t>(d) * D
                         : nullptr)
               : entry + ((static_cast<size_t>(b) * n_chunks + c - 1) * H + h) *
                             DD +
                     static_cast<size_t>(d) * D;
#pragma unroll
    for (int e = 0; e < DM; ++e) s[e] = S0 && e < D ? S0[e] : 0.f;
    for (int j = 0; j < n; ++j) {  // S_{t-1} of each step of the chunk
      float* Hj = Sd + static_cast<size_t>(j) * DD;
#pragma unroll
      for (int e = 0; e < DM; ++e)
        if (e < D) Hj[static_cast<size_t>(e) * D] = s[e];
      if (j + 1 == n) break;
      const size_t at = base + static_cast<size_t>(t0 + j) * row;
      const float wd = to_float(w[at + d]), kd = to_float(k[at + d]);
#pragma unroll
      for (int e = 0; e < DM; ++e)
        s[e] = fmaf(wd, s[e], kd * (e < D ? to_float(v[at + e]) : 0.f));
    }
    for (int j = n - 1; j >= 0; --j) {
      const float* Hj = Sd + static_cast<size_t>(j) * DD;
#pragma unroll
      for (int e = 0; e < DM; ++e)
        s[e] = e < D ? Hj[static_cast<size_t>(e) * D] : 0.f;
      const size_t at = base + static_cast<size_t>(t0 + j) * row;
      const float rd = to_float(r[at + d]), kd = to_float(k[at + d]);
      const float wd = to_float(w[at + d]);
      float a_r = 0.f, a_k = 0.f, a_w = 0.f, vgo = 0.f;
#pragma unroll
      for (int e = 0; e < DM; ++e) {
        const bool in = e < D;
        const float ge = in ? to_float(go[at + e]) : 0.f;
        const float ve = in ? to_float(v[at + e]) : 0.f;
        a_r = fmaf(s[e], ge, a_r);
        a_k = fmaf(g[e], ve, a_k);
        a_w = fmaf(g[e], s[e], a_w);
        vgo = fmaf(ve, ge, vgo);
        g[e] = fmaf(wd, g[e], rd * ge);
      }
      const float uv = ud * vgo;
      dr[at + d] = from_float<T>(fmaf(uv, kd, a_r));
      dk[at + d] = from_float<T>(fmaf(uv, rd, a_k));
      dw[at + d] = from_float<T>(a_w);
      du = fmaf(rd * kd, vgo, du);
    }
  }
  du_part[bh * D + d] = du;
}

// du[h, d] = sum over b, in order, of du_part[b, h, d]; one thread each.
__global__ void wkv6_backward_du_kernel(const float* __restrict__ du_part,
                                        float* __restrict__ du, int B,
                                        int HD) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HD) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[static_cast<size_t>(b) * HD + i];
  du[i] = s;
}

template <typename T>
void launch(const void* r, const void* k, const void* v, const void* w,
            const float* u, const float* s0, const void* go, const float* gs,
            const float* entry, void* dr, void* dk, void* dv, void* dw,
            float* du, float* ds0, float* du_part, float* hist, float* Gt,
            int B, int T_len, int H, int D, int ct, cudaStream_t st) {
  const int n_chunks = (T_len + ct - 1) / ct;
  const dim3 grid(2 * ((D + kThreads - 1) / kThreads), H, B);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  const T* got = static_cast<const T*>(go);
  T* drt = static_cast<T*>(dr);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  T* dwt = static_cast<T*>(dw);
  if (D <= 16)
    wkv6_backward_kernel<T, 16><<<grid, kThreads, 0, st>>>(
        rt, kt, vt, wt, u, s0, got, gs, entry, drt, dkt, dvt, dwt, ds0,
        du_part, hist, T_len, H, D, ct, n_chunks);
  else if (D <= 32)
    wkv6_backward_kernel<T, 32><<<grid, kThreads, 0, st>>>(
        rt, kt, vt, wt, u, s0, got, gs, entry, drt, dkt, dvt, dwt, ds0,
        du_part, hist, T_len, H, D, ct, n_chunks);
  else if (D <= 64)
    wkv6_backward_kernel<T, 64><<<grid, kThreads, 0, st>>>(
        rt, kt, vt, wt, u, s0, got, gs, entry, drt, dkt, dvt, dwt, ds0,
        du_part, hist, T_len, H, D, ct, n_chunks);
  else
    wkv6_backward_any_kernel<T><<<grid, kThreads, 0, st>>>(
        rt, kt, vt, wt, u, s0, got, gs, entry, drt, dkt, dvt, dwt, ds0,
        du_part, hist, Gt, T_len, H, D, ct, n_chunks);
  const int HD = H * D;
  wkv6_backward_du_kernel<<<(HD + 255) / 256, 256, 0, st>>>(du_part, du, B,
                                                             HD);
}

}  // namespace

// r/k/v/w/g_out and dr/dk/dv/dw (B, T, H, D) contiguous, of one dtype (0
// float32, 1 bfloat16); u and du (H, D) float32; state0, g_state and
// dstate0 (B, H, D, D) float32, state0 and g_state null for zeros.  entry:
// the scratch L (B, n_chunks, H, D, D) of repro_wkv6_chunk_states, slot c
// holding the entry state of chunk c + 1, n_chunks = cdiv(T, ct); null
// when n_chunks is 1.  Scratch, float32, none aliasing another
// argument: du_part (B, H, D), hist (B, H, min(ct, T), D, D), Gt (B, H, D,
// D).  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for another dtype, B, T, H, D or ct < 1, or a
// missing entry.
extern "C" int repro_wkv6_backward(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* state0, const void* g_out, const void* g_state,
    const void* entry, void* dr, void* dk, void* dv, void* dw, void* du,
    void* dstate0, void* du_part, void* hist, void* Gt, int B, int T_len,
    int H, int D, int ct, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || D < 1 || ct < 1 ||
      (dtype != 0 && dtype != 1) || (T_len > ct && entry == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  const float* gs = static_cast<const float*>(g_state);
  const float* en = static_cast<const float*>(entry);
  float* duf = static_cast<float*>(du);
  float* ds0 = static_cast<float*>(dstate0);
  float* dup = static_cast<float*>(du_part);
  float* hi = static_cast<float*>(hist);
  float* gt = static_cast<float*>(Gt);
  if (dtype == 0)
    launch<float>(r, k, v, w, uf, s0, g_out, gs, en, dr, dk, dv, dw, duf, ds0,
                  dup, hi, gt, B, T_len, H, D, ct, st);
  else
    launch<__nv_bfloat16>(r, k, v, w, uf, s0, g_out, gs, en, dr, dk, dv, dw,
                          duf, ds0, dup, hi, gt, B, T_len, H, D, ct, st);
  return static_cast<int>(cudaGetLastError());
}
