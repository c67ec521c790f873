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
// float32.  No atomics: every sum runs in a fixed order, so two calls are
// equal bit for bit.
//
// Replaces the gradient of the TPU kernel src/repro/kernels/wkv6/kernel.py
// (wkv6_pallas), which the reference takes by differentiating its
// lax.scan; the port's training path (models/rwkv6.py, through
// kernels/wkv6/ops.py's autograd Function) runs it once a layer and step.
//
// Bound on the card: the gradient needs 14 D^2 float32 flops per (b, h, t)
// (S_{t-1} 3, G 3, dr, dk, dv and dw 2 each; the u terms are O(D)) and 3
// D^2 more for the chunk entry states (kernels/wkv6/ops.py:
// wkv6_backward_cost), over the inputs, g_out and the gradients read and
// written once: at rwkv6-1.6b's training shape (B 2, T 256, H 32, D 64)
// 1.141 GFLOP, 0.01703 ms at the float32 rate.
//
// Two routes, chosen by the wrapper from the shape (kernels/wkv6/kernel.py:
// backward_route), one C entry each.
//
// repro_wkv6_backward_parallel, D 16, 32 and 64 (rwkv6's D 64), any T: T
// is cut into chunks of ct steps (16 on the training path) that all run at
// once.  G_{t-1} = diag(w_t) G_t + r_t^T go_t has the forward's form with
// time reversed, so G gets its own chunk scan, and every chunk then needs
// only its entry state and exit gradient.  Only products of decays occur;
// nothing is divided.  Four passes:
//   1. S at each chunk's entry: the forward's local and scan kernels
//      (csrc/wkv6.cu: repro_wkv6_chunk_states) at ct; 5 D^2 a step (their
//      outputs, 2 D^2, are dropped) and 2 D^2 a chunk.
//   2. G at each chunk's exit: wkv6_backward_glocal_kernel gives each
//      chunk's part from a zero exit, LG_c = sum_t diag(p_t) r_t^T go_t (p_t
//      the product of the chunk's decays before t): a (D x ct) (ct x D)
//      product in 4 x 4 thread tiles, 2 D^2 a step, no chain; then
//      wkv6_backward_gscan_kernel runs exit(c - 1) = diag(W_c) exit(c) +
//      LG_c from the last chunk, one thread an element, 2 D^2 a chunk.
//   3. wkv6_backward_chunk_kernel, one block a (b, h, chunk): 1024 blocks
//      at the training shape, where the first kernel (below) ran 256 warps.
//      The block stages its chunk's r, k, v, w and g_out in shared memory
//      and recomputes the chunk's states on chip: a walk keeps the state
//      before every SUB-th step (checkpoints, shared memory), then each
//      sub-walk of SUB steps, from the last, recomputes its states into
//      registers (dr on the way) and walks back with G in registers (dk,
//      dw, dv, G's update).  So no state goes through device memory but the
//      chunks' entry states and exit gradients (the first kernel wrote and
//      read every state of a chunk, 268 MB a call at the training shape).
//      14 D^2 a step, plus 3 D^2 for each step the checkpoint walk covers
//      (2.25 D^2 a step at ct 16, SUB 4).
//   4. du: each chunk's part summed over (b, chunk) in order.
// Per step that is about 23 D^2 of work where the gradient needs 17.
//   Occupancy and sums: a lane holds R rows x E neighbouring columns of S
//   and G (Shape: at D 64, 4 x 8, so each staged go and v value read
//   serves 4 rows), the LPR = D / E lanes of a row are neighbours, a warp
//   holds 32 / LPR row groups.  dr, dk and dw sum over e inside the lane,
//   then over the row's lanes; dv sums over the lane's rows, then over the
//   warp's row groups, then (shared memory, in warp order) over the
//   block's warps.  The lane sums are fixed butterflies that swap halves
//   of what each partner holds (fold<>), so k values over 2^j lanes cost
//   about k shuffles, not k j.  At D 64 a block is 4 warps of 237
//   registers, two blocks an SM.  (Shape and ct were chosen on an H100 by
//   examples/bench_wkv6_backward_torch.py and its variants: PERF.md.)
//   Tensor cores are not used.  A step is a rank-1 update, so a chunk's
//   matrix form needs each pair of steps' decay ratio; the reference rules
//   out its dividing form (kernel.py:6-8), and TF32 alone breaks the
//   float32 bar of 1e-4 (csrc/wkv6.cu's note).  A log-space chunk form on
//   3xTF32 mma is the next lever (ROADMAP D11).
//
// repro_wkv6_backward, every other D (and chip_smoke.py's "before"): the
// first kernel, one thread a row or column of a (b, h)'s S and G, in
// registers for D <= 64 (wkv6_backward_kernel) and in device memory for
// other D (wkv6_backward_any_kernel), chains of T steps.  The chunk entry
// states come first (pass 1 above at ct 64); then, in one launch, row
// blocks walk the chunks from the last, recomputing each chunk's states
// into a scratch of ct states per (b, h) (dr, dk, dw, du's row), beside
// column blocks that update G again to sum dv over d (and give dstate0).
// No reduction crosses threads, at the price of 7 D^2 of repeated work a
// step (the column pass's G update and u r go term, v . go in every row
// thread, the dropped outputs of the chunk states).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

using repro::from_float;
using repro::to_float;

// ---- the first kernel (repro_wkv6_backward; see the note at the top)

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

// ---- the parallel route (D 16, 32 and 64; see the note at the top)

// The chunk kernel's layout at head size D: each lane holds R rows of S
// and G (d0 .. d0 + R - 1) and E neighbouring columns of each (e0 .. e0 +
// E - 1), and keeps the states of SUB steps in registers.  The LPR = D /
// E lanes of a row group are neighbours; a warp holds LG = 32 / LPR row
// groups, RPW rows.  Lane l of warp x: d0 = x RPW + R (l / LPR), e0 = E
// (l % LPR).
template <int D>
struct Shape;
template <> struct Shape<16> { static constexpr int R = 1, E = 8, SUB = 8; };
template <> struct Shape<32> { static constexpr int R = 1, E = 8, SUB = 8; };
template <> struct Shape<64> { static constexpr int R = 4, E = 8, SUB = 4; };

template <int D>
struct Par : Shape<D> {
  using S = Shape<D>;
  static constexpr int LPR = D / S::E;  // lanes that share a row group
  static constexpr int LG = 32 / LPR;   // row groups a warp
  static constexpr int RPW = LG * S::R;
  static constexpr int NW = D / RPW;    // warps a block
  static constexpr int NT = 32 * NW;
  static_assert(D % S::E == 0 && 32 % LPR == 0 && D % RPW == 0 &&
                    (S::R * S::E) % 4 == 0 && (S::SUB == 4 || S::SUB == 8),
                "bad shape");
};

// Values a lane still holds after fold<> over `lanes` lanes.
__host__ __device__ constexpr int fold_width(int lanes, int w) {
  return lanes <= 1 || w <= 1 ? w : fold_width(lanes / 2, w / 2);
}

// The chunk kernel's shared memory in bytes: the checkpoints (ct / SUB
// states), r, k, v, w and g_out staged and dr, dk and dw gathered (ct x D
// each), dv's partials of a sub-walk (SUB x warps x D), v . go and sum_d
// r u k of each step, u.
template <int D>
constexpr size_t chunk_smem_bytes(int ct) {
  using P = Par<D>;
  return sizeof(float) *
         (static_cast<size_t>(ct / P::SUB) * D * D + 8 * ct * D +
          P::SUB * P::NW * D + 2 * ct + D);
}

// The 16 bytes of x, widened to float32, to out (16-byte aligned).
template <typename T>
__device__ __forceinline__ void widen16(uint4 x, float* out);
template <>
__device__ __forceinline__ void widen16<float>(uint4 x, float* out) {
  *reinterpret_cast<uint4*>(out) = x;
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(uint4 x, float* out) {
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

// n steps of D values of a (B, T, H, D) input, from p (the first step's
// first value; `row` the stride of t) to s (n x D float32), in 16-byte
// loads spread over the block's nt threads.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ p,
                                           size_t row, int n, float* s,
                                           int nt) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RV = D / VEC;  // vectors a step
  for (int i = threadIdx.x; i < n * RV; i += nt) {
    const int t = i / RV, c = (i % RV) * VEC;
    widen16<T>(__ldg(reinterpret_cast<const uint4*>(
                   p + static_cast<size_t>(t) * row + c)),
               s + t * D + c);
  }
}

// N floats from p (16-byte aligned) to x.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    x[4 * q] = a.x, x[4 * q + 1] = a.y, x[4 * q + 2] = a.z,
          x[4 * q + 3] = a.w;
  }
}

// A thread's R x E elements of a state to checkpoint j of ckpt
// ([j][R E / 4][NT] float4: neighbouring threads, neighbouring words),
// and back.
template <int R, int E, int NT>
__device__ __forceinline__ void put_checkpoint(float4* ckpt, int j,
                                               const float (&st)[R][E]) {
#pragma unroll
  for (int y = 0; y < R; ++y)
#pragma unroll
    for (int p = 0; p < E / 4; ++p)
      ckpt[(j * (R * E / 4) + y * (E / 4) + p) * NT + threadIdx.x] =
          make_float4(st[y][4 * p], st[y][4 * p + 1], st[y][4 * p + 2],
                      st[y][4 * p + 3]);
}
template <int R, int E, int NT>
__device__ __forceinline__ void get_checkpoint(const float4* ckpt, int j,
                                               float (&st)[R][E]) {
#pragma unroll
  for (int y = 0; y < R; ++y)
#pragma unroll
    for (int p = 0; p < E / 4; ++p) {
      const float4 a =
          ckpt[(j * (R * E / 4) + y * (E / 4) + p) * NT + threadIdx.x];
      st[y][4 * p] = a.x, st[y][4 * p + 1] = a.y;
      st[y][4 * p + 2] = a.z, st[y][4 * p + 3] = a.w;
    }
}

// x[0 .. W) summed over the lanes that differ in bits M, 2 M, ... below
// MEnd, in a fixed butterfly: at each bit, partners swap halves of what
// they hold and add (a transpose reduction), so W halves a level; once W
// is 1 they add alike.  off gains the index of what the lane keeps: x[i]
// is then the sum of index off + i.
template <int M, int MEnd, int W, int N>
__device__ __forceinline__ void fold(float (&x)[N], int lane, int& off) {
  if constexpr (M < MEnd) {
    const bool up = lane & M;
    if constexpr (W > 1) {
      constexpr int hw = W / 2;
#pragma unroll
      for (int i = 0; i < hw; ++i) {
        const float send = up ? x[i] : x[i + hw];
        const float keep = up ? x[i + hw] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (up) off += hw;
      fold<2 * M, MEnd, hw, N>(x, lane, off);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], M);
      fold<2 * M, MEnd, 1, N>(x, lane, off);
    }
  }
}

// The gradient's chunk pass: for chunk c >= 1 of (b, h), LG_c[d, e] =
// sum_t p_t[d] r_t[d] go_t[e] over the chunk's steps in order, p_t the
// product of the chunk's decays before step t (the chunk's part of G at
// its entry from a zero exit), to slot (b n_chunks + c) H + h of G (B,
// n_chunks, H, D, D), and W_c, the product of all its decays, to Wg (B,
// n_chunks, H, D).  Grid (B (n_chunks - 1), H); thread x holds a 4 x 4
// tile, rows 4 (x / (D / 4)) and columns 4 (x % (D / 4)) on.
template <typename T, int D>
__global__ void __launch_bounds__(D * D / 16)
    wkv6_backward_glocal_kernel(const T* __restrict__ r,
                                const T* __restrict__ w,
                                const T* __restrict__ go,
                                float* __restrict__ G, float* __restrict__ Wg,
                                int T_len, int H, int ct, int n_chunks) {
  constexpr int NT = D * D / 16, TPR = D / 4;  // threads a row of tiles
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;  // r_t p_t, ct x D
  float* sgo = smem + ct * D;
  float* sw = sgo + ct * D;
  const int h = blockIdx.y;
  const int b = blockIdx.x / (n_chunks - 1);
  const int c = 1 + blockIdx.x % (n_chunks - 1);
  const int t0 = c * ct, n = min(ct, T_len - t0);
  const size_t row = static_cast<size_t>(H) * D;
  const size_t at0 = (static_cast<size_t>(b) * T_len + t0) * row +
                     static_cast<size_t>(h) * D;
  const size_t slot = (static_cast<size_t>(b) * n_chunks + c) * H + h;
  stage_rows<T, D>(r + at0, row, n, sx, NT);
  stage_rows<T, D>(go + at0, row, n, sgo, NT);
  stage_rows<T, D>(w + at0, row, n, sw, NT);
  __syncthreads();
  if (threadIdx.x < D) {
    const int x = threadIdx.x;
    float p = 1.f;
    for (int i = 0; i < n; ++i) {
      sx[i * D + x] *= p;
      p *= sw[i * D + x];
    }
    Wg[slot * D + x] = p;
  }
  __syncthreads();
  const int d0 = 4 * (threadIdx.x / TPR), e0 = 4 * (threadIdx.x % TPR);
  float acc[4][4] = {};
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(sx + i * D + d0);
    const float4 g = *reinterpret_cast<const float4*>(sgo + i * D + e0);
    const float xs[4] = {x.x, x.y, x.z, x.w}, gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[y][z] = fmaf(xs[y], gs[z], acc[y][z]);
  }
#pragma unroll
  for (int y = 0; y < 4; ++y)
    *reinterpret_cast<float4*>(G + slot * D * D +
                               static_cast<size_t>(d0 + y) * D + e0) =
        make_float4(acc[y][0], acc[y][1], acc[y][2], acc[y][3]);
}

// The gradient's scan, one thread per element (b, h, d, e): from g_state
// (zeros when null), for c = n_chunks - 1 down to 1, G <- W_c[d] G + LG_c,
// written over LG_c, so that slot c then holds the gradient at chunk c's
// entry, which is chunk c - 1's exit.  Reads and writes are coalesced.
__global__ void wkv6_backward_gscan_kernel(float* __restrict__ G,
                                           const float* __restrict__ Wg,
                                           const float* __restrict__ g_state,
                                           int B, int H, int D,
                                           int n_chunks) {
  const size_t per_b = static_cast<size_t>(H) * D * D;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * per_b) return;
  const size_t b = i / per_b, hde = i % per_b;
  const size_t per_c = static_cast<size_t>(H) * D;  // stride of c in Wg
  float* Gb = G + b * n_chunks * per_b + hde;
  const float* Wb = Wg + b * n_chunks * per_c + hde / D;
  float x = g_state ? g_state[i] : 0.f;
  // Groups of kAhead chunks: a group's loads are in flight together.
  constexpr int kAhead = 8;
  for (int c0 = n_chunks - 1; c0 >= 1; c0 -= kAhead) {
    float l[kAhead], wc[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = c0 - j;
      l[j] = c >= 1 ? Gb[c * per_b] : 0.f;
      wc[j] = c >= 1 ? Wb[c * per_c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int c = c0 - j;
      if (c >= 1) {
        x = fmaf(wc[j], x, l[j]);
        Gb[c * per_b] = x;
      }
    }
  }
}

// The chunk kernel: chunk c of (b, h), steps [c ct, min((c + 1) ct, T)),
// grid (B n_chunks, H), Par<D>::NT threads laid out as Shape says.  It
// stages the chunk's r, k, v, w and g_out (float32, shared memory), takes
// the state at its entry (state0 or zeros for c = 0, else slot (b n_chunks
// + c - 1) H + h of S_in) and the state gradient at its exit (g_state or
// zeros for the last chunk, else slot (b n_chunks + c + 1) H + h of G_in),
// and:
//   1. walks S over the chunk, keeping the state at every SUB-th step
//      (checkpoints, shared memory, each thread its own elements);
//   2. for each sub-walk of SUB steps from the last: recomputes its states
//      from their checkpoint into registers (dr of each step on the way),
//      then walks back with G in registers: dk, dw and dv's partial over
//      the warp's rows, G <- diag(w) G + r^T go; after a barrier dv sums
//      the warps' partials in order.
// Chunk 0 writes G at its entry as dstate0; each chunk writes its part
// of du (sum over its steps of r k (v . go)) to du_part (B, n_chunks, H,
// D).  dr, dk and dw are gathered in shared memory and written at the
// end, each rounded once.  Every sum runs in a fixed order.
template <typename T, int D>
__global__ void __launch_bounds__(Par<D>::NT, 1)
    wkv6_backward_chunk_kernel(
        const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ state0,
        const T* __restrict__ go, const float* __restrict__ g_state,
        const float* __restrict__ S_in, const float* __restrict__ G_in,
        T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
        T* __restrict__ dw, float* __restrict__ dstate0,
        float* __restrict__ du_part, int T_len, int H, int ct,
        int n_chunks) {
  using P = Par<D>;
  constexpr int R = P::R, E = P::E, SUB = P::SUB;
  constexpr int LPR = P::LPR, NW = P::NW, NT = P::NT;
  constexpr int WR = fold_width(LPR, R);       // dr sums a lane keeps
  constexpr int WKW = fold_width(LPR, 2 * R);  // dk and dw sums
  constexpr int WF = fold_width(P::LG, E);     // dv partials
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int t0 = c * ct, n = min(ct, T_len - t0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane % LPR;
  const int d0 = warp * P::RPW + R * (lane / LPR);
  const int e0 = q * E;
  const size_t DD = static_cast<size_t>(D) * D;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row = static_cast<size_t>(H) * D;  // stride of t
  const size_t at0 = (static_cast<size_t>(b) * T_len + t0) * row +
                     static_cast<size_t>(h) * D;

  float4* ckpt = reinterpret_cast<float4*>(smem);  // [ct/SUB][RE/4][NT]
  float* sr = smem + static_cast<size_t>(ct / SUB) * DD;
  float* sk = sr + ct * D;
  float* sv = sk + ct * D;
  float* sw = sv + ct * D;
  float* sgo = sw + ct * D;
  float* sdr = sgo + ct * D;
  float* sdk = sdr + ct * D;
  float* sdw = sdk + ct * D;
  float* dvp = sdw + ct * D;  // [SUB][NW][D]
  float* svgo = dvp + SUB * NW * D;
  float* sruk = svgo + ct;
  float* su = sruk + ct;

  stage_rows<T, D>(r + at0, row, n, sr, NT);
  stage_rows<T, D>(k + at0, row, n, sk, NT);
  stage_rows<T, D>(v + at0, row, n, sv, NT);
  stage_rows<T, D>(w + at0, row, n, sw, NT);
  stage_rows<T, D>(go + at0, row, n, sgo, NT);
  for (int i = threadIdx.x; i < D; i += NT) su[i] = u[h * D + i];
  __syncthreads();
  // v_t . go_t and sum_d r_t u k_t, one warp a step, a fixed butterfly
  for (int i = warp; i < n; i += NW) {
    float a = 0.f, z = 0.f;
    for (int x = lane; x < D; x += 32) {
      a = fmaf(sv[i * D + x], sgo[i * D + x], a);
      z = fmaf(sr[i * D + x] * su[x], sk[i * D + x], z);
    }
#pragma unroll
    for (int m = 16; m >= 1; m /= 2) {
      a += __shfl_xor_sync(0xffffffffu, a, m);
      z += __shfl_xor_sync(0xffffffffu, z, m);
    }
    if (lane == 0) {
      svgo[i] = a;
      sruk[i] = z;
    }
  }
  __syncthreads();
  if (threadIdx.x < D) {  // du's part: row threadIdx.x, steps in order
    const int x = threadIdx.x;
    float a = 0.f;
    for (int i = 0; i < n; ++i)
      a = fmaf(sr[i * D + x] * sk[i * D + x], svgo[i], a);
    du_part[((static_cast<size_t>(b) * n_chunks + c) * H + h) * D + x] = a;
  }

  float s[R][E], g[R][E];
  {
    const float* S0 =
        c == 0 ? (state0 ? state0 + bh * DD : nullptr)
               : S_in + ((static_cast<size_t>(b) * n_chunks + c - 1) * H + h) *
                            DD;
    const float* G0 =
        c + 1 == n_chunks
            ? (g_state ? g_state + bh * DD : nullptr)
            : G_in + ((static_cast<size_t>(b) * n_chunks + c + 1) * H + h) *
                         DD;
#pragma unroll
    for (int y = 0; y < R; ++y) {
      const size_t at = static_cast<size_t>(d0 + y) * D + e0;
#pragma unroll
      for (int x = 0; x < E; ++x) s[y][x] = g[y][x] = 0.f;
      if (S0) load_n<E>(S0 + at, s[y]);
      if (G0) load_n<E>(G0 + at, g[y]);
    }
  }
  // 1. the checkpoints: the state before steps 0, SUB, 2 SUB, ...
  const int m = (n + SUB - 1) / SUB;
  put_checkpoint<R, E, NT>(ckpt, 0, s);
  for (int j = 1; j < m; ++j) {
    for (int t = (j - 1) * SUB; t < j * SUB; ++t) {
      float vv[E];
      load_n<E>(sv + t * D + e0, vv);
#pragma unroll
      for (int y = 0; y < R; ++y) {
        const float wd = sw[t * D + d0 + y], kd = sk[t * D + d0 + y];
#pragma unroll
        for (int x = 0; x < E; ++x) s[y][x] = fmaf(wd, s[y][x], kd * vv[x]);
      }
    }
    put_checkpoint<R, E, NT>(ckpt, j, s);
  }

  // 2. the sub-walks, from the last
  for (int j = m - 1; j >= 0; --j) {
    const int s0 = j * SUB, len = min(SUB, n - s0);
    float hs[SUB][R][E];  // S_{t-1} of the sub-walk's steps
    get_checkpoint<R, E, NT>(ckpt, j, hs[0]);
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      if (i < len) {
        const int t = s0 + i;
        float gv[E], vv[E], a[R];
        load_n<E>(sgo + t * D + e0, gv);
        load_n<E>(sv + t * D + e0, vv);
#pragma unroll
        for (int y = 0; y < R; ++y) {
          a[y] = 0.f;
#pragma unroll
          for (int x = 0; x < E; ++x) a[y] = fmaf(hs[i][y][x], gv[x], a[y]);
        }
        int off = 0;
        fold<1, LPR, R, R>(a, lane, off);
        if (q < R) {  // past R, the row group's lanes hold copies
#pragma unroll
          for (int z = 0; z < WR; ++z) {
            const int dd = d0 + off + z;
            sdr[t * D + dd] = fmaf(su[dd] * svgo[t], sk[t * D + dd], a[z]);
          }
        }
        if (i + 1 < len) {  // the next step's state (i + 1 < SUB)
          constexpr int kLast = SUB - 1;
#pragma unroll
          for (int y = 0; y < R; ++y) {
            const float wd = sw[t * D + d0 + y], kd = sk[t * D + d0 + y];
#pragma unroll
            for (int x = 0; x < E; ++x)
              hs[i < kLast ? i + 1 : kLast][y][x] =
                  fmaf(wd, hs[i][y][x], kd * vv[x]);
          }
        }
      }
    }
#pragma unroll
    for (int i = SUB - 1; i >= 0; --i) {
      if (i < len) {
        const int t = s0 + i;
        float gv[E], vv[E], col[E], kw[2 * R];
        load_n<E>(sgo + t * D + e0, gv);
        load_n<E>(sv + t * D + e0, vv);
#pragma unroll
        for (int x = 0; x < E; ++x) col[x] = 0.f;
#pragma unroll
        for (int y = 0; y < R; ++y) {
          const float rd = sr[t * D + d0 + y], kd = sk[t * D + d0 + y];
          const float wd = sw[t * D + d0 + y];
          float ak = 0.f, aw = 0.f;
#pragma unroll
          for (int x = 0; x < E; ++x) {
            ak = fmaf(g[y][x], vv[x], ak);
            aw = fmaf(g[y][x], hs[i][y][x], aw);
            col[x] = fmaf(g[y][x], kd, col[x]);
            g[y][x] = fmaf(wd, g[y][x], rd * gv[x]);
          }
          kw[y] = ak;
          kw[R + y] = aw;
        }
        int off = 0;
        fold<1, LPR, 2 * R, 2 * R>(kw, lane, off);
        if (q < 2 * R) {
#pragma unroll
          for (int z = 0; z < WKW; ++z) {
            const int at = off + z;  // dk of row d0 + at, or dw of row
            if (at < R) {            // d0 + at - R
              const int dd = d0 + at;
              sdk[t * D + dd] =
                  fmaf(su[dd] * svgo[t], sr[t * D + dd], kw[z]);
            } else {
              sdw[t * D + d0 + at - R] = kw[z];
            }
          }
        }
        int cof = 0;
        fold<LPR, 32, E, E>(col, lane, cof);
        if (lane < D) {  // past D, the warp's row groups hold copies
#pragma unroll
          for (int z = 0; z < WF; ++z)
            dvp[(i * NW + warp) * D + e0 + cof + z] = col[z];
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < len * D; idx += NT) {
      const int i = idx / D, e = idx % D, t = s0 + i;
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < NW; ++p) acc += dvp[(i * NW + p) * D + e];
      dv[at0 + static_cast<size_t>(t) * row + e] =
          from_float<T>(fmaf(sgo[t * D + e], sruk[t], acc));
    }
    __syncthreads();  // dvp is the next sub-walk's
  }

  if (c == 0) {
#pragma unroll
    for (int y = 0; y < R; ++y) {
      float4* o = reinterpret_cast<float4*>(
          dstate0 + bh * DD + static_cast<size_t>(d0 + y) * D + e0);
#pragma unroll
      for (int p = 0; p < E / 4; ++p)
        o[p] = make_float4(g[y][4 * p], g[y][4 * p + 1], g[y][4 * p + 2],
                           g[y][4 * p + 3]);
    }
  }
  for (int i = threadIdx.x; i < n * (D / 4); i += NT) {
    const int t = i / (D / 4), col = (i % (D / 4)) * 4;
    const size_t o = at0 + static_cast<size_t>(t) * row + col;
    repro::store4(dr + o, *reinterpret_cast<const float4*>(sdr + t * D + col));
    repro::store4(dk + o, *reinterpret_cast<const float4*>(sdk + t * D + col));
    repro::store4(dw + o, *reinterpret_cast<const float4*>(sdw + t * D + col));
  }
}

// Raises kernel's dynamic shared memory limit to `bytes` where it is
// below; false where the card refuses.
template <typename K>
bool allow_smem(K kernel, size_t bytes, int& allowed) {
  if (bytes <= 48 * 1024 || static_cast<int>(bytes) <= allowed) return true;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess)
    return false;
  allowed = static_cast<int>(bytes);
  return true;
}

template <typename T, int D>
int launch_parallel(const void* r, const void* k, const void* v,
                    const void* w, const float* u, const float* s0,
                    const void* go, const float* gs, const float* S_in,
                    void* dr, void* dk, void* dv, void* dw, float* du,
                    float* ds0, float* du_part, float* G, float* Wg, int B,
                    int T_len, int H, int ct, cudaStream_t st) {
  static int chunk_allowed = 0, glocal_allowed = 0;
  const int n_chunks = (T_len + ct - 1) / ct;
  const T* rt = static_cast<const T*>(r);
  const T* wt = static_cast<const T*>(w);
  const T* got = static_cast<const T*>(go);
  if (n_chunks > 1) {
    const size_t g_bytes = 3 * sizeof(float) * ct * D;
    if (!allow_smem(wkv6_backward_glocal_kernel<T, D>, g_bytes,
                    glocal_allowed))
      return static_cast<int>(cudaErrorInvalidValue);
    wkv6_backward_glocal_kernel<T, D>
        <<<dim3(B * (n_chunks - 1), H), D * D / 16, g_bytes, st>>>(
            rt, wt, got, G, Wg, T_len, H, ct, n_chunks);
    const size_t n = static_cast<size_t>(B) * H * D * D;
    wkv6_backward_gscan_kernel<<<static_cast<unsigned>((n + 255) / 256), 256,
                                 0, st>>>(G, Wg, gs, B, H, D, n_chunks);
  }
  const size_t bytes = chunk_smem_bytes<D>(ct);
  if (!allow_smem(wkv6_backward_chunk_kernel<T, D>, bytes, chunk_allowed))
    return static_cast<int>(cudaErrorInvalidValue);
  wkv6_backward_chunk_kernel<T, D>
      <<<dim3(B * n_chunks, H), Par<D>::NT, bytes, st>>>(
          rt, static_cast<const T*>(k), static_cast<const T*>(v), wt, u, s0,
          got, gs, S_in, G, static_cast<T*>(dr), static_cast<T*>(dk),
          static_cast<T*>(dv), static_cast<T*>(dw), ds0, du_part, T_len, H,
          ct, n_chunks);
  const int HD = H * D;
  wkv6_backward_du_kernel<<<(HD + 255) / 256, 256, 0, st>>>(
      du_part, du, B * n_chunks, HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_parallel(int D, const void* r, const void* k, const void* v,
                      const void* w, const float* u, const float* s0,
                      const void* go, const float* gs, const float* S_in,
                      void* dr, void* dk, void* dv, void* dw, float* du,
                      float* ds0, float* du_part, float* G, float* Wg, int B,
                      int T_len, int H, int ct, cudaStream_t st) {
  switch (D) {
    case 16: return launch_parallel<T, 16>(r, k, v, w, u, s0, go, gs, S_in, dr, dk, dv, dw, du, ds0, du_part, G, Wg, B, T_len, H, ct, st);
    case 32: return launch_parallel<T, 32>(r, k, v, w, u, s0, go, gs, S_in, dr, dk, dv, dw, du, ds0, du_part, G, Wg, B, T_len, H, ct, st);
    case 64: return launch_parallel<T, 64>(r, k, v, w, u, s0, go, gs, S_in, dr, dk, dv, dw, du, ds0, du_part, G, Wg, B, T_len, H, ct, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The chunk kernel's shared memory at head size D, 0 for another D.
size_t parallel_smem_bytes(int D, int ct) {
  switch (D) {
    case 16: return chunk_smem_bytes<16>(ct);
    case 32: return chunk_smem_bytes<32>(ct);
    case 64: return chunk_smem_bytes<64>(ct);
  }
  return 0;
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

// The parallel route, D 16, 32 or 64: arguments as repro_wkv6_backward's,
// with chunks of ct steps (a multiple of 8, the chunk kernel's shared
// memory within the card's 227 KB: ct <= 48 at D 64).  entry: the scratch
// L of repro_wkv6_chunk_states run at the same ct, null when n_chunks =
// cdiv(T, ct) is 1.  Scratch, float32, none aliasing another argument:
// du_part (B, n_chunks, H, D), G (B, n_chunks, H, D, D), Wg (B, n_chunks,
// H, D).  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for another dtype or D, B, T or H < 1, such a ct,
// or a missing entry.
extern "C" int repro_wkv6_backward_parallel(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* state0, const void* g_out, const void* g_state,
    const void* entry, void* dr, void* dk, void* dv, void* dw, void* du,
    void* dstate0, void* du_part, void* G, void* Wg, int B, int T_len, int H,
    int D, int ct, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || ct < 8 || ct % 8 ||
      (dtype != 0 && dtype != 1) || (T_len > ct && entry == nullptr) ||
      parallel_smem_bytes(D, ct) == 0 ||
      parallel_smem_bytes(D, ct) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  const float* gs = static_cast<const float*>(g_state);
  const float* en = static_cast<const float*>(entry);
  float* duf = static_cast<float*>(du);
  float* ds0 = static_cast<float*>(dstate0);
  float* dup = static_cast<float*>(du_part);
  float* Gf = static_cast<float*>(G);
  float* Wf = static_cast<float*>(Wg);
  if (dtype == 0)
    return dispatch_parallel<float>(D, r, k, v, w, uf, s0, g_out, gs, en, dr,
                                    dk, dv, dw, duf, ds0, dup, Gf, Wf, B,
                                    T_len, H, ct, st);
  return dispatch_parallel<__nv_bfloat16>(D, r, k, v, w, uf, s0, g_out, gs,
                                          en, dr, dk, dv, dw, duf, ds0, dup,
                                          Gf, Wf, B, T_len, H, ct, st);
}
