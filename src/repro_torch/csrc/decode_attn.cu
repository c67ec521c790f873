// GQA flash-decode attention for Hopper (sm_90a): one new token per batch
// row against a KV cache of S positions, of which the first lengths[b]
// are valid.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/kernel.py
// (_decode_kernel, launched by decode_attn_pallas).  Same function:
// scale 1/sqrt(D), positions >= length masked out, online softmax in
// float32, denominator clamped at 1e-30, output in q's dtype.  A row of
// length 0 has every logit masked, so the reference's softmax is uniform
// over all S rows: it gets the mean of its V over S, summed in float32
// and rounded once, as decode_attn_ref gives it.
//
// Bound on the card: memory.  The K and V rows a call must read are
// sum_b 2 * Hkv * len_b * D * sizeof(T) bytes, read once; the arithmetic
// is 4 * G flops per cached element, far below the H100's ~295 flops/byte
// ridge.  On both routes:
//   * The G query heads that share one KV head (G = H / Hkv) are served
//     by the same pass over K/V, so K/V are read once per KV head, not
//     once per query head.  Rows at or past len_b are never read.
//   * At decode shapes B * Hkv is a few dozen (batch, kv-head) pairs
//     against 132 SMs, so the S axis is split across blocks (the TPU ran
//     it as a sequential grid axis).  Each split writes a partial (max,
//     denominator, sum) in float32, merged in split order: by a second
//     small kernel (decode_merge_kernel) on the tensor-core route and the
//     any-D SIMT kernel, and inside the same launch by the last split
//     block of each group on the SIMT vector kernel (below).
//   * Any group G is taken.  A block serves one tile of GT query heads,
//     GT the smallest instantiated tile (1, 2, 4, 8; 16 on the tensor
//     cores) that holds G, or the largest; a grid axis runs over the
//     cdiv(G, GT) tiles of a KV head, the last one padded (its heads past
//     G have zero q and are not written).  K/V are read once per tile.
//
// Two routes, chosen by the wrapper from dtype, D, G and the pointers'
// alignment (kernels/decode_attn/kernel.py: route), one C entry point
// each, each with its own split plan:
//
// repro_decode_attn_tc, the tensor-core route: bfloat16, D 16/32/64/128,
// any G, 16-byte aligned q/k/v (the serving path's llama3.2-1b decode:
// D 64, G 4).  FlashAttention-2 on mma.sync.m16n8k16 (bf16 in, float32
// accumulate), with a tile's query heads as the rows of an m16 tile
// (rows past the tile's heads zero; a thread keeps the softmax state of
// row g and, for a tile of 16, of row g + 8):
//   * A block of 4 warps takes 64 keys a step; warp w takes keys
//     16 w .. 16 w + 15 and streams them, K and V, through its own ring
//     of 4 shared-memory stages by 16-byte cp.async copies (rows past
//     len_b zero-filled, not read), so three steps are in flight while
//     one is computed, and the warps need no barrier until the end.
//     Rows are padded to 2 D + 16 bytes, so ldmatrix hits distinct banks.
//   * S = Q.K^T with K by ldmatrix; the scores go through the online
//     softmax in float32 registers; P is packed to bf16 as the A fragment
//     of O += P.V, with V by ldmatrix.trans.  The denominator sums the
//     float32 P.  The 4 warps merge their (max, denominator, sum) through
//     shared memory once per block.
//   * Splits are whole numbers of 64-key steps, at least 256 rows each
//     (split_plan_tc), so each block's ring reaches its steady state.
//
// repro_decode_attn, the SIMT route: float32 (tensor cores would mean
// TF32, which breaks the 2e-4 float32 tolerance), and every other call
// the wrapper accepts.
//   * K/V rows stream from global memory once, each thread pulling one
//     16-byte vector per row; the positions of a warp are adjacent, so
//     every load is a full, coalesced 128-byte line.
//   * Each thread group keeps kKeys rows in flight per step and rescales
//     its running sums once per step rather than once per row; the
//     groups of a block merge through shared memory.
//   * One launch (decode_split_kernel).  At the kernel path's float32 row
//     (B 2, 2 KV heads, G 4, S 512, D 64: 0.84 MB of K/V for lengths 512
//     and 300, 0.25 us at the HBM rate) the two launches of split and
//     merge, and the partials' round trip between them, were the 8.7 us
//     the call took.  Now a group (b, KV head, tile) with one split
//     writes its output from the block; with more, each split block
//     writes its partial, fences it and draws a ticket of its group
//     (atomicAdd on a counter the wrapper keeps zeroed, one buffer per
//     device and stream), and the block that draws the last ticket reads
//     the group's partials back through L2, merges them in split order
//     (so a rerun is bit-equal, whichever block ended last) and sets the
//     counter back to 0.  A row of length 0 has no split with rows, so
//     split 0 writes its mean of V.  In float32 a split is at least two
//     trips (64 rows at D 64; kernel.py: split_plan): the row's 512
//     positions are 8 splits, not 16 of one trip each.
//   * That kernel is instantiated for D 16, 32, 64 and 128.  Every other
//     head_dim D >= 1 runs on decode_split_any_kernel: a warp takes one
//     row at a time, its lanes striding over D for the score (the tail
//     masked), and keeps a tile of kAnyDT columns of the running sum in
//     registers; D past one tile takes further passes over the rows,
//     each recomputing the scores.  Same splits, partials and merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // threads of a split block
constexpr int kKeys = 4;       // rows a thread group scores at once
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

// The smallest instantiated tile of query heads, up to max_tile, that
// holds a group of G (the largest when none does).
__host__ __device__ constexpr int group_tile(int G, int max_tile) {
  int t = 1;
  while (t < G && t < max_tile) t *= 2;
  return t;
}

// Each of the G heads of KV head bh = b * Hkv + h (those from g0, gn of
// them) gets the mean of the head's V over all S rows, summed in float32
// (neighbouring threads take neighbouring d): a row of length 0, whose
// logits are all masked, so the reference's softmax is uniform.
template <typename T>
__device__ void mean_of_v(const T* __restrict__ v, T* __restrict__ out,
                          size_t bh, int G, int g0, int gn, int D, int S) {
  const T* vb = v + bh * S * D;
  for (int t = threadIdx.x; t < gn * D; t += blockDim.x) {
    const int d = t % D;
    float sum = 0.f;
    for (int s = 0; s < S; ++s)
      sum += repro::to_float(vb[static_cast<size_t>(s) * D + d]);
    out[(bh * G + g0) * D + t] = Vec<T>::store(sum / S);
  }
}

// The merge of one (b, KV head, tile) group's `used` split partials
// (part0: the group's first split; heads g0 .. g0 + gn - 1 of G): for
// each head and d, the partials of splits 0 .. used - 1 in that order,
// whatever order their blocks ended in, so a rerun is bit-equal.  The
// partials were written by other blocks of the same launch: read through
// L2 (ld.cg), kMergeBatch splits' loads in flight at a time, each batch
// folded into the running (max, denominator, sum) after its loads land
// (one round trip for up to kMergeBatch splits).
constexpr int kMergeBatch = 8;

template <typename T>
__device__ void merge_splits(const float* part_m, const float* part_l,
                             const float* part_acc, T* __restrict__ out,
                             size_t part0, size_t out0, int used, int G,
                             int g0, int gn, int D) {
  for (int t = threadIdx.x; t < gn * D; t += blockDim.x) {
    const int g = g0 + t / D, d = t % D;
    float mx = kNeg, tot = 0.f, o = 0.f;
    for (int s0 = 0; s0 < used; s0 += kMergeBatch) {
      float pm[kMergeBatch], pl[kMergeBatch], pa[kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const size_t p = (part0 + s0 + i) * G + g;
        const bool in = s0 + i < used;
        pm[i] = in ? __ldcg(part_m + p) : kNeg;
        pl[i] = in ? __ldcg(part_l + p) : 0.f;
        pa[i] = in ? __ldcg(part_acc + p * D + d) : 0.f;
      }
      float bm = mx;
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) bm = fmaxf(bm, pm[i]);
      const float sc = exp2f(mx - bm);
      tot *= sc;
      o *= sc;
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        if (s0 + i < used) {
          const float w = exp2f(pm[i] - bm);
          tot += pl[i] * w;
          o += pa[i] * w;
        }
      }
      mx = bm;
    }
    out[out0 + t] = Vec<T>::store(o / fmaxf(tot, 1e-30f));
  }
}

// grid (splits, Hkv * tiles, B), one launch: the splits and their merge.
// Block (split, h * tiles + tile, b) covers cache positions [split *
// chunk, min((split + 1) * chunk, len_b)) for query heads tile * GT ..
// tile * GT + GT - 1 of KV head h (those below G); the splits that hold
// rows are 0 .. used - 1, used = min(splits, ceil(len_b / chunk)).
// Threads form groups of TPK = D / VEC; a group reads one row with one
// vector load per thread, kKeys rows a trip.  Scores are kept in base 2
// (q is pre-scaled by scale * log2(e)).  A group with one split writes
// its output directly.  With more, each split block writes its partial
// (max, denominator, sum), fences it (__threadfence) and takes a ticket
// of its group (tickets[blockIdx.z * gridDim.y + blockIdx.y],
// atomicAdd); the block that draws the last ticket merges the group's
// partials (merge_splits) and sets the ticket back to 0, so the buffer
// is all zeros between launches.  A row of length 0 has no split with
// rows: split 0 writes the mean of V (mean_of_v).
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* part_m, float* part_l, float* part_acc,
                        unsigned* __restrict__ tickets, int Hkv, int G,
                        int tiles, int S, int chunk, float scale_log2) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPK = D / VEC;
  constexpr int NG = kThreads / TPK;
  static_assert(D % VEC == 0 && TPK <= 32 && 32 % TPK == 0, "bad D");

  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / tiles, g0 = (blockIdx.y % tiles) * GT;
  const int gn = min(GT, G - g0);  // the tile's heads below G
  const int len = min(max(lengths[b], 0), S);
  const int used = min(static_cast<int>(gridDim.x), (len + chunk - 1) / chunk);
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  if (used == 0) {
    if (split == 0) mean_of_v(v, out, bh, G, g0, gn, D, S);
    return;
  }
  const int start = split * chunk;
  if (start >= len) return;  // no rows: not one of the group's used splits
  const int end = min(start + chunk, len);

  const int grp = threadIdx.x / TPK;
  const int lane = threadIdx.x % TPK;
  const int d0 = lane * VEC;
  const T* kb = k + bh * S * D + d0;
  const T* vb = v + bh * S * D + d0;

  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gn) {
      Vec<T>::load(q + (bh * G + g0 + g) * D + d0, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[g][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) qr[g][i] *= scale_log2;
  }

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
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
    float s[kKeys][GT];
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
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
    for (int g = 0; g < GT; ++g) {
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
  __shared__ float sm_m[NG][GT];
  __shared__ float sm_l[NG][GT];
  __shared__ float sm_acc[NG][GT][D];
  __shared__ float sm_tot[GT];
  __shared__ bool sm_last;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mx = kNeg;
    for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j][g]);
    const float sc = exp2f(m[g] - mx);
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[grp][g][d0 + i] = acc[g][i] * sc;
  }
  // Partials of head g0 + g of this split: (B, Hkv, splits, G) order.
  const size_t part0 = bh * gridDim.x;
  const size_t part = (part0 + split) * G + g0;
  if (threadIdx.x < gn) {
    const int g = threadIdx.x;
    float mx = kNeg;
    for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j][g]);
    float tot = 0.f;
    for (int j = 0; j < NG; ++j) tot += sm_l[j][g] * exp2f(sm_m[j][g] - mx);
    sm_tot[g] = tot;
    if (used > 1) {
      part_m[part + g] = mx;
      part_l[part + g] = tot;
    }
  }
  __syncthreads();
  // One split: the output itself (what merging one partial gives: its
  // weight exp2(m - m) is 1).
  const size_t out0 = (bh * G + g0) * D;
  for (int t = threadIdx.x; t < gn * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float sum = 0.f;
    for (int j = 0; j < NG; ++j) sum += sm_acc[j][g][d];
    if (used == 1)
      out[out0 + t] = Vec<T>::store(sum / fmaxf(sm_tot[g], 1e-30f));
    else
      part_acc[(part + g) * D + d] = sum;
  }
  if (used == 1) return;

  // The partial is out: once every thread's stores are, one thread
  // fences them at the device's scope (cumulative over the barrier) and
  // draws the group's ticket.
  __syncthreads();
  unsigned* ticket = tickets + static_cast<size_t>(b) * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) {
    __threadfence();
    sm_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(used - 1);
    if (sm_last) __threadfence();
  }
  __syncthreads();
  if (!sm_last) return;
  merge_splits(part_m, part_l, part_acc, out, part0, out0, used, G, g0, gn,
               D);
  if (threadIdx.x == 0) *ticket = 0u;
}

// grid (B * Hkv).  Merges the splits that hold rows: the second launch of
// the tensor-core route and of the any-D SIMT kernel (the vector SIMT
// kernel merges in its own launch).  A row of length 0 has none: every
// logit is masked, the reference's softmax is uniform, and each of its G
// heads gets the mean of the KV head's V over all S rows, summed in
// float32 (coalesced: neighbouring threads take neighbouring d).
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    const int* __restrict__ lengths,
                                    const T* __restrict__ v,
                                    T* __restrict__ out, int Hkv, int G, int D,
                                    int S, int splits, int chunk) {
  const int bh = blockIdx.x;
  const int len = min(max(lengths[bh / Hkv], 0), S);
  const int used = min(splits, (len + chunk - 1) / chunk);
  const size_t part0 = static_cast<size_t>(bh) * splits;
  if (used == 0) {
    mean_of_v(v, out, bh, G, 0, G, D, S);
    return;
  }
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

namespace tc {

using bf16 = __nv_bfloat16;
using repro::hopper::cp_async16;
using repro::hopper::cp_async_commit;
using repro::hopper::cp_async_wait;
using repro::hopper::ldmatrix_x4;
using repro::hopper::ldmatrix_x4_trans;
using repro::hopper::mma_bf16;
using repro::hopper::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;              // keys a warp takes from each tile
constexpr int TILE = kWarps * kRows;   // keys a block takes per step: 64
constexpr int STAGES = 4;

// Bytes of one staged K or V row: D bf16 and 16 bytes of padding, so that
// the 8 row addresses of an ldmatrix fall on 8 distinct bank groups.
__host__ __device__ constexpr int row_bytes(int D) { return 2 * D + 16; }
// Dynamic shared memory of a block: each warp's own ring of STAGES stages
// of kRows K rows and kRows V rows.
__host__ __device__ constexpr int smem_bytes(int D) {
  return kWarps * STAGES * 2 * kRows * row_bytes(D);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// grid (splits, Hkv * tiles, B), kThreads threads.  Block (split,
// h * tiles + tile, b) covers cache positions [split * chunk, min((split +
// 1) * chunk, len_b)) in steps of TILE keys for query heads tile * GT ..
// tile * GT + GT - 1 of KV head h (those below G); warp w takes keys
// 16 w .. 16 w + 15 of every step, streams them through its own cp.async
// ring and keeps its own online softmax state, and the 4 warps merge once
// at the end.  The tile's heads are the rows of an m16 mma tile, rows past
// them zero; a thread holds rows g and, when GT is 16, g + 8 (NR rows).
// Scores are kept in base 2 (scaled by scale * log2(e) after the product).
template <int D, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_split_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int* __restrict__ lengths,
                           float* __restrict__ part_m,
                           float* __restrict__ part_l,
                           float* __restrict__ part_acc, int Hkv, int G,
                           int tiles, int S, int chunk, float scale_log2) {
  constexpr int RB = row_bytes(D);
  constexpr int CPR = 2 * D / 16;            // 16-byte pieces a row
  constexpr int WSTAGE = 2 * kRows * RB;     // one warp's K and V rows
  constexpr int KS = D / 16;                 // k16 steps of Q.K^T
  constexpr int NT = D / 8;                  // n8 tiles of the output
  constexpr int NR = GT > 8 ? 2 : 1;         // fragment rows a thread holds
  static_assert(GT <= 16, "one m16 tile");
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sm_m[kWarps][GT], sm_l[kWarps][GT];
  __shared__ float sm_o[kWarps][GT][D];

  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / tiles, g0 = (blockIdx.y % tiles) * GT;
  const int gn = min(GT, G - g0);  // the tile's heads below G
  const int len = min(max(lengths[b], 0), S);
  const int start = split * chunk;
  if (start >= len) return;  // the merge reads only splits that hold rows
  const int end = min(start + chunk, len);
  const int n_tiles = (end - start + TILE - 1) / TILE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q4 = lane % 4;  // the thread's fragment rows g
                                          // (+ 8), its column pair
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  const bf16* kb = k + bh * S * D;
  const bf16* vb = v + bh * S * D;
  const uint32_t ring = smem_u32(smem) + warp * STAGES * WSTAGE;

  // Copies this warp's rows of step t into stage t % STAGES; rows at or
  // past end are zero-filled and never read.  Always commits a group, so
  // that the group count stays one a step.
  auto load = [&](int t) {
    if (t < n_tiles) {
      const uint32_t sk = ring + (t % STAGES) * WSTAGE, sv = sk + kRows * RB;
      const int r0 = start + t * TILE + warp * kRows;
#pragma unroll
      for (int it = 0; it < kRows * CPR / 32; ++it) {
        const int i = lane + 32 * it, r = i / CPR, c = i % CPR;
        const bool in = r0 + r < end;
        const size_t off = static_cast<size_t>(r0 + r) * D + 8 * c;
        cp_async16(sk + r * RB + 16 * c, in ? kb + off : kb, in ? 16 : 0);
        cp_async16(sv + r * RB + 16 * c, in ? vb + off : vb, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // Q as the A fragment of m16n8k16: per k16 step the registers a0..a3 of
  // rows g, g + 8, g, g + 8 at columns 2 q4 (+1), 2 q4 (+1), 8 + 2 q4 (+1),
  // 8 + 2 q4 (+1); rows past the tile's heads are zero.
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = g + 8 * hr;
      qa[s][hr] = qa[s][2 + hr] = 0u;
      if (hr < NR && row < gn) {
        const bf16* qp = q + (bh * G + g0 + row) * D + 16 * s + 2 * q4;
        qa[s][hr] = *reinterpret_cast<const uint32_t*>(qp);
        qa[s][2 + hr] = *reinterpret_cast<const uint32_t*>(qp + 8);
      }
    }
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[NR], l_run[NR];
#pragma unroll
  for (int hr = 0; hr < NR; ++hr) {
    m_run[hr] = kNeg;
    l_run[hr] = 0.f;
  }

  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8.  For
  // K (B of Q.K^T, n = key, k = d) the matrices are (keys 0-7 | 8-15) x
  // (d 0-7 | 8-15), d first; for V (B of P.V by .trans, k = key, n = d)
  // (keys 0-7 | 8-15) x (d 0-7 | 8-15), keys first.
  const int k_row = lane % 8 + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
  const int v_row = lane % 8 + 8 * ((lane / 8) % 2), v_col = 8 * (lane / 16);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // step t has landed for every lane; all are past t - 1
    load(t + STAGES - 1);
    const uint32_t sk = ring + (t % STAGES) * WSTAGE, sv = sk + kRows * RB;

    // Scores of the warp's 16 keys: two n8 tiles, keys 8 nt + 2 q4 (+1).
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sk + k_row * RB + (16 * s + k_col) * 2);
      mma_bf16(sc[0], qa[s], kf[0], kf[1]);
      mma_bf16(sc[1], qa[s], kf[2], kf[3]);
    }

    // Online softmax of rows g (the thread's c0, c1) and, when NR is 2,
    // g + 8 (c2, c3); the rows of a tile of 8 or fewer end at 7.
    const int key0 = start + t * TILE + warp * kRows + 2 * q4;
    float p[2][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (hr >= NR) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) p[nt][2 * hr] = p[nt][2 * hr + 1] = 0.f;
        continue;
      }
      float mx = kNeg;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][2 * hr + e] *= scale_log2;
          if (key0 + 8 * nt + e < end) mx = fmaxf(mx, sc[nt][2 * hr + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      const float corr = exp2f(m_run[hr] - m_new);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p[nt][2 * hr + e] = key0 + 8 * nt + e < end
                                  ? exp2f(sc[nt][2 * hr + e] - m_new)
                                  : 0.f;
      l_run[hr] = l_run[hr] * corr + (p[0][2 * hr] + p[0][2 * hr + 1]) +
                  (p[1][2 * hr] + p[1][2 * hr + 1]);
      m_run[hr] = m_new;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * hr] *= corr;
        o[j][2 * hr + 1] *= corr;
      }
    }

    // O += P V: P (rows g, g + 8; keys) in bf16 as the A fragment.
    const uint32_t pa[4] = {
        pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
        pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sv + v_row * RB + (16 * dt + v_col) * 2);
      mma_bf16(o[2 * dt], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dt + 1], pa, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();

  // Merge the 4 warps: each row's denominator is spread over its quad.
#pragma unroll
  for (int hr = 0; hr < NR; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
    const int row = g + 8 * hr;
    if (row < gn) {
      if (q4 == 0) {
        sm_m[warp][row] = m_run[hr];
        sm_l[warp][row] = l_run[hr];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sm_o[warp][row][8 * j + 2 * q4] = o[j][2 * hr];
        sm_o[warp][row][8 * j + 2 * q4 + 1] = o[j][2 * hr + 1];
      }
    }
  }
  __syncthreads();
  // Partials of head g0 + gg of this split: (B, Hkv, splits, G) order.
  const size_t part = (bh * gridDim.x + split) * G + g0;
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int gg = i / D, d = i % D;
    float mxw = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mxw = fmaxf(mxw, sm_m[w][gg]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += sm_o[w][gg][d] * exp2f(sm_m[w][gg] - mxw);
    part_acc[(part + gg) * D + d] = sum;
  }
  if (threadIdx.x < gn) {
    const int gg = threadIdx.x;
    float mxw = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mxw = fmaxf(mxw, sm_m[w][gg]);
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      tot += sm_l[w][gg] * exp2f(sm_m[w][gg] - mxw);
    part_m[part + gg] = mxw;
    part_l[part + gg] = tot;
  }
}

template <int D, int GT>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_m, float* part_l, float* part_acc, int B,
           int Hkv, int G, int S, int splits, int chunk, float scale,
           cudaStream_t stream) {
  auto kernel = decode_split_tc_kernel<D, GT>;
  constexpr int smem = smem_bytes(D);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (G + GT - 1) / GT;
  kernel<<<dim3(splits, Hkv * tiles, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, part_m, part_l, part_acc, Hkv, G,
      tiles, S, chunk, scale * kLog2e);
  const int threads = G * D < 256 ? G * D : 256;
  decode_merge_kernel<bf16><<<B * Hkv, threads, 0, stream>>>(
      part_m, part_l, part_acc, lengths, static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Hkv, G, D, S, splits, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int* lengths, void* out, float* pm, float* pl, float* pa,
               int B, int Hkv, int S, int splits, int chunk, float scale,
               cudaStream_t st) {
  switch (group_tile(G, 16)) {
    case 1: return launch<D, 1>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, splits, chunk, scale, st);
    case 2: return launch<D, 2>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, splits, chunk, scale, st);
    case 4: return launch<D, 4>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, splits, chunk, scale, st);
    case 8: return launch<D, 8>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, splits, chunk, scale, st);
    case 16: return launch<D, 16>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, splits, chunk, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_d(int D, int G, const void* q, const void* k, const void* v,
               const int* lengths, void* out, float* pm, float* pl, float* pa,
               int B, int Hkv, int S, int splits, int chunk, float scale,
               cudaStream_t st) {
  switch (D) {
    case 16: return dispatch_g<16>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
    case 32: return dispatch_g<32>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
    case 64: return dispatch_g<64>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
    case 128: return dispatch_g<128>(G, q, k, v, lengths, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

template <typename T, int D, int GT>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, float* part_m, float* part_l, float* part_acc,
            unsigned* tickets, int B, int Hkv, int G, int S, int splits,
            int chunk, float scale, cudaStream_t stream) {
  const int tiles = (G + GT - 1) / GT;
  decode_split_kernel<T, D, GT>
      <<<dim3(splits, Hkv * tiles, B), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, static_cast<T*>(out), part_m,
          part_l, part_acc, tickets, Hkv, G, tiles, S, chunk, scale * kLog2e);
}

template <typename T, int D>
bool dispatch_g(int G, const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* pm, float* pl,
                float* pa, unsigned* tk, int B, int Hkv, int S, int splits,
                int chunk, float scale, cudaStream_t st) {
  switch (group_tile(G, 8)) {
    case 1: launch<T, D, 1>(q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, G, S, splits, chunk, scale, st); return true;
    case 2: launch<T, D, 2>(q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, G, S, splits, chunk, scale, st); return true;
    case 4: launch<T, D, 4>(q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, G, S, splits, chunk, scale, st); return true;
    case 8: launch<T, D, 8>(q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, G, S, splits, chunk, scale, st); return true;
  }
  return false;
}

template <typename T>
bool dispatch_d(int D, int G, const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* pm, float* pl,
                float* pa, unsigned* tk, int B, int Hkv, int S, int splits,
                int chunk, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, S, splits, chunk, scale, st);
    case 32: return dispatch_g<T, 32>(G, q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, S, splits, chunk, scale, st);
    case 64: return dispatch_g<T, 64>(G, q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, S, splits, chunk, scale, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, lengths, out, pm, pl, pa, tk, B, Hkv, S, splits, chunk, scale, st);
  }
  return false;
}

// The SIMT route at any head_dim D >= 1 (a runtime value).  grid and
// block as decode_split_kernel; warp w of the block takes rows start + w,
// start + w + kAnyWarps, ... of its split, one at a time.  For a row the
// lanes stride over D for the G dot products (q and the row read by
// scalar loads, the tail of D masked), reduce them by shuffles, and update
// the online softmax state in base 2.  A lane keeps kAnyR columns d =
// d0 + lane + 32 i of the running sum in registers, a tile of kAnyDT =
// 32 kAnyR columns; for D > kAnyDT the block makes one pass over its rows
// per tile, each recomputing the scores (same values, so the partial max
// and denominator are written by the first pass).  The warps merge
// through shared memory after each pass, as the groups of
// decode_split_kernel do.
constexpr int kAnyWarps = kThreads / 32;
constexpr int kAnyR = 8;
constexpr int kAnyDT = 32 * kAnyR;

template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_split_any_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            float* __restrict__ part_m,
                            float* __restrict__ part_l,
                            float* __restrict__ part_acc, int Hkv, int G,
                            int tiles, int S, int D, int chunk,
                            float scale_log2) {
  using repro::to_float;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / tiles, g0 = (blockIdx.y % tiles) * GT;
  const int gn = min(GT, G - g0);
  const int len = min(max(lengths[b], 0), S);
  const int start = split * chunk;
  if (start >= len) return;  // the merge reads only splits that hold rows
  const int end = min(start + chunk, len);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;
  const T* qb = q + (bh * G + g0) * D;
  const size_t part = (bh * gridDim.x + split) * G + g0;

  __shared__ float sm_m[kAnyWarps][GT];
  __shared__ float sm_l[kAnyWarps][GT];
  __shared__ float sm_acc[kAnyWarps][GT][kAnyDT];

  for (int d0 = 0; d0 < D; d0 += kAnyDT) {
    float m[GT], l[GT], acc[GT][kAnyR];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = kNeg;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kAnyR; ++i) acc[g][i] = 0.f;
    }
    // The loop bound is the same for every lane of a warp, so the
    // shuffles always run with the full warp.
    for (int s = start + warp; s < end; s += kAnyWarps) {
      const T* kr = kb + static_cast<size_t>(s) * D;
      const T* vr = vb + static_cast<size_t>(s) * D;
      float dot[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) dot[g] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kd = to_float(kr[d]);
#pragma unroll
        for (int g = 0; g < GT; ++g)
          if (g < gn) dot[g] = fmaf(to_float(qb[g * D + d]), kd, dot[g]);
      }
      float vd[kAnyR];
#pragma unroll
      for (int i = 0; i < kAnyR; ++i) {
        const int d = d0 + lane + 32 * i;
        vd[i] = d < D ? to_float(vr[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float x = dot[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        const float sc = x * scale_log2;
        const float mx = fmaxf(m[g], sc);
        const float corr = exp2f(m[g] - mx), p = exp2f(sc - mx);
        l[g] = fmaf(l[g], corr, p);
#pragma unroll
        for (int i = 0; i < kAnyR; ++i)
          acc[g][i] = fmaf(p, vd[i], acc[g][i] * corr);
        m[g] = mx;
      }
    }

    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = kNeg;
      for (int j = 0; j < kAnyWarps; ++j) mx = fmaxf(mx, sm_m[j][g]);
      const float sc = exp2f(m[g] - mx);
#pragma unroll
      for (int i = 0; i < kAnyR; ++i)
        sm_acc[warp][g][lane + 32 * i] = acc[g][i] * sc;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < gn * kAnyDT; t += kThreads) {
      const int g = t / kAnyDT, d = d0 + t % kAnyDT;
      if (d >= D) continue;
      float sum = 0.f;
      for (int j = 0; j < kAnyWarps; ++j) sum += sm_acc[j][g][t % kAnyDT];
      part_acc[(part + g) * D + d] = sum;
    }
    if (d0 == 0 && threadIdx.x < gn) {
      const int g = threadIdx.x;
      float mx = kNeg;
      for (int j = 0; j < kAnyWarps; ++j) mx = fmaxf(mx, sm_m[j][g]);
      float tot = 0.f;
      for (int j = 0; j < kAnyWarps; ++j)
        tot += sm_l[j][g] * exp2f(sm_m[j][g] - mx);
      part_m[part + g] = mx;
      part_l[part + g] = tot;
    }
    __syncthreads();  // the next pass reuses the merge buffers
  }
}

template <typename T, int GT>
void launch_any(const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* part_m, float* part_l,
                float* part_acc, int B, int Hkv, int G, int S, int D,
                int splits, int chunk, float scale, cudaStream_t stream) {
  const int tiles = (G + GT - 1) / GT;
  decode_split_any_kernel<T, GT>
      <<<dim3(splits, Hkv * tiles, B), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, part_m, part_l, part_acc, Hkv,
          G, tiles, S, D, chunk, scale * kLog2e);
  const int threads = G * D < 256 ? G * D : 256;
  decode_merge_kernel<T><<<B * Hkv, threads, 0, stream>>>(
      part_m, part_l, part_acc, lengths, static_cast<const T*>(v),
      static_cast<T*>(out), Hkv, G, D, S, splits, chunk);
}

template <typename T>
void dispatch_any(int D, int G, const void* q, const void* k, const void* v,
                  const int* lengths, void* out, float* pm, float* pl,
                  float* pa, int B, int Hkv, int S, int splits, int chunk,
                  float scale, cudaStream_t st) {
  switch (group_tile(G, 8)) {
    case 1: launch_any<T, 1>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, D, splits, chunk, scale, st); return;
    case 2: launch_any<T, 2>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, D, splits, chunk, scale, st); return;
    case 4: launch_any<T, 4>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, D, splits, chunk, scale, st); return;
    default: launch_any<T, 8>(q, k, v, lengths, out, pm, pl, pa, B, Hkv, G, S, D, splits, chunk, scale, st); return;
  }
}

}  // namespace

// The SIMT route.  q (B, Hkv, G, D), k/v (B, Hkv, S, D), out (B, Hkv, G,
// D): contiguous, of one dtype (0 float32, 1 bfloat16), any G >= 1, the
// query heads in tiles of group_tile(G, 8).  lengths (B,) int32.
// Partials: part_m/part_l (B, Hkv, splits, G), part_acc (B, Hkv, splits,
// G, D) float32.  D 16, 32, 64 and 128 run on decode_split_kernel, one
// launch that merges its own splits: tickets, at least B * Hkv *
// ceil(G / tile) unsigned ints, all zero, which the launch leaves zero
// again (a call on another stream at the same time needs a buffer of its
// own).  Every other D >= 1 runs on decode_split_any_kernel and
// decode_merge_kernel, two launches, tickets unused.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// another dtype, D < 1, G < 1, S < 1, or no tickets at those D.
extern "C" int repro_decode_attn(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, void* part_m,
                                 void* part_l, void* part_acc, void* tickets,
                                 int B, int Hkv, int G, int S, int D,
                                 int splits, int chunk, float scale,
                                 int dtype, void* stream) {
  if (G < 1 || S < 1 || D < 1 || (dtype != 0 && dtype != 1) ||
      ((D == 16 || D == 32 || D == 64 || D == 128) && tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  unsigned* tk = static_cast<unsigned*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !dispatch_d<float>(D, G, q, k, v, len, out, pm, pl, pa, tk, B, Hkv, S, splits, chunk, scale, st))
    dispatch_any<float>(D, G, q, k, v, len, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
  if (dtype == 1 && !dispatch_d<__nv_bfloat16>(D, G, q, k, v, len, out, pm, pl, pa, tk, B, Hkv, S, splits, chunk, scale, st))
    dispatch_any<__nv_bfloat16>(D, G, q, k, v, len, out, pm, pl, pa, B, Hkv, S, splits, chunk, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: as repro_decode_attn with q/k/v bfloat16 and
// 16-byte aligned, the query heads in tiles of group_tile(G, 16), and
// (splits, chunk) from split_plan_tc.  Returns cudaGetLastError() after
// both launches, or cudaErrorInvalidValue for a D or G the kernel is not
// built for.
extern "C" int repro_decode_attn_tc(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* part_m, void* part_l,
                                    void* part_acc, int B, int Hkv, int G,
                                    int S, int D, int splits, int chunk,
                                    float scale, void* stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  if (any % 16 != 0 || chunk % tc::TILE != 0 || G < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc::dispatch_d(D, G, q, k, v, static_cast<const int*>(lengths), out,
                        static_cast<float*>(part_m),
                        static_cast<float*>(part_l),
                        static_cast<float*>(part_acc), B, Hkv, S, splits,
                        chunk, scale, static_cast<cudaStream_t>(stream));
}
