// Flash attention (online softmax, GQA) — every attention call of the dense
// transformer's forward, prefill and decode_step.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, _flash_kernel (via
// flash_attention), the Pallas TPU kernel that walks (batch x q-head,
// q block, kv block) in order and carries the online-softmax state m, l, acc
// (float32) in VMEM scratch across the kv blocks.  It also stands in for the
// model's own XLA paths, models/layers.py _attention_direct and its blocked
// twin _attention_flash: unlike the Pallas kernel it takes q_offset, and the
// sliding window and kv_len at run time (one build serves every layer and
// every decode step), and any Tq, Tk (the ragged tile edge is masked here).
//
// Semantics (those of the reference): logits = (q / sqrt(hd)) . k, tanh
// softcap if softcap > 0, then masked to -1e30 where a key is not causal
// (k > q_pos), outside the window (k <= q_pos - window, window > 0) or past
// kv_len; softmax over the Tk keys; o = p . v.  q is float32, k/v are
// bfloat16 (read from the KV cache) or float32, o is float32, and every
// result is float32-accurate.  Masking with -1e30 (never -inf) makes a row
// with no valid key the uniform mean of v over all Tk keys, as in the
// reference.
//
// Head widths: 32, 64, 128, 256, and 112 (kimi-k2) and 120 (h2o-danube-3-4b),
// which run the 128-wide template with a run-time valid width: the columns
// of q, k and v past hd are loaded as zeros (TMA zero-fills them past its
// map's width), so the scores do not change, and output columns past hd are
// never stored.  Rows of 112 and 120 are 448 and 480 bytes in float32, 224
// and 240 in bf16: 16-byte aligned.
//
// The prefill designs can also write each row's log-sum-exp (m + log l,
// [B, H, Tq] float32): the training path's forward, whose backward
// (flash_attention_bwd.cu) recomputes p = exp(s - lse) from it.  With bf16
// k/v (Griffin's local MQA, Whisper's encoder and cross-attention, whose
// activations are bf16) that is flash_wgmma<HD, false>, whose epilogue is
// the split design's.
//
// Layout: q [B, Tq, H, hd], k/v [B, Tk, KV, hd], o [B, Tq, H, hd], each
// read or written through (batch, seq, head) strides with hd contiguous, so
// a layer's slice of the KV cache is read in place.  Query head h reads kv
// head h / groups (groups = H / KV); nothing is repeated in memory.  A
// block's rows are (position, group) pairs of one kv head, so the groups of
// a kv head share every k/v tile it loads.
//
// Designs, chosen by the wrapper (kernel.fwd_design mirrors the choice):
//
// * flash_wgmma<HD, false> (bf16 k/v, R = Tq * groups > 8 rows per kv head:
//   every prefill of the serve path).  Bound: operations, 4 hd per visible
//   (query, key) pair.  The first design ran them as float32 FMAs on the
//   CUDA cores (67 TFLOP/s) and reached ~40% of that.  Here both products
//   run on the bf16 tensor cores (wgmma) without losing float32 accuracy:
//   k and v are bf16 already, exact as tensor-core operands, and the scaled
//   q and the un-normalised p are each split into three bf16 parts
//   x = x1 + x2 + x3 (x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 -
//   x2)), which keep all 24 bits of a float32 mantissa.  S = sum_i Qi . K^T
//   and O += sum_i Pi . V accumulate in float32: six products per tile pair,
//   so the bound is 3 x operations / 989 TFLOP/s.  One block = 64 rows, a
//   producer warpgroup and two consumer warpgroups (setmaxnreg 24 / 240, as
//   the backward's bwd_wgmma; hd 256 below).  One producer thread brings k
//   and v tiles (attn_plan.h: fwd_tile_keys) by TMA straight from the
//   strided cache slice into a ring (fwd_stages; 128-byte swizzle, zero
//   fill past Tk),
//   completed on mbarriers.  The consumers share q's three parts in shared
//   memory (written swizzled, scaled by log2(e) / sqrt(hd), so that the
//   softmax is one exp2 a score) and take the key tiles in turns (even,
//   odd), each with its own m, l and O (64 x hd) in registers: while one
//   runs its mask, exp2 and the split of p on the CUDA cores, the other's
//   products keep the tensor cores busy.  At the end the second hands m, l and
//   O to the first through the ring, which merges them (log-sum-exp, a
//   fixed order: deterministic).  The mask is tested only on a tile that
//   crosses some row's edge or Tk.  p goes to the second product from
//   registers: the S accumulator's layout is the A-operand layout.
//   Q . K^T reads k K-major (hd contiguous); P . V reads v MN-major through
//   the transpose bit, so nothing is transposed in memory.  wgmma's float32
//   accumulator rounds toward zero: summed over every key tile of a row it
//   biases O toward zero, in proportion to the number of tiles (on the
//   H100, by 8.6e-5 of |O| on average at 32,768 keys, 1.6e-4 where v has a
//   mean of 1; PERF.md, C 1), so each tile's P . V runs in a fresh
//   accumulator, a slice of O's columns at a time (Wg::TN), added to O in
//   float32; two such accumulators take turns, so that a slice's products
//   run while the one before is added.  Tiles of 64 keys in four stages; at
//   hd 256 in two (96 KB of q parts + 2 x 64 KB of k/v = 224 KB), where O
//   takes 128 of a consumer's 240 registers.
// * flash_wgmma<HD, true> (float32 k/v, R > 8, hd <= 128: the training
//   forward with lse, and the cache-free forward).  The same design with k
//   and v split too: a prologue (fwd_prep_kv) writes the three bf16 parts
//   of the keys some row can see (attn_plan.h: fwd_parts_keys) head-major
//   [k, v][part][batch x kv head][keys][HD] into wrapper scratch (the
//   layout of the backward's prologue, split_row in wgmma.cuh), the
//   producer brings the parts by 3-D TMA, and each float32 product is the six
//   bf16 products of parts (i, j) with i + j <= 2 (pair_a / pair_b), as in
//   the backward: the bound is 6 x operations / 989 TFLOP/s.  Tiles of 64
//   keys in four stages at hd 32 and 64 (hd 64: 24 KB of q parts + 4 x
//   (k, v) x 3 parts x 8 KB = 216 KB), of 32 keys in three at hd 128 (48 +
//   3 x 48 = 192 KB; a stage passes between the warpgroups, as in
//   bwd_wgmma's HANDOVER).  Registers a consumer thread at hd 128: 64 for
//   O, 2 x 32 for the fresh products, 24 for p's parts.
// * flash_tiled (float32 k/v at hd 256, R > 8: gemma3's cache-free forward
//   and its training forward with lse; its parts would be 192 KB a stage):
//   256 threads per 64 rows; q, k, v and p staged in shared memory as
//   float32; both products 4x4 register micro-tiles of float32 FMAs.  Bound:
//   operations on the float32 CUDA cores.  One block of 216 KB fits an SM,
//   and a block streams its keys in series, 64-key tiles: where the grid is
//   under one wave of SMs (gemma3-4b's sequence-split islands: q [1, 256, 8,
//   256] at q_offset 3840 over 4,096 keys, 32 blocks on 132 SMs, 64 tiles
//   each) the keys are split (attn_plan.h: tiled_chunks, one block per (row
//   block, chunk), 4 chunks of 16 tiles at the island).  Each block then
//   writes its rows' unnormalised (m, l) and acc into scratch (a row that
//   sees no key of its chunk: m = -inf, l = 0), and flash_tiled_merge
//   weights the chunks in chunk order (deterministic) into o and lse.  A grid
//   that fills a wave runs one chunk: no scratch, no merge.
// * flash_decode (R <= 8: decode).  Bound: bytes, k and v over the keys the
//   rows can see.  The first design read v 2 bytes per thread, reduced each
//   key's score across a warp, and merged its chunks in a second launch
//   (~18% of the bound).  Here one launch: a block per (kv head, chunk of
//   the visible keys), at most one block per SM (the wrapper's plan: a
//   second wave doubles the time).  Each warp streams a run of keys through
//   its own cp.async ring (8 KB in flight per warp) with 16-byte loads of k
//   and v rows (8 bf16 columns per lane: one warp instruction per 256-wide
//   row), and keeps an online (m, l, acc) per lane, updated once per four
//   keys when at most 2 rows share a kv head (the serve path's decode), so
//   the dots, reductions and exps of four keys are independent chains.  The
//   warps merge in shared memory; the last block of each (batch, kv head)
//   to finish, found with an atomic counter that it resets to 0, merges the
//   chunks.  What bounds it now is the per-warp chain of dependent
//   reductions and exps, not bytes in flight (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_plan.h"
#include "wgmma.cuh"

namespace {

constexpr float kMask = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxSplitRows = 8;

struct Args {
  const float* q;
  const void* k;
  const void* v;
  float* o;
  int Tq, Tk, H, KV, groups;
  int64_t sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  int q_offset, window, kv_len, causal;
  int hd;      // valid head width: HD, or 112 / 120 run in the 128-wide template
  float* lse;  // prefill designs only: [B, H, Tq] log-sum-exp per row, or null
  float softcap, sqrt_hd;
  float qscale;  // flash_wgmma: log2(e) / sqrt(hd), q's scale before its split
  int kv_base;   // flash_wgmma<HD, true>: the first key of the prologue's parts
};

// First and last key (inclusive) a query at position qpos may see; the row
// has no valid key when lo > hi.
__device__ __forceinline__ int key_lo(const Args& a, int qpos) {
  return a.window > 0 ? max(0, qpos - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const Args& a, int qpos) {
  int hi = min(a.kv_len, a.Tk) - 1;
  return a.causal ? min(hi, qpos) : hi;
}
// A key k >= 0 is visible to a query at qpos iff lo <= k <= hi: causal
// (k <= qpos), inside the window (k > qpos - window, window > 0) and before
// kv_len.  Computed once per row, not per key.
__device__ __forceinline__ void key_bounds(const Args& a, int qpos, int& lo, int& hi) {
  lo = a.window > 0 ? qpos - a.window + 1 : INT_MIN;
  hi = a.causal ? min(a.kv_len - 1, qpos) : a.kv_len - 1;
}

// Keys [k_lo, k_hi] that rows m0 .. m_last of a block can see; every key
// when one of them sees none (rows that see nothing lie at the two ends).
__device__ __forceinline__ void block_keys(const Args& a, int m0, int m_last, int& k_lo,
                                           int& k_hi) {
  const int qp_first = a.q_offset + m0 / a.groups;
  const int qp_last = a.q_offset + m_last / a.groups;
  const bool any_empty = key_lo(a, qp_first) > key_hi(a, qp_first) ||
                         key_lo(a, qp_last) > key_hi(a, qp_last);
  k_lo = any_empty ? 0 : key_lo(a, qp_first);
  k_hi = any_empty ? a.Tk - 1 : key_hi(a, qp_last);
}

// n consecutive elements of a k/v row as float32 (16 bytes, 16-byte aligned;
// global or shared memory).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* out);

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
// bfloat16 is stored as uint16; its float32 value is the bits shifted up.
template <>
__device__ __forceinline__ void load_row<uint16_t, 8>(const uint16_t* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// flash_tiled: 64 query rows x 64-key tiles, 256 threads as 16 x 16.
// Thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and, in the scores, keys
// tx + 16 j (j < 4); in the output, columns tx * VEC + 16 VEC c (c < NCH).
// ---------------------------------------------------------------------------

constexpr int BM = 64;
constexpr int BN = 64;

template <int HD>
struct Tiled {
  static constexpr int LDQ = HD + 4;  // +4 floats: conflict-free float4 rows
  static constexpr int LDK = HD + 4;
  static constexpr int LDV = HD;
  static constexpr int LDP = BM + 4;
  static constexpr int VEC = HD >= 64 ? 4 : HD / 16;  // output columns per vector
  static constexpr int NCH = HD / (16 * VEC);         // vectors per thread per row
  static constexpr int DPT = VEC * NCH;               // = HD / 16
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(BM) * LDQ + size_t(BN) * LDK + size_t(BN) * LDV + size_t(BN) * LDP);
};

// KEY_SPLIT false: grid (rows / 64, B * KV), every key, o and lse written here
// (the unsplit path, compiled as before the split; the other arguments are
// unused).  KEY_SPLIT true: grid (rows / 64, B * KV, nchunk), blockIdx.z the
// block's chunk of the keys [k_begin, k_end) (attn_plan::chunk_begin); the
// rows' unnormalised partials of the chunk go to `part`
// (tiled_scratch_bytes: acc [nchunk][B KV][M][HD], then (m, l) [nchunk]
// [B KV][M][2]), merged by flash_tiled_merge.
template <int HD, bool KEY_SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tiled(Args a, int nchunk, int k_begin, int k_end, float* part) {
  using C = Tiled<HD>;
  using T = float;  // k/v: the bf16 ones go to flash_wgmma
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * C::LDQ;
  float* Vs = Ks + BN * C::LDK;
  float* Ps = Vs + BN * C::LDV;  // p transposed: Ps[key][row]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bkv = blockIdx.y, b = bkv / a.KV, kvh = bkv % a.KV;
  const int M = a.Tq * a.groups;
  const int m0 = blockIdx.x * BM;
  const int m_last = min(m0 + BM, M) - 1;

  // q rows (position t, group g) -> shared, divided by sqrt(hd)
  for (int i = tid; i < BM * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    const int m = m0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < M && c < a.hd) {
      const int t = m / a.groups, h = kvh * a.groups + m % a.groups;
      x = *reinterpret_cast<const float4*>(a.q + b * a.sqb + t * a.sqt + h * a.sqh + c);
      x.x /= a.sqrt_hd; x.y /= a.sqrt_hd; x.z /= a.sqrt_hd; x.w /= a.sqrt_hd;
    }
    *reinterpret_cast<float4*>(Qs + r * C::LDQ + c) = x;
  }

  int k_lo, k_hi;
  block_keys(a, m0, m_last, k_lo, k_hi);
  const int chunk = blockIdx.z;
  if constexpr (KEY_SPLIT) {  // this block's chunk of them (inner chunk bounds: multiples of BN)
    k_lo = max(k_lo, attn_plan::chunk_begin(chunk, nchunk, k_begin, k_end));
    k_hi = min(k_hi, attn_plan::chunk_begin(chunk + 1, nchunk, k_begin, k_end) - 1);
  }

  int klo[4], khi[4];  // the keys each of the thread's rows may see
  float m_i[4], l_i[4], acc[4][C::DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key_bounds(a, a.q_offset + (m0 + ty * 4 + i) / a.groups, klo[i], khi[i]);
    m_i[i] = kMask;
    l_i[i] = 0.f;
#pragma unroll
    for (int d = 0; d < C::DPT; ++d) acc[i][d] = 0.f;
  }

  const T* kbase = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HD / EPV;

  for (int n0 = (k_lo / BN) * BN; n0 <= k_hi; n0 += BN) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BN * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * EPV;
      float kx[EPV], vx[EPV];
      if (n0 + r < a.Tk && c < a.hd) {
        load_row<T, EPV>(kbase + (n0 + r) * a.skt + c, kx);
        load_row<T, EPV>(vbase + (n0 + r) * a.svt + c, vx);
      } else {  // past Tk or hd: zeros, so that they add nothing
#pragma unroll
        for (int e = 0; e < EPV; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPV; e += 4) {
        *reinterpret_cast<float4*>(Ks + r * C::LDK + c + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(Vs + r * C::LDV + c + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
    }
    __syncthreads();

    // scores: 4 rows x 4 keys per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * C::LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * C::LDK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
    }

    // softcap (a uniform branch), mask, online softmax; p -> Ps (transposed)
    if (a.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = a.softcap * tanhf(s[i][j] / a.softcap);
    }
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = n0 + tx + 16 * j;
        const float x = klo[i] <= kpos && kpos <= khi[i] ? s[i][j] : kMask;
        s[i][j] = kpos < a.Tk ? x : -INFINITY;  // past Tk: not a key at all
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], warp_max16(mx));  // >= -1e30: finite
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      l_i[i] = l_i[i] * corr + warp_sum16(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int d = 0; d < C::DPT; ++d) acc[i][d] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * C::LDP + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc += p . v
#pragma unroll 2
    for (int c = 0; c < BN; ++c) {
      const float4 pc = *reinterpret_cast<const float4*>(Ps + c * C::LDP + ty * 4);
      const float pr[4] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
      for (int ch = 0; ch < C::NCH; ++ch) {
        const float* vp = Vs + c * C::LDV + tx * C::VEC + 16 * C::VEC * ch;
        float vv[C::VEC];
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) vv[e] = vp[e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            acc[i][ch * C::VEC + e] = fmaf(pr[i], vv[e], acc[i][ch * C::VEC + e]);
      }
    }
  }

  if constexpr (KEY_SPLIT) {  // the chunk's partials: acc, then (m, l)
    const int64_t rows = static_cast<int64_t>(gridDim.y) * M;  // B KV x M
    const int64_t at = (static_cast<int64_t>(chunk) * gridDim.y + bkv) * M;
    float* acc_p = part + at * HD;
    float* ml_p = part + static_cast<int64_t>(nchunk) * rows * HD + at * 2;
    const bool none = k_lo > k_hi;  // no tile of this chunk: weight 0 in the merge
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int ch = 0; ch < C::NCH; ++ch)
        *reinterpret_cast<float4*>(acc_p + static_cast<int64_t>(m) * HD + tx * C::VEC +
                                   16 * C::VEC * ch) =
            make_float4(acc[i][ch * C::VEC], acc[i][ch * C::VEC + 1], acc[i][ch * C::VEC + 2],
                        acc[i][ch * C::VEC + 3]);
      if (tx == 0) {
        ml_p[2 * m] = none ? -INFINITY : m_i[i];
        ml_p[2 * m + 1] = l_i[i];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int t = m / a.groups, h = kvh * a.groups + m % a.groups;
    float* op = a.o + b * a.sob + t * a.sot + h * a.soh;
    const float den = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int ch = 0; ch < C::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) {
        const int col = tx * C::VEC + 16 * C::VEC * ch + e;
        if (col < a.hd) op[col] = acc[i][ch * C::VEC + e] / den;
      }
    // m and l are the row's, in every lane of the 16 that share it
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + h) * a.Tq + t] = m_i[i] + logf(den);
  }
}

// flash_tiled's split: one warp per row (batch x kv head, m) merges the
// nchunk partials in chunk order: weights w_c = exp(m_c - max), l = sum_c
// l_c w_c, o = sum_c acc_c w_c / l, lse = max + log l.  A chunk with m_c =
// -inf (no key of it seen) weighs 0.  Lane l holds columns 4 l + 128 j.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_tiled_merge(Args a, int B, int nchunk,
                                                               const float* part) {
  const int64_t M = static_cast<int64_t>(a.Tq) * a.groups;
  const int64_t rows = static_cast<int64_t>(B) * a.KV * M;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part + static_cast<int64_t>(nchunk) * rows * HD;
  float mx = -INFINITY;
  for (int c = 0; c < nchunk; ++c) mx = fmaxf(mx, ml[(c * rows + row) * 2]);
  float l = 0.f;
  float4 s[HD / 128];
#pragma unroll
  for (int j = 0; j < HD / 128; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nchunk; ++c) {
    const float mc = ml[(c * rows + row) * 2];
    const float w = mc == -INFINITY ? 0.f : expf(mc - mx);
    l = fmaf(ml[(c * rows + row) * 2 + 1], w, l);
    const float* acc = part + (c * rows + row) * HD + 4 * lane;
#pragma unroll
    for (int j = 0; j < HD / 128; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(acc + 128 * j);
      s[j].x = fmaf(x.x, w, s[j].x);
      s[j].y = fmaf(x.y, w, s[j].y);
      s[j].z = fmaf(x.z, w, s[j].z);
      s[j].w = fmaf(x.w, w, s[j].w);
    }
  }
  const float den = fmaxf(l, 1e-30f);
  const int bkv = static_cast<int>(row / M), m = static_cast<int>(row % M);
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int t = m / a.groups, h = kvh * a.groups + m % a.groups;
  float* op = a.o + b * a.sob + t * a.sot + h * a.soh;
#pragma unroll
  for (int j = 0; j < HD / 128; ++j) {
    const int col = 4 * lane + 128 * j;
    const float x[4] = {s[j].x / den, s[j].y / den, s[j].z / den, s[j].w / den};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < a.hd) op[col + e] = x[e];
  }
  if (a.lse != nullptr && lane == 0)
    a.lse[(static_cast<int64_t>(b) * a.H + h) * a.Tq + t] = mx + logf(den);
}

// ---------------------------------------------------------------------------
// flash_wgmma: more than 8 rows per kv head on the bf16 tensor cores; k/v
// bf16 (SPLIT false: read in place from the cache) or float32 (SPLIT true:
// their three bf16 parts, written by fwd_prep_kv).  Grid (row blocks of 64,
// B * KV); 384 threads: warpgroup 0 the producer, warpgroups 1 and 2 the
// consumers, which take the key tiles in turns.  A consumer's thread (warp
// w of its warpgroup, lane l) holds rows 16 w + l / 4 and 16 w + l / 4 + 8
// and, in every 8-column block j of S and O, columns 8 j + 2 (l % 4) and
// the next one (the wgmma accumulator layout).
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;
constexpr int kWgThreads = 384;  // a producer and two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD, bool SPLIT>
struct Wg {
  static constexpr int BN = attn_plan::fwd_tile_keys(HD, SPLIT);  // keys per tile
  static constexpr int STAGES = attn_plan::fwd_stages(HD, SPLIT);
  // an odd ring passes a stage from one consumer warpgroup to the other, so
  // a consumer first waits for the other's release of it (bwd_wgmma's rule)
  static constexpr bool HANDOVER = STAGES % 2 != 0;
  static constexpr int KV_PARTS = SPLIT ? kParts : 1;   // bf16 parts of each k (v) value
  static constexpr int NPROD = SPLIT ? kSplit : kParts; // bf16 products per float32 product
  static constexpr int SW = HD >= 64 ? 128 : 64;        // swizzle span: bytes per row of an atom
  static constexpr int ATOM = SW / 2;                    // bf16 columns per atom
  static constexpr int NATOM = HD / ATOM;                // atoms across hd
  // O columns per fresh P . V product: at hd 256, where O takes 128 of a
  // consumer's 240 registers, 16 (ptxas spills 436 B at 32; PERF.md,
  // finding 26)
  static constexpr int TN = HD == 256 ? 16 : HD < 64 ? HD : 64;
  static constexpr int Q_ATOM = kWgRows * SW;            // bytes of one [64 rows][ATOM] atom column
  static constexpr int KV_ATOM = BN * SW;
  static constexpr int Q_PART = NATOM * Q_ATOM;          // one bf16 part of q: 64 x hd
  static constexpr int KV_TILE = NATOM * KV_ATOM;        // one part of a k (or v) tile: BN keys x hd
  static constexpr int STAGE = 2 * KV_PARTS * KV_TILE;   // k's parts, then v's
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // descriptor: 128B / 64B swizzle
  static constexpr int OFF_KV = 3 * Q_PART;
  static constexpr int OFF_BAR = OFF_KV + STAGES * STAGE;
  static constexpr size_t kSmem = OFF_BAR + 2 * STAGES * 8 + 1024;  // + base alignment
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
  // the second warpgroup's O, m and l pass through the ring at the end
  static_assert((HD / 2 + 4) * 128 * 4 <= STAGES * STAGE, "the merge must fit the ring");
};

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// SPLIT false: tmap_k / tmap_v are 4-D maps of the bf16 k / v; k_inner /
// v_inner say whether the kv-head dimension lies inside the key dimension in
// memory (the tensor maps order their dimensions by stride).  SPLIT true:
// 3-D maps of k's and v's parts [part][batch x kv head][keys][HD], key
// a.kv_base at row 0.
template <int HD, bool SPLIT>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tmap_k,
                const __grid_constant__ CUtensorMap tmap_v, Args a, int k_inner, int v_inner) {
  using C = Wg<HD, SPLIT>;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + C::OFF_KV;
  const uint32_t bar_full = s_q + C::OFF_BAR, bar_empty = bar_full + 8 * C::STAGES;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.y, b = bkv / a.KV, kvh = bkv % a.KV;
  const int M = a.Tq * a.groups;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;  // the longest row blocks first
  const int m_last = min(m0 + kWgRows, M) - 1;
  int k_lo, k_hi;
  block_keys(a, m0, m_last, k_lo, k_hi);
  const int t_first = k_lo / BN;
  const int n_tiles = k_hi / BN - t_first + 1;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);  // a tile's readers: one warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t's k and v (their parts) into stage t % STAGES, by one thread;
  // the maps by their addresses in parameter space
  const CUtensorMap* map_k = &tmap_k;
  const CUtensorMap* map_v = &tmap_v;
  auto load = [&](int t) {
    const int s = t % C::STAGES;
    mbar_expect_tx(bar_full + 8 * s, C::STAGE);
    const int n0 = (t_first + t) * BN;
    const uint32_t dst = s_kv + s * C::STAGE;
#pragma unroll
    for (int c = 0; c < C::NATOM; ++c) {
      if (SPLIT) {
#pragma unroll
        for (int i = 0; i < kParts; ++i) {
          const uint32_t off = i * C::KV_TILE + c * C::KV_ATOM;
          tma_load_3d(dst + off, map_k, bar_full + 8 * s, c * C::ATOM, n0 - a.kv_base,
                      i * gridDim.y + bkv);
          tma_load_3d(dst + kParts * C::KV_TILE + off, map_v, bar_full + 8 * s, c * C::ATOM,
                      n0 - a.kv_base, i * gridDim.y + bkv);
        }
      } else {
        const uint32_t off = c * C::KV_ATOM;
        tma_load_4d(dst + off, map_k, bar_full + 8 * s, c * C::ATOM, k_inner ? kvh : n0,
                    k_inner ? n0 : kvh, b);
        tma_load_4d(dst + C::KV_TILE + off, map_v, bar_full + 8 * s, c * C::ATOM,
                    v_inner ? kvh : n0, v_inner ? n0 : kvh, b);
      }
    }
  };

  if (tid < 128) {  // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(bar_empty + 8 * (t % C::STAGES), ((t / C::STAGES) & 1) ^ 1);
        load(t);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int ctid = tid - 128;  // 0 .. 255 over both consumer warpgroups
  const int wg = ctid >> 7, ltid = ctid & 127;

  // q -> shared: rows (position, group) scaled by log2(e) / sqrt(hd), three
  // bf16 parts, each in [atom][row][ATOM] with the 16-byte chunks of a row
  // swizzled as TMA would (chunk ^ (row bits above the 128-byte line)).
  for (int i = ctid; i < kWgRows * (HD / 8); i += 256) {
    const int r = i / (HD / 8), cc = i % (HD / 8);
    const int m = m0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (m < M && cc * 8 < a.hd) {
      const int t = m / a.groups, h = kvh * a.groups + m % a.groups;
      const float* src = a.q + b * a.sqb + t * a.sqt + h * a.sqh + cc * 8;
      load_row<float, 4>(src, x);
      load_row<float, 4>(src + 4, x + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= a.qscale;
    }
    uint32_t p1[4], p2[4], p3[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(x[2 * e], x[2 * e + 1], p1[e], p2[e], p3[e]);
    const int atom = cc / (C::ATOM / 8), ch = cc % (C::ATOM / 8);
    const uint32_t off = atom * C::Q_ATOM + r * C::SW +
                         ((ch ^ ((r * C::SW >> 7) & (C::SW / 16 - 1))) << 4);
    st_shared_v4(s_q + off, p1);
    st_shared_v4(s_q + C::Q_PART + off, p2);
    st_shared_v4(s_q + 2 * C::Q_PART + off, p3);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  named_bar_sync(1, 256);

  const int warp = ltid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  int klo[2], khi[2];  // the keys each of the thread's two rows may see
  float m_i[2] = {kMask, kMask}, l_i[2] = {0.f, 0.f};  // m in log2 units; l: this thread's part
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_bounds(a, a.q_offset + (m0 + r_lo + 8 * h) / a.groups, klo[h], khi[h]);
  // keys [in_lo, in_hi] that every row of the block sees: a tile inside them
  // needs no mask (none where a row sees no key)
  const int qp_first = a.q_offset + m0 / a.groups, qp_last = a.q_offset + m_last / a.groups;
  const bool any_empty = key_lo(a, qp_first) > key_hi(a, qp_first) ||
                         key_lo(a, qp_last) > key_hi(a, qp_last);
  const int in_lo = any_empty ? INT_MAX : key_lo(a, qp_last);
  const int in_hi = key_hi(a, qp_first);
  const float cap = a.softcap * kLog2e;  // the softcap in log2 units
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  // this warpgroup's tiles: every other one, from its own index
  for (int t = wg; t < n_tiles; t += 2) {
    const int s = t % C::STAGES;
    const int n0 = (t_first + t) * BN;
    const uint32_t s_k = s_kv + s * C::STAGE, s_v = s_k + C::KV_PARTS * C::KV_TILE;
    // HANDOVER: the stage last held tile t - STAGES, the other warpgroup's,
    // and full's parity alone cannot tell t's fill from that one's; empty's
    // phase for that tile ends only on the other's release of it
    if constexpr (C::HANDOVER) mbar_wait(bar_empty + 8 * s, ((t / C::STAGES) & 1) ^ 1);
    mbar_wait(bar_full + 8 * s, (t / C::STAGES) & 1);

    // S = sum over the products of Q's parts (A) and K's (B; k itself when
    // it is bf16), in log2 units
    float sc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < C::NPROD; ++p)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int qa = SPLIT ? pair_a(p) : p, kb = SPLIT ? pair_b(p) : 0;
        const uint32_t col = (kk * 16 / C::ATOM) * C::Q_ATOM + (kk * 16 % C::ATOM) * 2;
        const uint32_t kcol = (kk * 16 / C::ATOM) * C::KV_ATOM + (kk * 16 % C::ATOM) * 2;
        wgmma_ss<BN>(sc, gmma_desc(s_q + qa * C::Q_PART + col, 16, 8 * C::SW, C::LAYOUT),
                     gmma_desc(s_k + kb * C::KV_TILE + kcol, 16, 8 * C::SW, C::LAYOUT), p | kk);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // softcap (a uniform branch), the mask where the tile crosses a row's
    // edge or Tk (uniform too), online softmax in log2 units; sc becomes p
    if (a.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = cap * tanhf(sc[i] / cap);
    }
    if (n0 < in_lo || n0 + BN - 1 > in_hi) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = n0 + 8 * j + cq + e;
            float x = sc[4 * j + 2 * h + e];
            x = klo[h] <= kpos && kpos <= khi[h] ? x : kMask;
            sc[4 * j + 2 * h + e] = kpos < a.Tk ? x : -INFINITY;  // past Tk: not a key at all
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);  // >= -1e30: finite
      const float corr = exp2f(m_i[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * h + e] - m_new);
          sc[4 * j + 2 * h + e] = p;
          sum += p;
        }
      l_i[h] = l_i[h] * corr + sum;
      m_i[h] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * h] *= corr;
        o[4 * j + 2 * h + 1] *= corr;
      }
    }

    // O += sum over the products of P's parts (A, from registers: the S
    // accumulator's layout is the A-operand layout; 16 keys a step) and V's
    // (B, MN-major).  wgmma's float32 accumulator rounds toward zero, which
    // over the hundreds of key tiles of a long context biases every row of
    // O toward zero (PERF.md, C 1), so each tile's product runs in a fresh
    // accumulator, TN columns at a time, and is added to O in float32.  Two
    // accumulators take turns: slice c + 1's products run while slice c is
    // added.
    uint32_t fr[BN / 16][kParts][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split3(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], fr[kk][0][f], fr[kk][1][f],
               fr[kk][2][f]);
    constexpr int NS = HD / C::TN;
    float acc[2][C::TN / 2];
#pragma unroll
    for (int c = 0; c <= NS; ++c) {
      if (c < NS) {
#pragma unroll
        for (int i = 0; i < C::TN / 2; ++i) acc[c % 2][i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int p = 0; p < C::NPROD; ++p) {
            const int pa = SPLIT ? pair_a(p) : p, vb = SPLIT ? pair_b(p) : 0;
            const uint32_t col = (c * C::TN / C::ATOM) * C::KV_ATOM + (c * C::TN % C::ATOM) * 2;
            wgmma_rs<C::TN>(acc[c % 2], fr[kk][pa],
                            gmma_desc(s_v + vb * C::KV_TILE + col + kk * 16 * C::SW, C::KV_ATOM,
                                      8 * C::SW, C::LAYOUT));
          }
        wgmma_commit();
      }
      const int d = c - 1;  // the slice whose product is added now
      if (d >= 0) {
        if (c < NS) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(acc[d % 2]);
#pragma unroll
        for (int i = 0; i < C::TN / 2; ++i) o[d * C::TN / 2 + i] += acc[d % 2][i];
      }
    }
    mbar_arrive(bar_empty + 8 * s);
  }

  // the two warpgroups' states merged in a fixed order (warpgroup 0's, then
  // 1's): warpgroup 1 hands its m, its part of l and O over through the
  // ring, which both have left (every loaded tile has been read).  A state
  // that saw no tile (m -1e30, l 0, O 0) weighs nothing.
  float* xch = reinterpret_cast<float*>(smem + C::OFF_KV);
  named_bar_sync(1, 256);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) xch[i * 128 + ltid] = o[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xch[(HD / 2 + h) * 128 + ltid] = m_i[h];
      xch[(HD / 2 + 2 + h) * 128 + ltid] = l_i[h];
    }
  }
  named_bar_sync(1, 256);
  if (wg == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = xch[(HD / 2 + h) * 128 + ltid], l1 = xch[(HD / 2 + 2 + h) * 128 + ltid];
    const float mx = fmaxf(m_i[h], m1);
    const float w0 = exp2f(m_i[h] - mx), w1 = exp2f(m1 - mx);
    l_i[h] = l_i[h] * w0 + l1 * w1;
    m_i[h] = mx;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        o[i] = o[i] * w0 + xch[i * 128 + ltid] * w1;
      }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int m = m0 + r_lo + 8 * h;
    if (m >= M) continue;
    const int t = m / a.groups, hh = kvh * a.groups + m % a.groups;
    float* op = a.o + b * a.sob + t * a.sot + hh * a.soh + cq;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      if (8 * j < a.hd)
        *reinterpret_cast<float2*>(op + 8 * j) =
            make_float2(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
    // m is the row's in all four lanes that share it; a row that sees no key
    // keeps the natural -1e30 (its log2 units would scale it)
    if (a.lse != nullptr && cq == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + hh) * a.Tq + t] =
          (m_i[h] == kMask ? kMask : m_i[h] * kLn2) + logf(den);
  }
}

// Prologue of flash_wgmma<HD, true>: one warp per (b, key, kv head) row of
// keys [k_begin, k_begin + nk), k's and v's rows (any strides) split into
// three bf16 parts, into [k, v][part][b * KV + kvh][nk][HD] (columns hd ..
// HD - 1 zero).
template <int HD>
__global__ void __launch_bounds__(kThreads) fwd_prep_kv(Args a, int B, int k_begin, int nk,
                                                        uint32_t* parts) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= static_cast<int64_t>(B) * nk * a.KV) return;
  const int kvh = static_cast<int>(row % a.KV);
  const int64_t bt = row / a.KV;
  const int t = static_cast<int>(bt % nk);
  const int64_t b = bt / nk;
  const int64_t part = static_cast<int64_t>(B) * a.KV * nk * HD / 2;  // uint32 per part
  uint32_t* dst = parts + ((b * a.KV + kvh) * nk + t) * HD / 2;
  const int key = k_begin + t;
  const float* k = static_cast<const float*>(a.k) + b * a.skb + key * a.skt + kvh * a.skh;
  const float* v = static_cast<const float*>(a.v) + b * a.svb + key * a.svt + kvh * a.svh;
  split_row<HD>(k, a.hd, 1.f, dst, part, threadIdx.x & 31);
  split_row<HD>(v, a.hd, 1.f, dst + kParts * part, part, threadIdx.x & 31);
}

// ---------------------------------------------------------------------------
// flash_decode: at most 8 query rows per kv head, one launch.  Grid
// (chunks, B * KV), 256 threads.  scratch: counters (one uint32 per
// (batch, kv head), 0 between calls, padded to 32), then the chunks'
// partials [B * KV][chunks][R][2 + HD] float32 (m, l, acc).
// ---------------------------------------------------------------------------

constexpr int kDecWarps = kThreads / 32;
constexpr int kMaxChunks = 1024;  // chunks per (batch, kv head): the merge's weights fit in smem

template <typename T, int HD, int RMAX>
struct Dec {
  static constexpr int EPL = 16 / sizeof(T);                 // elements per 16-byte load
  static constexpr int CPL = HD / 32 > EPL ? HD / 32 : EPL;  // columns per lane
  static constexpr int LPK = HD / CPL;                       // lanes per key
  static constexpr int KPS = 32 / LPK;                       // keys per warp step
  static constexpr int LOADS = CPL / EPL;                    // 16-byte loads per row and lane
  static constexpr int SLOT = 2 * CPL * sizeof(T);           // a lane's k and v bytes per step
  // steps per online-softmax update (one rescale, independent chains for the
  // dots, reductions and exps), and groups of them in flight: 8 KB per warp
  static constexpr int U = RMAX <= 2 ? 128 / SLOT : 1;
  static constexpr int GROUPS = U > 1 ? 2 : 256 / SLOT;
  static constexpr int RING = kDecWarps * GROUPS * U * 32 * SLOT;  // 64 KB per block
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Merges (m2, l2, acc2) into (m, l, acc); both m >= -1e30.
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[N], float m2,
                                            float l2, const float (&acc2)[N]) {
  const float mx = fmaxf(m, m2);
  const float w1 = expf(m - mx), w2 = expf(m2 - mx);
  l = l * w1 + l2 * w2;
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = acc[c] * w1 + acc2[c] * w2;
  m = mx;
}

template <typename T, int HD, int RMAX>
__global__ void __launch_bounds__(kThreads) flash_decode(Args a, int k_begin, int k_end,
                                                          int chunk, float* scratch) {
  using D = Dec<T, HD, RMAX>;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // after the keys: [warp][RMAX][2 + HD]
  float* wts = red;                               // in the merge: [RMAX][chunks + 1]
  __shared__ bool last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / D::LPK, part = lane % D::LPK;  // key of the step, column slice
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bkv = blockIdx.y, b = bkv / a.KV, kvh = bkv % a.KV;
  const int R = a.Tq * a.groups;
  const int kb = k_begin + split * chunk;
  const int n = min(chunk, k_end - kb);
  const int per = (n + kDecWarps - 1) / kDecWarps;
  const int r0 = kb + min(n, warp * per), r1 = kb + min(n, (warp + 1) * per);  // this warp's keys
  const int n_groups = (r1 - r0 + D::KPS * D::U - 1) / (D::KPS * D::U);

  float q[RMAX][D::CPL];
  int klo[RMAX], khi[RMAX];  // the keys each row may see
  // hd 112 / 120 in the 128-wide template: the lanes past hd read nothing (zeros)
  const bool col_ok = part * D::CPL < a.hd;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int t = r / a.groups, h = kvh * a.groups + r % a.groups;
    key_bounds(a, a.q_offset + t, klo[r], khi[r]);
#pragma unroll
    for (int c = 0; c < D::CPL; c += 4) {
      if (r < R && col_ok) {
        load_row<float, 4>(a.q + b * a.sqb + t * a.sqt + h * a.sqh + part * D::CPL + c, q[r] + c);
      } else {
        q[r][c] = q[r][c + 1] = q[r][c + 2] = q[r][c + 3] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < D::CPL; ++c) q[r][c] /= a.sqrt_hd;
  }

  const int col0 = col_ok ? part * D::CPL : 0;  // an address inside the row
  const T* kbase = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh + col0;
  const T* vbase = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh + col0;
  // this lane's slot i of the warp's ring: lane_ring + i * 32 * SLOT
  const uint32_t lane_ring = smem_u32(smem4) + (warp * D::GROUPS * D::U * 32 + lane) * D::SLOT;
  const uint8_t* lane_ring_p = reinterpret_cast<const uint8_t*>(smem4) +
                               (warp * D::GROUPS * D::U * 32 + lane) * D::SLOT;
  auto fetch = [&](int g) {
#pragma unroll
    for (int u = 0; u < D::U; ++u) {
      const int key = r0 + (g * D::U + u) * D::KPS + sub;
      const bool ok = key < r1 && col_ok;
      const T* ks = kbase + static_cast<int64_t>(ok ? key : r0) * a.skt;
      const T* vs = vbase + static_cast<int64_t>(ok ? key : r0) * a.svt;
      const uint32_t dst = lane_ring + ((g % D::GROUPS) * D::U + u) * 32 * D::SLOT;
#pragma unroll
      for (int l = 0; l < D::LOADS; ++l) {
        cp_async16(dst + 16 * l, ks + l * D::EPL, ok);
        cp_async16(dst + D::SLOT / 2 + 16 * l, vs + l * D::EPL, ok);
      }
    }
  };

  float m[RMAX], l[RMAX], acc[RMAX][D::CPL];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D::CPL; ++c) acc[r][c] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < D::GROUPS - 1; ++g) {
    fetch(g);
    cp_async_commit();
  }
  for (int g = 0; g < n_groups; ++g) {
    fetch(g + D::GROUPS - 1);
    cp_async_commit();
    cp_async_wait<D::GROUPS - 1>();  // group g's copies (this lane's own) have landed
    float kx[D::U][D::CPL], vx[D::U][D::CPL];
#pragma unroll
    for (int u = 0; u < D::U; ++u) {
      const T* slot = reinterpret_cast<const T*>(lane_ring_p +
                                                 ((g % D::GROUPS) * D::U + u) * 32 * D::SLOT);
#pragma unroll
      for (int c = 0; c < D::CPL; c += D::EPL) {
        load_row<T, D::EPL>(slot + c, kx[u] + c);
        load_row<T, D::EPL>(slot + D::CPL + c, vx[u] + c);
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= R) break;
      float x[D::U];
#pragma unroll
      for (int u = 0; u < D::U; ++u) {
        x[u] = 0.f;
#pragma unroll
        for (int c = 0; c < D::CPL; ++c) x[u] = fmaf(q[r][c], kx[u][c], x[u]);
      }
#pragma unroll
      for (int o = D::LPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < D::U; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
      if (a.softcap > 0.f) {
#pragma unroll
        for (int u = 0; u < D::U; ++u) x[u] = a.softcap * tanhf(x[u] / a.softcap);
      }
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < D::U; ++u) {
        const int key = r0 + (g * D::U + u) * D::KPS + sub;
        const float y = klo[r] <= key && key <= khi[r] ? x[u] : kMask;
        x[u] = key < r1 ? y : -INFINITY;  // past this warp's keys: not a key
        mx = fmaxf(mx, x[u]);
      }
      const float corr = expf(m[r] - mx);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < D::U; ++u) {
        x[u] = expf(x[u] - mx);
        ps += x[u];
      }
      l[r] = l[r] * corr + ps;
      m[r] = mx;
#pragma unroll
      for (int c = 0; c < D::CPL; ++c) {
        float y = acc[r][c] * corr;
#pragma unroll
        for (int u = 0; u < D::U; ++u) y = fmaf(x[u], vx[u][c], y);
        acc[r][c] = y;
      }
    }
  }
  cp_async_wait<0>();

  // merge the keys of a step across the warp, then the warps in shared memory
#pragma unroll
  for (int o = D::LPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      float acc2[D::CPL];
#pragma unroll
      for (int c = 0; c < D::CPL; ++c) acc2[c] = __shfl_xor_sync(0xffffffffu, acc[r][c], o);
      merge_state(m[r], l[r], acc[r], __shfl_xor_sync(0xffffffffu, m[r], o),
                  __shfl_xor_sync(0xffffffffu, l[r], o), acc2);
    }
  __syncthreads();  // the ring is free: red reuses it
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= R) break;
      float* dst = red + (warp * RMAX + r) * (2 + HD);
      if (part == 0) {
        dst[0] = m[r];
        dst[1] = l[r];
      }
#pragma unroll
      for (int c = 0; c < D::CPL; ++c) dst[2 + part * D::CPL + c] = acc[r][c];
    }
  }
  __syncthreads();

  unsigned* counters = reinterpret_cast<unsigned*>(scratch);
  const int64_t n_bkv = static_cast<int64_t>(gridDim.y);
  float* partial = scratch + (n_bkv + 31) / 32 * 32 + static_cast<int64_t>(bkv) * nsplit * R * (2 + HD);
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mx = kMask;
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, red[(w * RMAX + r) * (2 + HD)]);
    float ls = 0.f, as = 0.f;
    for (int w = 0; w < kDecWarps; ++w) {
      const float* src = red + (w * RMAX + r) * (2 + HD);
      const float wt = expf(src[0] - mx);
      ls = fmaf(src[1], wt, ls);
      as = fmaf(src[2 + d], wt, as);
    }
    if (nsplit == 1) {
      const int t = r / a.groups, h = kvh * a.groups + r % a.groups;
      if (d < a.hd) a.o[b * a.sob + t * a.sot + h * a.soh + d] = as / fmaxf(ls, 1e-30f);
    } else {
      float* dst = partial + (static_cast<int64_t>(split) * R + r) * (2 + HD);
      if (d == 0) {
        dst[0] = mx;
        dst[1] = ls;
      }
      dst[2 + d] = as;
    }
  }
  if (nsplit == 1) return;

  // the last chunk of this (batch, kv head) to finish merges all chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + bkv, 1u) == static_cast<unsigned>(nsplit - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // warp r: each chunk's weight exp(m_s - max) and the row's sum of l
  const int64_t step = static_cast<int64_t>(R) * (2 + HD);
  if (warp < R) {
    const float* p0 = partial + static_cast<int64_t>(warp) * (2 + HD);
    float mx = kMask;
    for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, __ldcg(p0 + s * step));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float ls = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float wt = expf(__ldcg(p0 + s * step) - mx);
      wts[warp * (nsplit + 1) + s] = wt;
      ls = fmaf(__ldcg(p0 + s * step + 1), wt, ls);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    if (lane == 0) wts[warp * (nsplit + 1) + nsplit] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const float* p0 = partial + static_cast<int64_t>(r) * (2 + HD) + 2 + d;
    const float* w = wts + r * (nsplit + 1);
    float as = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) as = fmaf(__ldcg(p0 + s * step), w[s], as);
    const int t = r / a.groups, h = kvh * a.groups + r % a.groups;
    if (d < a.hd) a.o[b * a.sob + t * a.sot + h * a.soh + d] = as / w[nsplit];
  }
  if (tid == 0) counters[bkv] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 4-D TMA map of a bf16 k or v tensor [B, Tk, KV, hd] with strides (in
// elements) st (key), sh (kv head), sb (batch): dimensions ordered by
// stride, a box of ATOM columns x BN keys, swizzled for wgmma.  *kv_inner
// says whether the kv head comes before the key.
template <int HD>
bool make_kv_map(CUtensorMap* map, const void* base, int hd, int Tk, int KV, int B, int64_t st,
                 int64_t sh, int64_t sb, int* kv_inner) {
  using C = Wg<HD, false>;
  *kv_inner = sh < st;
  // dimension 0 is the valid width: TMA zero-fills columns hd..HD-1 of the box
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(*kv_inner ? KV : Tk),
                              static_cast<cuuint64_t>(*kv_inner ? Tk : KV),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * (*kv_inner ? sh : st)),
                                 static_cast<cuuint64_t>(2 * (*kv_inner ? st : sh)),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {C::ATOM, static_cast<cuuint32_t>(*kv_inner ? 1 : C::BN),
                             static_cast<cuuint32_t>(*kv_inner ? C::BN : 1), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool SPLIT>
cudaError_t launch_flash_wgmma(const CUtensorMap& mk, const CUtensorMap& mv, const Args& a, int B,
                               int k_inner, int v_inner, cudaStream_t stream) {
  using C = Wg<HD, SPLIT>;
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma<HD, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return e;
  const int M = a.Tq * a.groups;
  const dim3 grid((M + kWgRows - 1) / kWgRows, B * a.KV);
  flash_wgmma<HD, SPLIT><<<grid, kWgThreads, C::kSmem, stream>>>(mk, mv, a, k_inner, v_inner);
  return cudaGetLastError();
}

// bf16 k/v, read in place
template <int HD>
cudaError_t launch_wgmma(const Args& a, int B, cudaStream_t stream) {
  CUtensorMap mk, mv;
  int k_inner = 0, v_inner = 0;
  if (!make_kv_map<HD>(&mk, a.k, a.hd, a.Tk, a.KV, B, a.skt, a.skh, a.skb, &k_inner) ||
      !make_kv_map<HD>(&mv, a.v, a.hd, a.Tk, a.KV, B, a.svt, a.svh, a.svb, &v_inner))
    return cudaErrorInvalidValue;
  return launch_flash_wgmma<HD, false>(mk, mv, a, B, k_inner, v_inner, stream);
}

// float32 k/v: the visible keys (attn_plan::fwd_parts_keys) split into parts
// (the wrapper's scratch: rt_flash_fwd_plan's bytes), then the kernel
template <int HD>
cudaError_t launch_split(Args a, int B, uint32_t* parts, cudaStream_t stream) {
  using C = Wg<HD, true>;
  int k_begin, k_end;
  attn_plan::fwd_parts_keys(a.Tq, a.Tk, a.causal, a.window, a.q_offset, a.kv_len, &k_begin,
                            &k_end);
  const int nk = k_end - k_begin;
  a.kv_base = k_begin;
  const int64_t rows = static_cast<int64_t>(B) * nk * a.KV;
  constexpr int kRowsPerBlock = kThreads / 32;
  fwd_prep_kv<HD><<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads,
                    0, stream>>>(a, B, k_begin, nk, parts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t outer = static_cast<int64_t>(kParts) * B * a.KV;
  CUtensorMap mk, mv;
  if (!make_parts_map(&mk, parts, HD, nk, outer, C::BN, C::ATOM, C::SW) ||
      !make_parts_map(&mv, parts + outer * nk * HD / 2, HD, nk, outer, C::BN, C::ATOM, C::SW))
    return cudaErrorInvalidValue;
  return launch_flash_wgmma<HD, true>(mk, mv, a, B, 0, 0, stream);
}

// flash_tiled, its keys split by attn_plan::tiled_chunks: one chunk (keys
// 0 .. Tk, no scratch), or nchunk chunks into `split` (tiled_scratch_bytes
// of it), then flash_tiled_merge.
template <int HD>
cudaError_t launch_tiled(const Args& a, int B, float* split, int64_t split_bytes, int sms,
                         cudaStream_t stream) {
  int k_begin, k_end;
  const int nchunk = attn_plan::tiled_chunks(B, a.Tq, a.Tk, a.H, a.KV, a.q_offset, a.window,
                                             a.kv_len, a.causal, sms, &k_begin, &k_end);
  if (nchunk > 1 &&
      (split == nullptr || reinterpret_cast<uintptr_t>(split) % 16 != 0 ||
       split_bytes < attn_plan::tiled_scratch_bytes(nchunk, B, a.Tq, a.H, a.KV)))
    return cudaErrorInvalidValue;
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      nchunk == 1 ? flash_tiled<HD, false> : flash_tiled<HD, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Tiled<HD>::kSmem));
  if (e != cudaSuccess) return e;
  const int M = a.Tq * a.groups;
  const dim3 grid((M + BM - 1) / BM, B * a.KV, nchunk);
  if (nchunk == 1) {
    flash_tiled<HD, false><<<grid, kThreads, Tiled<HD>::kSmem, stream>>>(a, 1, 0, a.Tk, nullptr);
    return cudaGetLastError();
  }
  flash_tiled<HD, true><<<grid, kThreads, Tiled<HD>::kSmem, stream>>>(a, nchunk, k_begin, k_end,
                                                                       split);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return e2;
  const int64_t rows = static_cast<int64_t>(B) * a.KV * M;
  constexpr int kRowsPerBlock = kThreads / 32;
  flash_tiled_merge<HD><<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                          kThreads, 0, stream>>>(a, B, nchunk, split);
  return cudaGetLastError();
}

template <typename T, int HD, int RMAX>
cudaError_t launch_decode(const Args& a, int B, float* scratch, int nsplit, int k_begin,
                          int k_end, int chunk, cudaStream_t stream) {
  const size_t red = sizeof(float) * kDecWarps * RMAX * (2 + HD);
  const size_t ring = Dec<T, HD, RMAX>::RING;
  const size_t smem = red > ring ? red : ring;
  const cudaError_t e = cudaFuncSetAttribute(flash_decode<T, HD, RMAX>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_decode<T, HD, RMAX><<<dim3(nsplit, B * a.KV), kThreads, smem, stream>>>(
      a, k_begin, k_end, chunk, scratch);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int kv_bf16, const Args& a, int B, float* scratch, uint32_t* kv_parts,
                     int nsplit, int k_begin, int k_end, int chunk, float* split,
                     int64_t split_bytes, int sms, cudaStream_t s) {
  if (scratch == nullptr) {
    if (kv_bf16) return launch_wgmma<HD>(a, B, s);
    if constexpr (HD <= 128) {
      return launch_split<HD>(a, B, kv_parts, s);
    } else {
      return launch_tiled<HD>(a, B, split, split_bytes, sms, s);
    }
  }
  const bool two = a.Tq * a.groups <= 2;
  if (kv_bf16)
    return two ? launch_decode<uint16_t, HD, 2>(a, B, scratch, nsplit, k_begin, k_end, chunk, s)
               : launch_decode<uint16_t, HD, 8>(a, B, scratch, nsplit, k_begin, k_end, chunk, s);
  return two ? launch_decode<float, HD, 2>(a, B, scratch, nsplit, k_begin, k_end, chunk, s)
             : launch_decode<float, HD, 8>(a, B, scratch, nsplit, k_begin, k_end, chunk, s);
}

}  // namespace

// strides: q (b, t, h), k (b, t, kv), v (b, t, kv), o (b, t, h), in elements.
// hd: 32, 64, 128, 256, or 112 / 120 (run in the 128-wide template).
// part == nullptr: more than 8 rows per kv head or lse wanted: flash_wgmma
// with bf16 k/v; with float32 k/v flash_wgmma on their parts (hd <= 128;
// kv_parts: rt_flash_fwd_plan's scratch bytes, 16-byte aligned) or
// flash_tiled (hd 256).  lse (these designs only, else null): [B, H, Tq] float32, each
// row's log-sum-exp.  Otherwise the decode design over keys [k_begin, k_end) in
// nsplit chunks of `chunk` keys, with part its scratch (see flash_decode):
// counters that are 0 when the call starts and 0 again when it ends.
// flash_tiled splits its keys on a card of `sms` SMs as attn_plan.h's
// tiled_chunks decides, into `split` (split_bytes, at least
// tiled_scratch_bytes; null when it runs one chunk).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int kv_bf16, int hd, int B, int Tq, int Tk, int H, int KV,
                                  const void* strides, int q_offset, int window, int kv_len,
                                  int causal, float softcap, void* lse, void* kv_parts,
                                  void* part, int nsplit, int k_begin, int k_end, int chunk,
                                  void* split, int64_t split_bytes, int sms, void* stream) {
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = static_cast<const int64_t*>(strides);
  if (part != nullptr &&
      (Tq * (H / KV) > kMaxSplitRows || chunk < 1 || nsplit < 1 || nsplit > kMaxChunks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lse != nullptr && part != nullptr)  // lse: flash_wgmma (either k/v type), flash_tiled
    return static_cast<int>(cudaErrorInvalidValue);
  if (part == nullptr && !kv_bf16 && hd <= 128 &&
      (kv_parts == nullptr || reinterpret_cast<uintptr_t>(kv_parts) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.o = static_cast<float*>(o);
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.KV = KV; a.groups = H / KV;
  a.sqb = st[0]; a.sqt = st[1]; a.sqh = st[2];
  a.skb = st[3]; a.skt = st[4]; a.skh = st[5];
  a.svb = st[6]; a.svt = st[7]; a.svh = st[8];
  a.sob = st[9]; a.sot = st[10]; a.soh = st[11];
  a.q_offset = q_offset; a.window = window; a.kv_len = kv_len; a.causal = causal;
  a.softcap = softcap;
  a.hd = hd;
  a.lse = static_cast<float*>(lse);
  a.sqrt_hd = static_cast<float>(sqrt(static_cast<double>(hd)));
  a.qscale = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  a.kv_base = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  uint32_t* kp = static_cast<uint32_t*>(kv_parts);
  float* sp = static_cast<float*>(split);
  cudaError_t e;
  switch (hd) {
    case 32:
      e = dispatch<32>(kv_bf16, a, B, pp, kp, nsplit, k_begin, k_end, chunk, sp, split_bytes, sms,
                       s);
      break;
    case 64:
      e = dispatch<64>(kv_bf16, a, B, pp, kp, nsplit, k_begin, k_end, chunk, sp, split_bytes, sms,
                       s);
      break;
    case 112:
    case 120:
    case 128:
      e = dispatch<128>(kv_bf16, a, B, pp, kp, nsplit, k_begin, k_end, chunk, sp, split_bytes,
                        sms, s);
      break;
    case 256:
      e = dispatch<256>(kv_bf16, a, B, pp, kp, nsplit, k_begin, k_end, chunk, sp, split_bytes,
                        sms, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
