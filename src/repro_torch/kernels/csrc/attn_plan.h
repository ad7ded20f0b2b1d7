// The split rules of the attention designs, in one place: flash_tiled (the
// forward, flash_attention.cu), bwd_wide and bwd_wgmma
// (flash_attention_bwd.cu): the key split, the backward's head split and
// its k/v parts.  Plain C++: the CUDA entry points include it to decide,
// and attn_plan.cc exports it to the Python wrappers (built by the host
// compiler), which ask it for the scratch a call needs and count the split
// launches; nothing else holds the rules.
//
// The key split.  A design whose grid has fewer blocks than the card has SMs
// leaves SMs idle while each block streams every key it sees in series
// (gemma3-4b's sequence-split islands: q [1, 256, 8, 256] over 4,096 keys,
// 32 blocks of 216 KB on 132 SMs).  There the keys the rows can see
// (visible_keys) are cut into chunks, one block per (row block, chunk):
// runs of whole 64-key tiles, each of at least kMinChunkKeys keys, as many
// as keep the grid within one wave (blocks x chunks <= SMs).  A grid that
// already fills a wave runs one chunk, the unsplit path.  The chunks'
// partial results are merged in chunk order (deterministic).
//
// The head split (bwd_kv_head_splits).  Both backward designs' dK/dV pass has
// one block per (batch, kv head, 64-key tile), each streaming the query
// tiles of every query head of the GQA group; recurrentgemma-9b's local MQA
// (16 query heads over one kv head, 4,096 keys) gives bwd_wide 64 blocks on
// 132 SMs, each streaming 16 heads' tiles, and a causal GQA-4 rank island
// (qwen3-moe's, kimi-k2's: q [2, 4096, 4, 128] over one kv head) gives
// bwd_wgmma 128 blocks in one wave whose first streams 4 x 128 query tiles
// and whose last 4 x 2.  There the group's query heads are cut into n
// contiguous subsets instead, one block per (key tile, subset), each
// writing a partial dK and dV that a merge sums in subset order.
#pragma once

#include <stdint.h>

#include <vector>

#ifdef __CUDACC__
#define ATTN_PLAN_FN __host__ __device__ __forceinline__
#else
#define ATTN_PLAN_FN inline
#endif

namespace attn_plan {

constexpr int kTile = 64;           // keys of flash_tiled's tile: chunks hold whole tiles
constexpr int kMinChunkKeys = 256;  // no chunk under four tiles' worth of keys
constexpr int kMaxChunks = 256;     // chunks a call may have (bounds arrays)
constexpr int kHd = 256;            // the head width of both designs
constexpr int kRows = 64;           // rows of a block in both designs
constexpr int kParts = 3;           // bwd: bf16 parts of each float32 operand
constexpr int kPadRows = 128;       // bwd: lse and D rows padded to this

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t align256(int64_t n) { return cdiv(n, 256) * 256; }

// Keys [*lo, *hi) that some query row can see: rows at q_offset ..
// q_offset + Tq - 1 over keys 0 .. min(kv_len, Tk) - 1, causal and a
// sliding window (0 = none).  All Tk keys when the first or the last row
// sees none (rows that see nothing lie at the two ends): such a row is the
// mean of v over every key.
inline void visible_keys(int Tq, int Tk, int causal, int window, int q_offset, int kv_len,
                         int* lo, int* hi) {
  const int last_key = (kv_len < Tk ? kv_len : Tk) - 1;
  auto key_lo = [&](int p) { return window > 0 ? (p - window + 1 > 0 ? p - window + 1 : 0) : 0; };
  auto key_hi = [&](int p) { return causal ? (last_key < p ? last_key : p) : last_key; };
  const int first = q_offset, last = q_offset + Tq - 1;
  if (key_lo(first) > key_hi(first) || key_lo(last) > key_hi(last)) {
    *lo = 0;
    *hi = Tk;
    return;
  }
  *lo = key_lo(first);
  *hi = key_hi(last) + 1;
}

// ---------------------------------------------------------------------------
// flash_wgmma<HD, SPLIT> (the prefill forward on the tensor cores; HD the
// template width 32, 64, 128 or 256; SPLIT: float32 k/v as three bf16
// parts).  Keys of a streamed tile and stages of the ring (flash_attention.cu,
// Wg): 64-key tiles, whose S products read as many bytes of shared memory
// as the tensor cores take clocks (32-key ones read 1.5x as long), in four
// stages where they fit beside q's three parts, two at hd 256 (q's parts
// are 96 KB; a stage 64 KB); at hd 128 on split k/v a 64-key stage of six
// parts would be 96 KB: 32 keys in three stages (48 KB each).  Two consumer
// warpgroups take the tiles in turns, so an even count gives each its own
// stages; an odd one hands a stage over.
// ---------------------------------------------------------------------------

ATTN_PLAN_FN constexpr int fwd_tile_keys(int hd, bool split) {
  return split && hd == 128 ? 32 : 64;
}
ATTN_PLAN_FN constexpr int fwd_stages(int hd, bool split) {
  return hd == 256 ? 2 : split && hd == 128 ? 3 : 4;
}

// The keys [*k_begin, *k_end) whose bf16 parts the split design's prologue
// writes: the visible keys, the first rounded down to a whole kTile (a
// multiple of every tile), so that each block's first tile starts inside.
inline void fwd_parts_keys(int Tq, int Tk, int causal, int window, int q_offset, int kv_len,
                           int* k_begin, int* k_end) {
  visible_keys(Tq, Tk, causal, window, q_offset, kv_len, k_begin, k_end);
  *k_begin = *k_begin / kTile * kTile;
}

// The first key of chunk c of nchunk over keys [k_begin, k_end); c = nchunk
// gives k_end.  Inner bounds fall on multiples of kTile, so every tile
// belongs to one chunk.
ATTN_PLAN_FN int chunk_begin(int c, int nchunk, int k_begin, int k_end) {
  if (c <= 0) return k_begin;
  if (c >= nchunk) return k_end;
  const int64_t at = k_begin + static_cast<int64_t>(c) * (k_end - k_begin) / nchunk;
  return static_cast<int>(at / kTile * kTile);
}

// Chunks of keys [k_begin, k_end) for a grid of `blocks` blocks on `sms`
// SMs: 1 when the grid fills a wave; else the most chunks that keep
// blocks x chunks <= sms with every chunk at least kMinChunkKeys keys.
inline int key_chunks(int64_t blocks, int sms, int k_begin, int k_end) {
  if (blocks >= sms) return 1;
  int64_t n = sms / blocks;
  const int64_t by_size = (k_end - k_begin) / kMinChunkKeys;
  if (n > by_size) n = by_size;
  if (n > kMaxChunks) n = kMaxChunks;
  for (; n > 1; --n) {  // inner bounds rounded down to a tile: each chunk still long enough?
    bool ok = true;
    for (int c = 0; c < n && ok; ++c)
      ok = chunk_begin(c + 1, static_cast<int>(n), k_begin, k_end) -
               chunk_begin(c, static_cast<int>(n), k_begin, k_end) >= kMinChunkKeys;
    if (ok) break;
  }
  return n < 1 ? 1 : static_cast<int>(n);
}

// ---------------------------------------------------------------------------
// flash_tiled (float32 k/v at hd 256): a block = 64 rows (position, group)
// of one kv head, grid (rows / 64, B x KV).  Split: grid z = the chunk; each
// block writes its rows' unnormalised (m, l) and acc[256] per chunk, and a
// merge launch writes o and lse.
// ---------------------------------------------------------------------------

inline int tiled_chunks(int B, int Tq, int Tk, int H, int KV, int q_offset, int window, int kv_len,
                        int causal, int sms, int* k_begin, int* k_end) {
  visible_keys(Tq, Tk, causal, window, q_offset, kv_len, k_begin, k_end);
  const int64_t blocks = cdiv(static_cast<int64_t>(Tq) * (H / KV), kRows) * B * KV;
  return key_chunks(blocks, sms, *k_begin, *k_end);
}

// Floats of the split's partials: acc [nchunk][B KV][M][256], then (m, l)
// [nchunk][B KV][M][2], M = Tq x groups.
inline int64_t tiled_acc_floats(int nchunk, int B, int Tq, int H, int KV) {
  return static_cast<int64_t>(nchunk) * B * KV * Tq * (H / KV) * kHd;
}
inline int64_t tiled_scratch_bytes(int nchunk, int B, int Tq, int H, int KV) {
  if (nchunk <= 1) return 0;
  return 4 * (tiled_acc_floats(nchunk, B, Tq, H, KV) +
              static_cast<int64_t>(nchunk) * B * KV * Tq * (H / KV) * 2);
}

// ---------------------------------------------------------------------------
// bwd_wide's dQ (hd 256).  The recomputing pass bwd_wide<true> has a grid of
// B x H x ceil(Tq / 64) blocks.  Under one wave, the dS path instead: the
// dK/dV pass also stores dS (float32, [B H][Tq][Tk], the pairs it visits),
// and bwd_dq_ds computes dQ = dS K / sqrt(hd) over chunks of the visible
// keys, partials [nchunk][B H][Tq][256] merged in chunk order (none for one
// chunk).  0 chunks: the recomputing pass.
// ---------------------------------------------------------------------------

inline int bwd_dq_chunks(int hd, int B, int Tq, int Tk, int H, int q_offset, int window,
                         int causal, int sms, int* k_begin, int* k_end) {
  visible_keys(Tq, Tk, causal, window, q_offset, Tk, k_begin, k_end);
  const int64_t blocks = static_cast<int64_t>(B) * H * cdiv(Tq, kRows);
  if (hd != kHd || blocks >= sms) return 0;
  return key_chunks(blocks, sms, *k_begin, *k_end);
}

ATTN_PLAN_FN int head_begin(int s, int n, int groups) { return s * groups / n; }

// bwd_wgmma's 128-wide dK/dV pass (hd 112, 120, 128): its streamed query
// tiles, a block's fixed cost (loading its 64 keys' k and v parts, storing
// dK and dV) counted in such tiles, and the grids it weighs (under
// kMaxWaves waves; past that the longest-first launch order balances them).
constexpr int kWgmmaRows = 32;
constexpr int kBlockTiles = 2;
constexpr int kMaxWaves = 2;

// The query tiles of kWgmmaRows rows that one head streams for key tile kt
// (flash_attention_bwd.cu's stream_range<false>): the queries that see one
// of its 64 keys.
inline int kv_tile_queries(int kt, int Tq, int Tk, int q_offset, int window, int causal) {
  const int r_first = kt * kRows, r_last = (r_first + kRows < Tk ? r_first + kRows : Tk) - 1;
  const int lo = causal ? (r_first - q_offset > 0 ? r_first - q_offset : 0) : 0;
  int hi = Tq - 1;
  if (window > 0 && r_last + window - 1 - q_offset < hi) hi = r_last + window - 1 - q_offset;
  return hi < lo ? 0 : hi / kWgmmaRows - lo / kWgmmaRows + 1;
}

// The dK/dV pass's length in streamed tiles with n head subsets: its blocks
// handed out in launch order (subset, key tile, batch x kv head), each to
// the SM that frees first, a block costing kBlockTiles plus its tiles.
inline int64_t kv_pass_makespan(int n, int bkv, const std::vector<int>& tiles, int groups,
                                int sms) {
  std::vector<int64_t> load(sms, 0);
  for (int s = 0; s < n; ++s) {
    const int heads = head_begin(s + 1, n, groups) - head_begin(s, n, groups);
    for (int t : tiles)
      for (int x = 0; x < bkv; ++x) {
        int at = 0;
        for (int i = 1; i < sms; ++i)
          if (load[i] < load[at]) at = i;
        load[at] += kBlockTiles + static_cast<int64_t>(t) * heads;
      }
  }
  int64_t most = 0;
  for (int64_t x : load) most = x > most ? x : most;
  return most;
}

// The dK/dV pass's head subsets n (subset s holds heads head_begin(s) ..
// head_begin(s + 1) - 1 of the group); 1 is the unsplit pass.  Partials
// [n][B KV][Tk][hdk] float32 of dK, then of dV, summed in subset order.
// - bwd_wide (hd 256): where its grid (B x KV x ceil(Tk / 64) blocks) is
//   under one wave and a group has more than one head, the most subsets that
//   keep blocks x n <= SMs, at most one per head (recurrentgemma-9b: 64
//   blocks, n = 2).  Else 1: every other hd-256 call on a path (gemma3-4b's
//   full layers and islands: 256 blocks), and the dS path (nchunk > 0),
//   whose dK/dV pass also stores dS.
// - bwd_wgmma's 128-wide template (hd 112, 120, 128): where the grid is
//   under kMaxWaves waves and a group has more than one head, the n (at most
//   one subset per head) whose pass kv_pass_makespan makes shortest, taken
//   only if it is at least a tenth shorter than the unsplit one (the
//   partials' writes and the merge cost the rest).  The causal GQA-4
//   islands: 128 blocks, the unsplit pass 514 tiles long against a mean of
//   262, n = 2 258; h2o-danube-3-4b's rank (256 blocks, 2 heads) stays
//   whole (258 against 260); starcoder2-3b's island (512 blocks) and
//   every group of one head too.
// - hd 32 and 64: 1 (no path runs them on a GQA group under two waves).
inline int bwd_kv_head_splits(int hd, int B, int Tq, int Tk, int H, int KV, int q_offset,
                              int window, int causal, int nchunk, int sms) {
  const int groups = H / KV;
  const int64_t blocks = static_cast<int64_t>(B) * KV * cdiv(Tk, kRows);
  if (groups < 2) return 1;
  if (hd == kHd) {
    if (nchunk > 0 || blocks >= sms) return 1;
    int64_t n = sms / blocks;
    if (n > groups) n = groups;
    return n < 1 ? 1 : static_cast<int>(n);
  }
  if (hd != 112 && hd != 120 && hd != 128) return 1;
  if (blocks >= static_cast<int64_t>(kMaxWaves) * sms) return 1;
  std::vector<int> tiles;
  for (int kt = 0; kt < cdiv(Tk, kRows); ++kt)
    tiles.push_back(kv_tile_queries(kt, Tq, Tk, q_offset, window, causal));
  const int bkv = B * KV;
  const int64_t whole = kv_pass_makespan(1, bkv, tiles, groups, sms);
  int best = 1;
  int64_t best_len = whole;
  for (int n = 2; n <= groups; ++n) {
    const int64_t len = kv_pass_makespan(n, bkv, tiles, groups, sms);
    if (len < best_len) {
      best = n;
      best_len = len;
    }
  }
  return 10 * best_len <= 9 * whole ? best : 1;
}

// The bf16 parts the backward holds of k and v: 1 where they are bfloat16
// and an instance takes them as they are (bwd_wgmma at hd 64; bwd_wide's
// recomputing passes, hd 256 and nchunk 0: each product with k or v takes
// three bf16 products where float32 operands take six), else 3 (float32
// values, or bf16 ones taken as their float32 values: bwd_wgmma at hd 32
// and 112-128, and the dS path).  has_kv1: the head widths that have such
// (KV1) instances, which launch_wgmma builds and dispatches by too.
constexpr bool has_kv1(int hd) { return hd == 64 || hd == kHd; }

inline int bwd_kv_parts(int hd, int kv_bf16, int nchunk) {
  return kv_bf16 && has_kv1(hd) && (hd != kHd || nchunk == 0) ? 1 : kParts;
}

// The backward's scratch, in this order, each part 256-byte aligned: the
// bf16 parts of q / sqrt(hd), dO ([3][B H][Tq][hdk] each) and of k, v
// ([kv_parts][B KV][Tk][hdk]); lse and D as [B H][Tp] float32 (Tp: Tq padded
// to kPadRows); on the dS path the dQ partials (more than one chunk) and dS;
// with a head split the dK and dV partials ([n][B KV][Tk][hdk] each).
struct BwdLayout {
  int64_t qp, dop, kp, vp, lse, d, dq_part, ds, kv_part, total;  // byte offsets, and the size
};

inline BwdLayout bwd_layout(int hdk, int B, int Tq, int Tk, int H, int KV, int nchunk,
                            int nsplit, int kv_parts) {
  BwdLayout l;
  const int64_t qpart = 2 * static_cast<int64_t>(B) * H * Tq * hdk;   // bytes of one part
  const int64_t kpart = 2 * static_cast<int64_t>(B) * KV * Tk * hdk;
  const int64_t tp = cdiv(Tq, kPadRows) * kPadRows;
  l.qp = 0;
  l.dop = l.qp + align256(kParts * qpart);
  l.kp = l.dop + align256(kParts * qpart);
  l.vp = l.kp + align256(kv_parts * kpart);
  l.lse = l.vp + align256(kv_parts * kpart);
  l.d = l.lse + align256(4 * static_cast<int64_t>(B) * H * tp);
  l.dq_part = l.d + align256(4 * static_cast<int64_t>(B) * H * tp);
  l.ds = l.dq_part +
         (nchunk > 1 ? align256(4 * static_cast<int64_t>(nchunk) * B * H * Tq * kHd) : 0);
  l.kv_part = l.ds + (nchunk > 0 ? align256(4 * static_cast<int64_t>(B) * H * Tq * Tk) : 0);
  l.total = l.kv_part +
            (nsplit > 1 ? align256(2 * 4 * static_cast<int64_t>(nsplit) * B * KV * Tk * hdk) : 0);
  return l;
}

}  // namespace attn_plan
