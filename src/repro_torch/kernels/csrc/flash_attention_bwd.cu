// Flash attention backward: dq, dk, dv of the forward in
// flash_attention.cu — every layer's backward on the training path.
//
// Replaces: no pallas_call.  The reference trains through jax.grad of the
// jnp attention (src/repro/models/layers.py:114 _attention_flash under
// jax.checkpoint, or _attention_direct below 2048 positions): XLA's
// transpose of the forward, on the TPU.  The port's forward is a hand-written
// kernel with no gradient, so its backward is one too.
//
// Semantics: the gradient of ref.attention_ref with q [B, Tq, H, hd]
// float32 and k, v [B, Tk, KV, hd] float32 or (bwd_wgmma at hd 64,
// bwd_wide) bfloat16 (H % KV == 0), query row i at position
// q_offset + i and kv_len Tk, causal or not, a run-time sliding window (0 =
// none) and a tanh softcap c (d/ds of c tanh(s / c) is 1 - (s' / c)^2 with
// s' the capped score).  Every row sees at least its own key: a non-causal,
// unwindowed row sees all Tk keys, and a causal or windowed call needs
// 0 <= q_offset and q_offset + Tq <= Tk (the entry point refuses others),
// which the training forward (q_offset 0, Tq == Tk), every island of the
// sequence-split attention (q_offset = rank x Tq, Tk the whole sequence)
// and a non-causal cross-attention meet.  Keys that no query sees get zero
// dK and dV rows.
// With s = (q / sqrt(hd)) . k, p = exp(s' - lse) (lse from the forward),
// D = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * cap',
//   dQ = dS K / sqrt(hd),  dK = dS^T (Q / sqrt(hd)).
// Masked (query, key) pairs have p = 0 and pass no gradient.
//
// Bound: operations.  The least work is five products of 2 hd operations
// per visible (query, key) pair: S, dP, dV, dK, dQ, 10 hd in all (4 hd for
// the forward).  With float32 k/v every operand is float32 (q, k, v, dO are
// float32 products of float32 activations; P and dS are computed here), so
// on the bf16 tensor cores each float32 product becomes BWD_SPLIT = 6 bf16
// products:
// both operands split into three bf16 parts x = x0 + x1 + x2 (x0 = bf16(x),
// x1 = bf16(x - x0), x2 = bf16(x - x0 - x1)), and the cross products x_i y_j
// with i + j <= 2 summed in float32 (the smallest first); the dropped ones
// are below float32's rounding.  The bound is 6 x 10 hd x pairs / 989
// TFLOP/s.  Why 6 and not fewer: 3 (i + j <= 1) already holds every
// gradient within BWD_TOL (1e-4) of the plain version on the CPU emulation
// (ref.attention_bwd_split_ref), but by itself moves 0.76% of a full-width
// train step's bf16-rounded weight gradients off the plain backward's (5
// products: 0.45%), where train_check (a) allows 1% between the card and
// the CPU in all and the card's float32 products already spend up to 0.8%;
// 6 move 0.08% (scripts/torch_bwd_split_choice.py).  bf16 k/v have one
// non-zero part: bwd_wgmma at hd 64 and bwd_wide take them as they are
// (attn_plan.h: bwd_kv_parts), and the products with k or v (S, dP, dQ)
// make three bf16 products, the non-zero three of the six in the same
// order, so the sums equal the float32-k/v path's on the same values; dV
// and dK stay at six: 4.2 a product on average, the bound of bf16 k/v.
//
// Two designs, by head width (the wrapper, kernel.bwd_design, mirrors it),
// both deterministic with no atomics: each output element is written once
// by the thread whose registers summed it, and partials (the head split's,
// the dS path's) are summed in a fixed order (the kill/resume drill replays
// a loss trace bit for bit).  Both start with the same two prologues:
// bwd_prep_q (D = rowsum(dO * O), and q / sqrt(hd) and dO split into their
// three bf16 parts, lse and D copied into rows padded to 128) and
// bwd_prep_kv (k and v split, or bf16 k/v copied as their one part), into
// wrapper scratch in head-major order [part][batch x head][T][hd].  Then two passes, FA2's split: one for dK
// and dV, one for dQ, each with a block's 64 "fixed" rows (keys, or
// queries) against tiles of the other rows streamed through a ring by TMA
// (q and dO of every query tile of every q head of the GQA group that can
// see the keys; or k and v of every key tile the queries can see).  S and dP
// are computed in both passes: 14 hd of products per pair against the
// bound's 10, so a design can reach at most 10/14 of its bound.  wgmma's
// float32 accumulator rounds toward zero, which over the thousands of steps
// of a long sum shrinks a gradient by ~1e-4 of itself (dK, dV at 4096
// positions x 4 heads of a GQA group failed BWD_TOL so), so each streamed
// tile's dV, dK or dQ runs in a fresh accumulator and is added to the
// running sum with float32 adds.  Tiles that the causal or window mask
// hides completely are never loaded (gemma3's local layers see 1024 of 4096
// keys).
//
// * bwd_wgmma (hd 32, 64, 112, 120 and 128; the training path's hd 64):
//   bwd_wgmma<HD, false> (dK, dV) and bwd_wgmma<HD, true> (dQ).
//   One block = two consumer warpgroups and a producer warpgroup, one
//   thread of which issues every copy; the producer hands its registers to
//   the consumers (setmaxnreg 24 / 240).  The fixed rows' two operands
//   (dK/dV pass: 64 keys of k and v; dQ pass: 64 queries of q and dO), all
//   three parts, come in once by TMA; the producer then streams tiles of BS
//   rows of the other two through a mbarrier ring of two stages (hd 64:
//   three), 128-byte (hd 32: 64-byte) swizzled.  A block whose fixed keys
//   no query sees loads nothing and writes zero dK and dV rows (the
//   sequence islands at q_offset 0: 15 of 16 key tiles).  Per streamed tile
//   a warpgroup computes, as
//   FlashAttention-3 does,
//     dK/dV pass:  S^T = K Q^T and dP^T = V dO^T (A and B from shared
//                  memory, both K-major), then P^T and dS^T in registers,
//                  dV += P^T dO and dK += dS^T Q (A from registers: the
//                  accumulator layout is the A-operand layout; q and dO
//                  MN-major through the transpose bit), the sum over the
//                  GQA group in the same registers;
//     dQ pass:     S = Q K^T and dP = dO V^T, then dS, dQ += dS K.
//   hd 32: each consumer warpgroup owns 64 fixed rows (128 a block) and
//   reads every tile, skipping one its rows cannot see; BS 64.  hd 64 and
//   hd 128 (and 112 and 120, in the 128-wide template with the columns past
//   hd zero), BS 32: the block's 64 fixed rows are shared by both
//   consumers, which take the streamed tiles in turns (even, odd), each
//   summing its own dK and dV (hd 64: 32 + 32 accumulator floats a thread;
//   128: 64 + 64) or dQ; at the end the second hands its sums to the first
//   through the ring, which adds them (warpgroup 0's + warpgroup 1's, a
//   fixed order).  One warpgroup's mask, exp and dS math, its split of the
//   A fragments and its waits on its products overlap the other's products,
//   through which the tensor cores of a one-warpgroup block idle.  The
//   dK/dV pass's lse and D rows of each query tile come in with the tile (a
//   bulk copy into the stage), not from device memory after its products.
//   The ring: 2 stages at hd 128 (stage 0 the first warpgroup's, 1 the
//   second's); 3 at hd 64, rotating under the two warpgroups (2 took 14%
//   longer on minicpm-2b's train shape, 4 and 6 2-3% longer than 3 with the
//   hand-over wait below: PERF.md §6).
//   There tile t reuses the stage of tile t - 3, the other warpgroup's, and
//   the consumer of t may get there before t - 3 has even landed (it saw
//   only its own t - 2); a wait on full's parity would then take t - 3's
//   phase for t's.  So it first waits on the stage's empty barrier for the
//   other warpgroup's release of t - 3 (BwL::HANDOVER), which no phase of
//   its own can complete.
//   hd 64 also commits S (S^T) and dP (dP^T) as two groups and forms P
//   while dP's products run (the split wait; its derivative of the softcap
//   kept for dS: 16 more registers, which the 128-wide dK/dV pass lacks).
//   bf16 k/v at hd 64 (the KV1 instances bwd_wgmma<64, false / true, false,
//   true>: Whisper's encoder and cross-attention): bwd_prep_kv copies k and
//   v as their one part, [B KV][Tk][64] bf16.  dK/dV pass: the fixed k and
//   v are one part each, S^T and dP^T take the three products with their
//   part 0, dV and dK keep six.  dQ pass: the streamed k and v are one part
//   each, and S, dP and dQ take three.  Per tile 18 of the 24 products of
//   the dK/dV pass, 9 of the 18 of the dQ pass; BwL has each instance's
//   shared memory (the KV1 instances keep 3 stages: 4 and 8 measured
//   slower).
//   The 128-wide dK/dV pass also takes the head split (attn_plan.h:
//   bwd_kv_head_splits): where its grid is under two waves and unbalanced
//   (the causal GQA-4 islands of qwen3-moe's and kimi-k2's training ranks:
//   128 blocks on 132 SMs, the first streaming 4 x 128 query tiles and the
//   last 4 x 2), the group's heads are cut into n contiguous subsets,
//   blockIdx.z the subset: bwd_wgmma<128, false, true> streams its subset's
//   heads only and writes partial dK and dV ([n][B KV][Tk][128] float32),
//   and bwd_kv_merge<128> sums them in subset order (deterministic).
// * bwd_wide (hd 256: gemma3-4b): bwd_wide<false> (dK, dV) and
//   bwd_wide<true> (dQ).  bwd_wgmma's layout does not fit: the three parts of
//   64 fixed rows of two operands are 192 KB alone, and dK and dV of 64 keys
//   x 256 columns are 256 accumulator floats a thread of one warpgroup.  So:
//   - the fixed operands stay float32 in shared memory (64 KB each: the
//     compact form of their three parts), and each k-step's A fragment is
//     read from there and split into its parts in registers (the A operand
//     of wgmma from registers, RS form); only the streamed operands are
//     stored as parts, 16-row tiles;
//   - two consumer warpgroups each own 128 of the 256 columns: of dK and dV
//     (64 + 64 accumulator floats a thread) or of dQ (64).  Each computes
//     its columns' share of S^T and dP^T (of S and dP), 64 x 16 over 8
//     k-steps, the two swap them through shared memory, and both sum the
//     same two halves, so both hold the same P and dS;
//   - the ring holds one operand's 16-row tile a slot, three slots, filled
//     in the order in which a tile's operands are last read (dK/dV pass: q,
//     then dO; dQ pass: v, then k), so a slot frees mid-tile.
//   Per tile a consumer runs 2 x 8 k-steps x 6 products of m64n16k16 (its
//   share of S, dP; one k-step's products a group, two groups in flight:
//   2 x 12 split registers; two k-steps a group held 48, spilled more and
//   ran 3.5% slower), then 2 (dQ) or 4 (dK, dV) 64-column slices x 6
//   products of m64n64k16, each in a fresh accumulator, two of which take
//   turns.
//   Shared memory: ring 3 x 24 KB (three parts x 16 rows x 512 bytes) +
//   fixed 2 x 64 KB + swap 16 KB (16 floats x 128 threads x 2) = 216 KB, +
//   barriers and 1 KB of alignment: 217.05 KB of the 227 KB.  Registers a
//   consumer thread (setmaxnreg 240; producer 24): dK/dV pass 128
//   accumulator floats + 16 of S^T, dP^T + 24 of split A fragments during
//   the scores (the products: + 2 x 32 fresh + 24 of P^T and dS^T parts).
//   The fixed operands are read unpadded, with each 8-byte slot s of row r
//   at s ^ ((r & 3) << 2): the 16 lanes of a half-warp (4 rows x 4 slots)
//   hit 16 different bank pairs.
//   The head split (attn_plan.h: bwd_kv_head_splits).  Where the dK/dV grid
//   (B x KV x Tk / 64 blocks) is under one wave and the GQA group has more
//   than one head (recurrentgemma-9b's local MQA: 16 query heads over one kv
//   head, 64 blocks on 132 SMs, each streaming 16 x 132 tiles), the group's
//   heads are cut into n contiguous subsets (n = 2 there: 128 blocks),
//   blockIdx.z the subset: bwd_wide<false, false, true> streams its
//   subset's heads only and writes a partial dK and dV ([n][B KV][Tk][256]
//   float32), and bwd_kv_merge<256> sums them in subset order into dk, dv
//   (deterministic).  Each subset's sums keep the fresh accumulators.  Its
//   own instance: the full layers' pass is unchanged.
//   bf16 k/v (the KV1 instances: bwd_wide<false, false, false / true,
//   true> and bwd_wide<true, false, false, true>).  bwd_prep_kv copies k
//   and v as their one part, [B KV][Tk][256] bf16.  dK/dV pass: the fixed k
//   and v sit in shared memory as bf16 (2 x 32 KB; each 4-byte pair slot s
//   of row r at s ^ ((r & 7) << 2), so a warp's 8 rows x 4 slots hit 32
//   banks), read straight into the A fragment with no split, and S^T, dP^T
//   take the three products with k's or v's part 0; the ring holds six
//   24-KB slots of q's and dO's parts (225.1 KB in all).  dQ pass: the
//   streamed k and v are one part, 8-KB slots, eight of them (209.1 KB), and
//   S, dP and dQ take the three products with their part 0.  Per tile 18 of
//   the 24 products of the dK/dV pass, 9 of the 18 of the dQ pass.
//   The dS path (attn_plan.h: bwd_dq_chunks).  Where the dQ grid (B x H x
//   Tq / 64 blocks) is under one wave of SMs (gemma3-4b's sequence-split
//   islands: 32 blocks on 132 SMs, each streaming 4,096 / 16 key tiles),
//   bwd_wide<true> is replaced: the dK/dV pass, which forms dS for every
//   (key tile, query tile) pair it visits, also stores it (bwd_wide<false,
//   true>, its own instance, so the full layers' pass is unchanged; float32, [B H]
//   [Tq][Tk], 33.5 MB at the island), and bwd_dq_ds computes dQ = dS K /
//   sqrt(hd) from it on the tensor cores, its grid also over chunks of the
//   visible keys (4 of 1,024 at the island: 128 blocks), each chunk's dQ a
//   partial that bwd_dq_merge sums in chunk order (one chunk: dQ directly).
//   bwd_dq_ds keeps bwd_wide's product: two consumer warpgroups of 128
//   columns, per 16-key tile dS (64 x 16, read from memory into the A
//   fragment and split into three bf16 parts in registers) times k's parts
//   (streamed by TMA through an 8-slot ring), two 64-column slices of six
//   m64n64k16 products in fresh accumulators.  It reads dS only inside
//   each row's visible keys (zeros elsewhere), which the dK/dV pass always
//   writes: a row's visible keys lie in key blocks whose stream range holds
//   the row.  Its bound: 2 hd per visible pair of the 10 hd above, at the
//   six products' rate.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_plan.h"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Shared by both designs.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

struct BwdArgs {
  const float* q;     // [B, T, H, hd]
  const float* k;     // [B, T, KV, hd] float32 (null for bf16 k/v)
  const float* v;
  const uint32_t* k16;  // [B, T, KV, hd] bf16 pairs (bf16 k/v; else null)
  const uint32_t* v16;
  const float* o;     // [B, T, H, hd]
  const float* lse;   // [B, H, T]
  const float* dout;  // [B, T, H, hd]
  float* dq;          // [B, T, H, hd]
  float* dk;          // [B, T, KV, hd]
  float* dv;
  // the tensor-core design's scratch: bf16 parts (as uint32 pairs) of
  // q / sqrt(hd), dO, k, v, and lse, D with rows padded to Tp
  uint32_t* qp;
  uint32_t* dop;
  uint32_t* kp;
  uint32_t* vp;
  float* lse_p;
  float* d_p;
  float* ds;  // the dS path: dS [B H][Tq][Tk] float32, stored by bwd_wide<false, true>; else null
  float* kv_part;  // the head split: partial dK, then dV, [nsplit][B KV][Tk][hdk]; else null
  int nsplit;      // the dK/dV pass's head subsets (1: unsplit)
  int B, Tq, Tk, Tp, H, KV, groups, hd;  // Tp: Tq padded to kPadRows
  int q_offset, window, causal;
  float softcap, sqrt_hd;
};

__device__ __forceinline__ int64_t q_row(const BwdArgs& a, int b, int t, int h) {
  return ((static_cast<int64_t>(b) * a.Tq + t) * a.H + h) * a.hd;
}
__device__ __forceinline__ int64_t kv_row(const BwdArgs& a, int b, int t, int kvh) {
  return ((static_cast<int64_t>(b) * a.Tk + t) * a.KV + kvh) * a.hd;
}

// Rows of the fixed operands (keys in the dK/dV pass, queries in dQ's).
template <bool DQ>
__device__ __forceinline__ int fixed_rows(const BwdArgs& a) {
  return DQ ? a.Tq : a.Tk;
}

// ---------------------------------------------------------------------------
// bwd_wgmma (hd 32, 64, 120/128).  Consumer thread (warpgroup w, warp v,
// lane l) holds, of its warpgroup's 64 fixed rows, rows 16 v + l / 4 and
// 16 v + l / 4 + 8 and, in every 8-column block j of an accumulator,
// columns 8 j + 2 (l % 4) and the next one (the wgmma accumulator layout).
// ---------------------------------------------------------------------------

template <int HD>
struct Bw {
  static constexpr int NWG = HD < 64 ? 2 : 1;      // groups of 64 fixed rows a block
  // hd 64 and 128: the two consumer warpgroups share the block's 64 fixed
  // rows and take the streamed tiles in turns (even, odd), each summing its
  // own; hd 32: one consumer warpgroup a group of fixed rows, each taking
  // every tile
  static constexpr bool TURNS = NWG == 1;
  static constexpr int CWG = 2;                     // consumer warpgroups
  static constexpr int BS = HD < 64 ? 64 : 32;     // rows of a streamed tile
  static constexpr int THREADS = 128 * (CWG + 1);  // + the producer warpgroup
  static constexpr int TN = HD < 64 ? HD : 64;     // output columns per promoted product
  static constexpr int SW = HD >= 64 ? 128 : 64;   // swizzle span: bytes per row of an atom
  static constexpr int ATOM = SW / 2;              // bf16 columns per atom
  static constexpr int NATOM = HD / ATOM;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int FIX_TILE = NATOM * 64 * SW;  // one part of 64 fixed rows
  static constexpr int STR_TILE = NATOM * BS * SW;  // one part of a streamed tile
  static constexpr int ROWS = 64 * NWG;            // fixed rows per block
  static constexpr int READERS = TURNS ? 128 : 128 * NWG;  // consumer threads that read a stage
};

// An instance's shared memory.  FP, SP: the bf16 parts of each fixed and
// of each streamed operand (1 for k and v where KV1: bf16 k/v as they are).
// Fixed: [group][operand 0/1][part]; a stage: [operand 0/1][part]; with
// TURNS each stage's lse and D rows (BS floats each) of its query tile (the
// dK/dV pass), brought in by the producer with the tile; the barriers.
//   hd 32:            2 x 24 + 2 x 24 KB                      =  96.0 KB
//   hd 64:            48 + 3 x 24 KB (+ 3 x 256 B lse, D)      = 120.75 KB
//   hd 64 KV1, dK/dV: 16 + 3 x 24 KB (+ 3 x 256 B)             =  88.75 KB
//   hd 64 KV1, dQ:    48 + 3 x 8 KB                            =  72.0 KB
//   hd 128:           96 + 2 x 48 KB (+ 2 x 256 B)             = 192.5 KB
// each + barriers and 1 KB of alignment, of the 227 KB a block may use.
template <int HD, bool DQ, bool KV1>
struct BwL {
  using C = Bw<HD>;
  static constexpr int FP = !DQ && KV1 ? 1 : kParts;
  static constexpr int SP = DQ && KV1 ? 1 : kParts;
  static constexpr int FIX = 2 * FP * C::FIX_TILE;  // a group's two fixed operands
  static constexpr int OFF_STR = C::NWG * FIX;
  static constexpr int STAGE = 2 * SP * C::STR_TILE;
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  // a stage passes from one consumer warpgroup to the other (TURNS over an
  // odd ring: hd 64), so a consumer first waits for the other to release it
  static constexpr bool HANDOVER = C::TURNS && STAGES % C::CWG != 0;
  static constexpr bool LSE_SMEM = C::TURNS && !DQ;  // lse and D come with the tile
  static constexpr int OFF_LSE = OFF_STR + STAGES * STAGE;
  static constexpr int LSE_BYTES = LSE_SMEM ? STAGES * 2 * C::BS * 4 : 0;
  static constexpr int OFF_BAR = OFF_LSE + LSE_BYTES;
  static constexpr size_t kSmem = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + base alignment
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
  static_assert(!C::TURNS || (DQ ? 1 : 2) * HD / 2 * 128 * 4 <= STAGES * STAGE,
                "the turns' sums must fit the ring");
};

constexpr int kPadRows = attn_plan::kPadRows;  // lse and D rows padded to a multiple of every
                                              // block's rows

// The streamed rows [lo, hi] that fixed rows r_first .. r_last can reach:
// dK/dV pass (fixed keys) the queries that see one of the keys; dQ pass
// (fixed queries) the keys one of the queries sees.  Query row i sits at
// position q_offset + i, key row j at j.  Empty when lo > hi (a key that no
// query sees: its dK and dV rows are 0).
template <bool DQ>
__device__ __forceinline__ void stream_range(const BwdArgs& a, int r_first, int r_last, int& lo,
                                             int& hi) {
  r_last = min(r_last, fixed_rows<DQ>(a) - 1);
  if (DQ) {
    lo = a.window > 0 ? max(0, a.q_offset + r_first - a.window + 1) : 0;
    hi = a.causal ? min(a.Tk - 1, a.q_offset + r_last) : a.Tk - 1;
  } else {
    lo = a.causal ? max(0, r_first - a.q_offset) : 0;
    hi = a.window > 0 ? min(a.Tq - 1, r_last + a.window - 1 - a.q_offset) : a.Tq - 1;
  }
  if (r_first > r_last) hi = lo - 1;
}

// The streamed rows [lo, hi] that fixed row r sees (none past the fixed rows).
template <bool DQ>
__device__ __forceinline__ void row_range(const BwdArgs& a, int r, int& lo, int& hi) {
  stream_range<DQ>(a, r, r, lo, hi);
  if (r >= fixed_rows<DQ>(a)) { lo = 1; hi = 0; }
}

// Prologue, q side: one warp per (b, t, h) row of the padded length Tp.
// D = rowsum(dO * O); q / sqrt(hd) and dO split into three bf16 parts, in
// [part][b * H + h][t][HDK] (columns hd .. HDK - 1 zero); lse and D into
// [b * H + h][Tp] (0 for t >= T).
template <int HDK>
__global__ void __launch_bounds__(kThreads) bwd_prep_q(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(a.B) * a.Tp * a.H) return;
  const int h = static_cast<int>(row % a.H);
  const int64_t bt = row / a.H;
  const int t = static_cast<int>(bt % a.Tp);
  const int b = static_cast<int>(bt / a.Tp);
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  if (t >= a.Tq) {
    if (lane == 0) a.lse_p[bh * a.Tp + t] = a.d_p[bh * a.Tp + t] = 0.f;
    return;
  }
  const int64_t src = q_row(a, b, t, h);
  const float* o = a.o + src;
  const float* g = a.dout + src;
  float acc = 0.f;
  for (int c = lane; c < a.hd; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    a.lse_p[bh * a.Tp + t] = a.lse[bh * a.Tq + t];
    a.d_p[bh * a.Tp + t] = acc;
  }
  const int64_t part = static_cast<int64_t>(a.B) * a.H * a.Tq * HDK / 2;  // uint32 per part
  const int64_t dst = (bh * a.Tq + t) * HDK / 2;
  split_row<HDK>(a.q + src, a.hd, a.sqrt_hd, a.qp + dst, part, lane);
  split_row<HDK>(g, a.hd, 1.f, a.dop + dst, part, lane);
}

// Prologue, kv side: k and v of each (b, t, kv head) row split into three
// bf16 parts, [part][b * KV + kvh][t][HDK]; KV1 (bf16 k/v, HDK == hd):
// copied as their one part.
template <int HDK, bool KV1 = false>
__global__ void __launch_bounds__(kThreads) bwd_prep_kv(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(a.B) * a.Tk * a.KV) return;
  const int kvh = static_cast<int>(row % a.KV);
  const int64_t bt = row / a.KV;
  const int t = static_cast<int>(bt % a.Tk);
  const int64_t b = bt / a.Tk;
  const int64_t dst = ((b * a.KV + kvh) * a.Tk + t) * HDK / 2;
  if constexpr (KV1) {
#pragma unroll
    for (int c = lane; c < HDK / 8; c += 32) {  // 16 bytes a lane
      reinterpret_cast<uint4*>(a.kp + dst)[c] = reinterpret_cast<const uint4*>(a.k16 + row * HDK / 2)[c];
      reinterpret_cast<uint4*>(a.vp + dst)[c] = reinterpret_cast<const uint4*>(a.v16 + row * HDK / 2)[c];
    }
  } else {
    const int64_t part = static_cast<int64_t>(a.B) * a.KV * a.Tk * HDK / 2;
    split_row<HDK>(a.k + row * a.hd, a.hd, 1.f, a.kp + dst, part, lane);
    split_row<HDK>(a.v + row * a.hd, a.hd, 1.f, a.vp + dst, part, lane);
  }
}

// The first of the kSplit products whose parts an A operand of ap parts and
// a B operand of bp parts hold (it overwrites the accumulator).
__host__ __device__ constexpr int first_pair(int ap, int bp) {
  for (int p = 0; p < kSplit; ++p)
    if (pair_a(p) < ap && pair_b(p) < bp) return p;
  return 0;
}

// The shared-memory address at which a product's descriptors start; with
// TURNS pinned where it is read (an empty asm the compiler cannot see
// through), so that the descriptors are rebuilt from it at each use and not
// hoisted out of the tile loop into registers the consumers lack.
template <int HD>
__device__ __forceinline__ uint32_t desc_base(uint32_t addr) {
  if constexpr (Bw<HD>::TURNS) asm volatile("" : "+r"(addr));
  return addr;
}

// acc = X . S^T over the kSplit part products whose parts both hold: X the
// 64 fixed rows (FP parts at x_parts, K-major, the A operand), S the
// streamed tile's rows (SP parts at s_parts, K-major, the B operand); the
// first overwrites.  FP or SP 1: k or v as their one bf16 part, the three
// non-zero products of the six in the same order.
template <int HD, int FP, int SP>
__device__ __forceinline__ void products_ss(float (&acc)[Bw<HD>::BS / 2], uint32_t x_parts,
                                            uint32_t s_parts) {
  using C = Bw<HD>;
  constexpr int P0 = first_pair(FP, SP);
  // a descriptor's address field is the byte address / 16: an offset into
  // shared memory adds offset / 16 to the base's descriptor
  const uint64_t da0 = gmma_desc(desc_base<HD>(x_parts), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t db0 = gmma_desc(s_parts, 16, 8 * C::SW, C::LAYOUT);
#pragma unroll
  for (int p = 0; p < kSplit; ++p) {
    if (pair_a(p) >= FP || pair_b(p) >= SP) continue;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int atom = kk * 16 / C::ATOM, col = (kk * 16 % C::ATOM) * 2;
      const uint64_t da = da0 + ((pair_a(p) * C::FIX_TILE + atom * 64 * C::SW + col) >> 4);
      const uint64_t db = db0 + ((pair_b(p) * C::STR_TILE + atom * C::BS * C::SW + col) >> 4);
      wgmma_ss<C::BS>(acc, da, db, (p != P0) | kk);
    }
  }
}

// o += A . S, A (64 x BS) in registers in the accumulator layout (P^T,
// dS^T or dS), S the streamed tile's BS rows (SP parts at s_parts, the B
// operand, MN-major through the transpose bit; SP 1: k, the products with
// its part 0), TN output columns at a time.  wgmma's float32 accumulator
// rounds its sums toward zero; over the thousands of steps of a long sum (6
// products x 16 rows each) that shrinks a gradient by ~1e-4 of itself.  So
// each tile's product runs in a fresh accumulator of kSplit x BS / 16 steps
// and is added to o with float32 (round-to-nearest) adds.
template <int HD, int SP>
__device__ __forceinline__ void products_rs(float (&o)[HD / 2], const float (&acc)[Bw<HD>::BS / 2],
                                            uint32_t s_parts) {
  using C = Bw<HD>;
  const uint64_t db0 = gmma_desc(s_parts, C::BS * C::SW, 8 * C::SW, C::LAYOUT);
#pragma unroll
  for (int c = 0; c < HD / C::TN; ++c) {
    // columns c TN .. of every row: their atom, then bytes into its rows
    const uint32_t col_off = (c * C::TN / C::ATOM) * C::BS * C::SW + (c * C::TN % C::ATOM) * 2;
    float t[C::TN / 2];
#pragma unroll
    for (int i = 0; i < C::TN / 2; ++i) t[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BS / 16; ++kk) {
      uint32_t fr[kParts][4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split3(acc[8 * kk + 2 * f], acc[8 * kk + 2 * f + 1], fr[0][f], fr[1][f], fr[2][f]);
#pragma unroll
      for (int p = 0; p < kSplit; ++p)
        if (pair_b(p) < SP)
          wgmma_rs<C::TN>(t, fr[pair_a(p)],
                          db0 + ((pair_b(p) * C::STR_TILE + col_off + kk * 16 * C::SW) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < C::TN / 2; ++i) o[c * C::TN / 2 + i] += t[i];
  }
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One block of either pass.  Grid (heads, tiles, subsets): blockIdx.x the
// fixed rows' (batch x head) (dK/dV: b * KV + kvh; dQ: b * H + h),
// blockIdx.y the tile of ROWS fixed rows, the longest first (dK/dV: the
// first key tiles, which the most queries see; dQ: the last query tiles);
// HS (the dK/dV pass's head split): blockIdx.z the subset of the group's
// query heads, and partial dK, dV written to a.kv_part.  Maps: fix0/fix1 the
// fixed operands (k, v or q, dO; boxes of 64 rows), str0/str1 the streamed
// ones (q, dO or k, v; boxes of BS rows), all over the parts [part][batch x
// head][T][HDK] (k and v where KV1: one part, [batch x kv head][T][HD]).
template <int HD, bool DQ, bool HS = false, bool KV1 = false>
__global__ void __launch_bounds__(Bw<HD>::THREADS, 1)
    bwd_wgmma(const __grid_constant__ CUtensorMap fix0, const __grid_constant__ CUtensorMap fix1,
              const __grid_constant__ CUtensorMap str0, const __grid_constant__ CUtensorMap str1,
              BwdArgs a) {
  using C = Bw<HD>;
  using L = BwL<HD, DQ, KV1>;
  static_assert(!(HS && DQ), "no such instance");
  constexpr bool LSE_SMEM = L::LSE_SMEM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_fix = smem_u32(smem), s_str = s_fix + L::OFF_STR;
  const uint32_t bar_full = s_fix + L::OFF_BAR, bar_empty = bar_full + 8 * L::STAGES;
  const uint32_t bar_fix = bar_empty + 8 * L::STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int tile = DQ ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * C::ROWS;
  const int b = DQ ? bh / a.H : bh / a.KV;
  const int h = DQ ? bh % a.H : 0;                   // dQ pass: the q head
  const int kvh = DQ ? h / a.groups : bh % a.KV;
  const int nbh_fix = DQ ? a.B * a.H : a.B * a.KV;   // batch x heads of each map
  const int nbh_str = DQ ? a.B * a.KV : a.B * a.H;
  // the dK/dV pass's query heads of the group: all, or the block's subset
  const int split = HS ? static_cast<int>(blockIdx.z) : 0;
  const int h0 = HS ? attn_plan::head_begin(split, a.nsplit, a.groups) : 0;
  const int nheads = DQ ? 1 : HS ? attn_plan::head_begin(split + 1, a.nsplit, a.groups) - h0
                                 : a.groups;
  int lo, hi;
  stream_range<DQ>(a, r0, r0 + C::ROWS - 1, lo, hi);
  const int s_first = lo / C::BS;
  const int per_head = hi >= lo ? hi / C::BS - s_first + 1 : 0;
  const int n_tiles = nheads * per_head;
  // streamed tile t < n_tiles: its first row and its (batch x head)
  auto streamed = [&](int t, int& row0, int& sbh) {
    row0 = (s_first + t % per_head) * C::BS;
    sbh = DQ ? b * a.KV + kvh : b * a.H + kvh * a.groups + h0 + t / per_head;
  };

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, C::READERS);
    }
    mbar_init(bar_fix, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      // a group of fixed rows that lies past T loads nothing (its rows are
      // masked and never stored), nor does a block that streams no tile (keys
      // that no query sees: its dK and dV rows are 0)
      const int live = n_tiles > 0 ? min(C::NWG, (fixed_rows<DQ>(a) - r0 + 63) / 64) : 0;
      mbar_expect_tx(bar_fix, live * L::FIX);
      for (int w = 0; w < live; ++w)
        for (int op = 0; op < 2; ++op)
          for (int i = 0; i < L::FP; ++i)
#pragma unroll
            for (int c = 0; c < C::NATOM; ++c)
              tma_load_3d(s_fix + w * L::FIX + (op * L::FP + i) * C::FIX_TILE + c * 64 * C::SW,
                          op ? &fix1 : &fix0, bar_fix, c * C::ATOM, r0 + 64 * w,
                          i * nbh_fix + bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % L::STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, L::STAGE + (LSE_SMEM ? 2 * C::BS * 4 : 0));
        int row0, sbh;
        streamed(t, row0, sbh);
        for (int op = 0; op < 2; ++op)
          for (int i = 0; i < L::SP; ++i)
#pragma unroll
            for (int c = 0; c < C::NATOM; ++c)
              tma_load_3d(s_str + s * L::STAGE + (op * L::SP + i) * C::STR_TILE +
                              c * C::BS * C::SW,
                          op ? &str1 : &str0, bar_full + 8 * s, c * C::ATOM, row0,
                          i * nbh_str + sbh);
        if constexpr (LSE_SMEM) {  // rows row0 .. row0 + BS - 1 < Tp of lse and D
          const int64_t at = static_cast<int64_t>(sbh) * a.Tp + row0;
          const uint32_t dst = s_fix + L::OFF_LSE + s * 2 * C::BS * 4;
          bulk_load(dst, a.lse_p + at, C::BS * 4, bar_full + 8 * s);
          bulk_load(dst + C::BS * 4, a.d_p + at, C::BS * 4, bar_full + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = (tid >> 7) - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int fg = C::TURNS ? 0 : wg;  // this warpgroup's group of fixed rows
  const int fr0 = r0 + 64 * fg;      // its first fixed row
  const uint32_t s_mine = s_fix + fg * L::FIX;
  int wlo, whi;                      // the streamed rows this warpgroup's rows see
  stream_range<DQ>(a, fr0, fr0 + 63, wlo, whi);
  int vlo[2], vhi[2];                // the streamed rows each of the thread's rows sees
#pragma unroll
  for (int e = 0; e < 2; ++e) row_range<DQ>(a, fr0 + r_lo + 8 * e, vlo[e], vhi[e]);
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};  // dQ pass: per fixed row (query)
  if (DQ) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t at = static_cast<int64_t>(bh) * a.Tp + fr0 + r_lo + 8 * e;
      lse_r[e] = a.lse_p[at];
      d_r[e] = a.d_p[at];
    }
  }
  float o0[HD / 2], o1[HD / 2];  // dK, dV (dK/dV pass) or dQ, unused (dQ pass)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o0[i] = o1[i] = 0.f;
  const bool cap = a.softcap > 0.f;  // uniform
  mbar_wait(bar_fix, 0);

  // TURNS: this warpgroup's tiles are every other one, from its own index
  for (int t = C::TURNS ? wg : 0; t < n_tiles; t += C::TURNS ? C::CWG : 1) {
    const int s = t % L::STAGES;
    int row0, sbh;
    streamed(t, row0, sbh);
    const uint32_t s_st = s_str + s * L::STAGE;
    // HANDOVER: the stage last held tile t - STAGES, the other warpgroup's,
    // and full's parity alone cannot tell t's fill from that one's (phases
    // k and k - 2 look alike).  empty's phase k - 1 ends only when the other
    // warpgroup has read t - STAGES, and its phase k only on this one's own
    // arrivals, so this wait is exact; after it full is in phase k or k + 1
    // (for t < STAGES a fresh barrier: it returns at once).
    if constexpr (L::HANDOVER) mbar_wait(bar_empty + 8 * s, ((t / L::STAGES) & 1) ^ 1);
    mbar_wait(bar_full + 8 * s, (t / L::STAGES) & 1);
    // the mask hides all of it from this warpgroup's rows (with TURNS never:
    // the block's range is its rows')
    if (!C::TURNS && (row0 > whi || row0 + C::BS - 1 < wlo)) {
      mbar_arrive(bar_empty + 8 * s);
      continue;
    }

    // acc0 = X0 . S0^T (S^T or S), acc1 = X1 . S1^T (dP^T or dP); SPLIT:
    // each product its own group, P formed while dP's products run
    constexpr bool SPLIT = HD == 64;
    float acc0[C::BS / 2], acc1[C::BS / 2], gcap[C::BS / 2];
    wgmma_fence();
    products_ss<HD, L::FP, L::SP>(acc0, s_mine, s_st);
    if constexpr (SPLIT) wgmma_commit();
    products_ss<HD, L::FP, L::SP>(acc1, s_mine + L::FP * C::FIX_TILE, s_st + L::SP * C::STR_TILE);
    wgmma_commit();
    wgmma_wait<SPLIT ? 1 : 0>();
    fence_regs(acc0);
    if constexpr (!SPLIT) fence_regs(acc1);

    // softcap (a uniform branch; gcap its derivative), mask, P and dS: acc0
    // becomes P (or P^T), acc1 dS (or dS^T), with SPLIT once dP's products
    // have finished.  lse and D belong to the query: the column here (dK/dV
    // pass; with TURNS from the stage), the row (dQ pass).
    const float* lse_s =
        reinterpret_cast<const float*>(smem + L::OFF_LSE + s * 2 * C::BS * 4);
    auto query_cols = [&](int j, float2& lse_c, float2& d_c) {  // dK/dV pass: columns 8 j + cq
      if (LSE_SMEM) {
        lse_c = *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
        d_c = *reinterpret_cast<const float2*>(lse_s + C::BS + 8 * j + cq);
      } else if (!DQ) {
        const int64_t at = static_cast<int64_t>(sbh) * a.Tp + row0 + 8 * j + cq;
        lse_c = *reinterpret_cast<const float2*>(a.lse_p + at);
        d_c = *reinterpret_cast<const float2*>(a.d_p + at);
      }
    };
#pragma unroll
    for (int j = 0; j < C::BS / 8; ++j) {
      const int c0 = row0 + 8 * j + cq;
      float2 lse_c = make_float2(0.f, 0.f), d_c = make_float2(0.f, 0.f);
      query_cols(j, lse_c, d_c);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int i = 4 * j + 2 * e + f, col = c0 + f;
          float x = acc0[i], g = 1.f;
          if (cap) {
            x = a.softcap * tanhf(x / a.softcap);
            const float u = x / a.softcap;
            g = 1.f - u * u;
          }
          const float lse = DQ ? lse_r[e] : (f ? lse_c.y : lse_c.x);
          const float dd = DQ ? d_r[e] : (f ? d_c.y : d_c.x);
          const float p = vlo[e] <= col && col <= vhi[e] ? expf(x - lse) : 0.f;
          if constexpr (SPLIT) {
            gcap[i] = g;
          } else {
            acc1[i] = p * (acc1[i] - dd) * g;
          }
          acc0[i] = p;
        }
    }
    if constexpr (SPLIT) {
      wgmma_wait<0>();
      fence_regs(acc1);
#pragma unroll
      for (int j = 0; j < C::BS / 8; ++j) {
        float2 lse_c = make_float2(0.f, 0.f), d_c = make_float2(0.f, 0.f);
        query_cols(j, lse_c, d_c);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int i = 4 * j + 2 * e + f;
            const float dd = DQ ? d_r[e] : (f ? d_c.y : d_c.x);
            acc1[i] = acc0[i] * (acc1[i] - dd) * gcap[i];
          }
      }
    }

    // dK/dV pass: dV += P^T . dO (S1), dK += dS^T . Q (S0);
    // dQ pass:    dQ += dS . K (S0).
    if (!DQ) products_rs<HD, L::SP>(o1, acc0, s_st + L::SP * C::STR_TILE);
    products_rs<HD, L::SP>(o0, acc1, s_st);
    mbar_arrive(bar_empty + 8 * s);
  }

  if constexpr (C::TURNS) {
    // the two warpgroups' sums added in a fixed order (warpgroup 0's +
    // warpgroup 1's): warpgroup 1 hands its own over through the ring,
    // which both have left (every loaded tile has been read)
    float* xch = reinterpret_cast<float*>(smem + L::OFF_STR);
    const int ltid = tid & 127;
    named_bar_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        xch[i * 128 + ltid] = o0[i];
        if (!DQ) xch[(HD / 2 + i) * 128 + ltid] = o1[i];
      }
    }
    named_bar_sync(1, 256);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      o0[i] += xch[i * 128 + ltid];
      if (!DQ) o1[i] += xch[(HD / 2 + i) * 128 + ltid];
    }
  }

  // dK/dV pass: rows are keys of kv head kvh (HS: the subset's partials
  // [split][b KV + kvh][key][HD]); dQ pass: queries of head h
  float* dk = HS ? a.kv_part : a.dk;
  float* dv = HS ? a.kv_part + static_cast<int64_t>(a.nsplit) * a.B * a.KV * a.Tk * HD : a.dv;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = fr0 + r_lo + 8 * e;
    if (r >= fixed_rows<DQ>(a)) continue;
    const int64_t at = DQ ? q_row(a, b, r, h)
                          : HS ? ((static_cast<int64_t>(split) * a.B * a.KV + bh) * a.Tk + r) * HD
                               : kv_row(a, b, r, kvh);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= a.hd) continue;
      if (DQ) {
        *reinterpret_cast<float2*>(a.dq + at + col) =
            make_float2(o0[4 * j + 2 * e] / a.sqrt_hd, o0[4 * j + 2 * e + 1] / a.sqrt_hd);
      } else {
        *reinterpret_cast<float2*>(dk + at + col) =
            make_float2(o0[4 * j + 2 * e], o0[4 * j + 2 * e + 1]);
        *reinterpret_cast<float2*>(dv + at + col) =
            make_float2(o1[4 * j + 2 * e], o1[4 * j + 2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_wide (hd 256).  384 threads: warpgroup 0 the producer, warpgroups 1
// and 2 the consumers c = 0, 1, each owning hd columns [128 c, 128 c + 128)
// of both passes' outputs.  Consumer thread (warp w, lane l of its
// warpgroup) holds fixed rows 16 w + l / 4 and 16 w + l / 4 + 8 and, in
// every 8-column block j of an accumulator, columns 8 j + 2 (l % 4) and the
// next one.
// ---------------------------------------------------------------------------

struct Wd {
  static constexpr int HD = 256;
  static constexpr int BS = 16;                     // rows of a streamed tile
  static constexpr int SW = 128, ATOM = 64, NATOM = HD / ATOM;
  static constexpr uint64_t LAYOUT = 1;             // 128-byte swizzle
  static constexpr int HALF = HD / 2;               // columns of a consumer warpgroup
  static constexpr int TN = 64;                     // output columns per fresh product
  static constexpr int ITEM_PART = NATOM * BS * SW; // one part of a streamed tile: 8 KB
  static constexpr int ITEM = kParts * ITEM_PART;   // a tile's three parts: 24 KB
  static constexpr int FIX_FLOATS = 64 * HD;        // one fixed operand, float32: 64 KB
  static constexpr int XCH_FLOATS = 2 * 16 * 128;   // both consumers' S and dP partials: 16 KB
  static constexpr int THREADS = 384;
};

// An instance's shared memory: the ring of SLOTS items (one operand of a
// streamed tile, SP parts), the two fixed operands (float32, or bf16 where
// FIX16: k and v of the dK/dV pass on bf16 k/v), the S/dP swap, barriers.
// float32 k/v: 3 x 24 KB + 2 x 64 KB + 16 KB; bf16 k/v: dK/dV 6 x 24 KB + 2
// x 32 KB + 16 KB, dQ 8 x 8 KB + 2 x 64 KB + 16 KB.
template <bool DQ, bool KV1>
struct WdL {
  static constexpr bool FIX16 = !DQ && KV1;
  static constexpr int FP = FIX16 ? 1 : kParts;          // parts of a fixed operand's A fragment
  static constexpr int SP = DQ && KV1 ? 1 : kParts;      // parts of a streamed item
  static constexpr int ITEM = SP * Wd::ITEM_PART;
  static constexpr int SLOTS = !KV1 ? 3 : DQ ? 8 : 6;
  static constexpr int FIX_BYTES = FIX16 ? 2 * Wd::FIX_FLOATS : 4 * Wd::FIX_FLOATS;
  static constexpr int OFF_FIX = SLOTS * ITEM;
  static constexpr int OFF_XCH = OFF_FIX + 2 * FIX_BYTES;
  static constexpr int OFF_BAR = OFF_XCH + 4 * Wd::XCH_FLOATS;
  static constexpr size_t kSmem = OFF_BAR + 2 * SLOTS * 8 + 1024;  // + base alignment
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// The A fragment of 16 columns (k-step kk) of a fixed operand (float32 in
// shared memory, [row][128 float2 slots], slot s of row r stored at
// s ^ ((r & 3) << 2)), rows r and r + 8, split into its three bf16 parts.
__device__ __forceinline__ void fix_frag(const float* fix, int r, int cq, int kk,
                                         uint32_t (&fr)[kParts][4]) {
  const int sw = (r & 3) << 2;  // r + 8: the same
  const int s0 = (8 * kk + cq / 2) ^ sw, s1 = (8 * kk + cq / 2 + 4) ^ sw;
  const float2 x0 = *reinterpret_cast<const float2*>(fix + r * Wd::HD + 2 * s0);
  const float2 x1 = *reinterpret_cast<const float2*>(fix + (r + 8) * Wd::HD + 2 * s0);
  const float2 x2 = *reinterpret_cast<const float2*>(fix + r * Wd::HD + 2 * s1);
  const float2 x3 = *reinterpret_cast<const float2*>(fix + (r + 8) * Wd::HD + 2 * s1);
  split3(x0.x, x0.y, fr[0][0], fr[1][0], fr[2][0]);
  split3(x1.x, x1.y, fr[0][1], fr[1][1], fr[2][1]);
  split3(x2.x, x2.y, fr[0][2], fr[1][2], fr[2][2]);
  split3(x3.x, x3.y, fr[0][3], fr[1][3], fr[2][3]);
}

// The A fragment of k-step kk of a bf16 fixed operand (shared memory, [row]
// [128 pair slots], slot s of row r stored at s ^ ((r & 7) << 2)), rows r
// and r + 8: its one part, read as it is.
__device__ __forceinline__ void fix_frag16(const uint32_t* fix, int r, int cq, int kk,
                                           uint32_t (&fr)[1][4]) {
  const int sw = (r & 7) << 2;  // r + 8: the same
  const int s0 = (8 * kk + cq / 2) ^ sw, s1 = (8 * kk + cq / 2 + 4) ^ sw;
  fr[0][0] = fix[r * (Wd::HD / 2) + s0];
  fr[0][1] = fix[(r + 8) * (Wd::HD / 2) + s0];
  fr[0][2] = fix[r * (Wd::HD / 2) + s1];
  fr[0][3] = fix[(r + 8) * (Wd::HD / 2) + s1];
}

// acc = X . S^T over this warpgroup's 128 columns: X the fixed operand
// (A: FP == 3 float32, split in registers; FP == 1 bf16), S the streamed
// tile's 16 rows (SP parts at `item`, K-major, the B operand); the kSplit
// products whose parts both hold, per k-step, the first overwrites.  Each
// k-step's products are a group, two groups in flight: a k-step's fragment
// registers are rewritten once the one before it has finished.
template <int FP, int SP>
__device__ __forceinline__ void wide_scores(float (&acc)[8], const void* fix, uint32_t item,
                                            int wg, int r, int cq) {
  using C = Wd;
  constexpr int NK = C::HALF / 16;  // k-steps of this warpgroup's columns
  constexpr int P0 = first_pair(FP, SP);
  uint32_t fr[2][FP][4];
#pragma unroll
  for (int u = 0; u < NK; ++u) {
    const int kk = wg * NK + u;
    if constexpr (FP == 1) {
      fix_frag16(static_cast<const uint32_t*>(fix), r, cq, kk, fr[u & 1]);
    } else {
      fix_frag(static_cast<const float*>(fix), r, cq, kk, fr[u & 1]);
    }
    wgmma_fence();
    const uint32_t col = (kk * 16 / C::ATOM) * (C::BS * C::SW) + (kk * 16 % C::ATOM) * 2;
#pragma unroll
    for (int p = 0; p < kSplit; ++p)
      if (pair_a(p) < FP && pair_b(p) < SP)
        wgmma_rs_n16_k(acc, fr[u & 1][pair_a(p) < FP ? pair_a(p) : 0],
                       gmma_desc(item + pair_b(p) * C::ITEM_PART + col, 16, 8 * C::SW, C::LAYOUT),
                       u | (p != P0));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// t = A . S over one TN-column slice (c) of this warpgroup's columns: A
// (64 x 16: P^T, dS^T or dS) as three bf16 parts in registers, S the
// streamed tile (SP parts at `item`, MN-major through the transpose bit),
// the kSplit products whose parts S holds, in a fresh accumulator (finding
// 7); committed, not waited for.
template <int SP>
__device__ __forceinline__ void wide_slice(float (&t)[Wd::TN / 2], const uint32_t (&fr)[kParts][4],
                                           uint32_t item, int wg, int c) {
  using C = Wd;
  const int col = wg * C::HALF + c * C::TN;
  const uint32_t start = item + (col / C::ATOM) * (C::BS * C::SW) + (col % C::ATOM) * 2;
#pragma unroll
  for (int i = 0; i < C::TN / 2; ++i) t[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < kSplit; ++p)
    if (pair_b(p) < SP)
      wgmma_rs<C::TN>(t, fr[pair_a(p)], gmma_desc(start + pair_b(p) * C::ITEM_PART, C::BS * C::SW,
                                                  8 * C::SW, C::LAYOUT));
  wgmma_commit();
}

// o's slice c += t, once t's products have finished (the caller waits), in
// float32
__device__ __forceinline__ void add_slice(float (&o)[Wd::HALF / 2], float (&t)[Wd::TN / 2], int c) {
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < Wd::TN / 2; ++i) o[c * Wd::TN / 2 + i] += t[i];
}

// One block of either pass.  Grid (heads, tiles) as bwd_wgmma's, 64 fixed
// rows; HS (the dK/dV pass's head split): grid z the subset of the group's
// query heads, and partial dK, dV written to a.kv_part.  str0 / str1: the
// streamed operands' parts [part][batch x head][T][256], boxes of 16 rows;
// dK/dV pass q (0) and dO (1), dQ pass v (0) and k (1): the order in which
// a tile's two operands are last read, so the ring frees its slots in
// order.  DS (the dK/dV pass on the dS path): dS also stored, to a.ds.
// KV1: bf16 k/v, one part (WdL).
template <bool DQ, bool DS = false, bool HS = false, bool KV1 = false>
__global__ void __launch_bounds__(Wd::THREADS, 1)
    bwd_wide(const __grid_constant__ CUtensorMap str0, const __grid_constant__ CUtensorMap str1,
             BwdArgs a) {
  using C = Wd;
  using L = WdL<DQ, KV1>;
  static_assert(!(DS && (DQ || HS || KV1)) && !(HS && DQ), "no such instance");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_ring = smem_u32(smem);
  uint8_t* fix = smem + L::OFF_FIX;                          // [S's, dP's][64][256]
  float* xch = reinterpret_cast<float*>(smem + L::OFF_XCH);  // [consumer][16][128]
  const uint32_t bar_full = s_ring + L::OFF_BAR, bar_empty = bar_full + 8 * L::SLOTS;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int tile = DQ ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * 64;
  const int b = DQ ? bh / a.H : bh / a.KV;
  const int h = DQ ? bh % a.H : 0;                   // dQ pass: the q head
  const int kvh = DQ ? h / a.groups : bh % a.KV;
  const int nbh_str = DQ ? a.B * a.KV : a.B * a.H;
  // the dK/dV pass's query heads of the group: all, or the block's subset
  const int split = HS ? static_cast<int>(blockIdx.z) : 0;
  const int h0 = HS ? attn_plan::head_begin(split, a.nsplit, a.groups) : 0;
  const int nheads = DQ ? 1 : HS ? attn_plan::head_begin(split + 1, a.nsplit, a.groups) - h0
                                 : a.groups;
  int lo, hi;
  stream_range<DQ>(a, r0, r0 + 63, lo, hi);
  const int s_first = lo / C::BS;
  const int per_head = hi >= lo ? hi / C::BS - s_first + 1 : 0;
  const int n_tiles = nheads * per_head;
  auto streamed = [&](int t, int& row0, int& sbh) {
    row0 = (s_first + t % per_head) * C::BS;
    sbh = DQ ? b * a.KV + kvh : b * a.H + kvh * a.groups + h0 + t / per_head;
  };

  if (tid == 0) {
    for (int s = 0; s < L::SLOTS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      for (int i = 0; i < 2 * n_tiles; ++i) {  // item i: operand i & 1 of tile i >> 1
        const int s = i % L::SLOTS;
        mbar_wait(bar_empty + 8 * s, ((i / L::SLOTS) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, L::ITEM);
        int row0, sbh;
        streamed(i >> 1, row0, sbh);
        for (int part = 0; part < L::SP; ++part)
#pragma unroll
          for (int c = 0; c < C::NATOM; ++c)
            tma_load_3d(s_ring + s * L::ITEM + part * C::ITEM_PART + c * C::BS * C::SW,
                        (i & 1) ? &str1 : &str0, bar_full + 8 * s, c * C::ATOM, row0,
                        part * nbh_str + sbh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = (tid >> 7) - 1, ltid = tid & 127, warp = ltid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;

  // the fixed rows' two operands, this warpgroup's columns: dK/dV pass k
  // (S^T's) and v (dP^T's), float32 or (FIX16) bf16 from their one part;
  // dQ pass q / sqrt(hd) (S's) and dO (dP's), float32; zeros past T
  if constexpr (L::FIX16) {
    uint32_t* fix16 = reinterpret_cast<uint32_t*>(fix);
    constexpr int V = C::HALF / 8;  // 16-byte pieces of a row's half
    for (int i = ltid; i < 2 * 64 * V; i += 128) {
      const int f = i / (64 * V), r = i / V % 64;
      const int slot = C::HALF / 2 * wg + 4 * (i % V);  // its first pair slot
      const int row = r0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < a.Tk)
        x = *reinterpret_cast<const uint4*>(
            (f ? a.vp : a.kp) + (static_cast<int64_t>(b * a.KV + kvh) * a.Tk + row) * (C::HD / 2) +
            slot);
      *reinterpret_cast<uint4*>(fix16 + f * (64 * C::HD / 2) + r * (C::HD / 2) +
                                (slot ^ ((r & 7) << 2))) = x;  // 4-slot runs stay together
    }
  } else {
    float* fix32 = reinterpret_cast<float*>(fix);
    for (int i = ltid; i < 2 * 64 * (C::HALF / 4); i += 128) {
      const int f = i / (64 * (C::HALF / 4)), r = i / (C::HALF / 4) % 64;
      const int col = C::HALF * wg + 4 * (i % (C::HALF / 4));
      const int row = r0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < fixed_rows<DQ>(a)) {
        const float* src = DQ ? (f ? a.dout : a.q) + q_row(a, b, row, h)
                              : (f ? a.v : a.k) + kv_row(a, b, row, kvh);
        x = *reinterpret_cast<const float4*>(src + col);
        if (DQ && f == 0) {
          x.x /= a.sqrt_hd; x.y /= a.sqrt_hd; x.z /= a.sqrt_hd; x.w /= a.sqrt_hd;
        }
      }
      const int slot = (col / 2) ^ ((r & 3) << 2);  // even: the pair stays together
      *reinterpret_cast<float4*>(fix32 + f * C::FIX_FLOATS + r * C::HD + 2 * slot) = x;
    }
  }
  named_bar_sync(2 + wg, 128);
  const void* fix_s = fix;
  const void* fix_dp = fix + L::FIX_BYTES;

  int vlo[2], vhi[2];  // the streamed rows each of the thread's rows sees
#pragma unroll
  for (int e = 0; e < 2; ++e) row_range<DQ>(a, r0 + r_lo + 8 * e, vlo[e], vhi[e]);
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};  // dQ pass: per fixed row (query)
  if (DQ) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t at = static_cast<int64_t>(bh) * a.Tp + r0 + r_lo + 8 * e;
      lse_r[e] = a.lse_p[at];
      d_r[e] = a.d_p[at];
    }
  }
  float o0[C::HALF / 2], o1[C::HALF / 2];  // dK, dV (dK/dV pass) or dQ, unused (dQ pass)
#pragma unroll
  for (int i = 0; i < C::HALF / 2; ++i) o0[i] = o1[i] = 0.f;
  const bool cap = a.softcap > 0.f;  // uniform
  float* xch_mine = xch + wg * 16 * 128;
  const float* xch_other = xch + (1 - wg) * 16 * 128;

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = (2 * t) % L::SLOTS, s1 = (2 * t + 1) % L::SLOTS;
    const uint32_t it0 = s_ring + s0 * L::ITEM, it1 = s_ring + s1 * L::ITEM;
    int row0, sbh;
    streamed(t, row0, sbh);

    // this warpgroup's part of S (S^T) and dP (dP^T), item 0's first
    float acc_s[8], acc_dp[8];
    mbar_wait(bar_full + 8 * s0, ((2 * t) / L::SLOTS) & 1);
    if constexpr (DQ) {
      wide_scores<L::FP, L::SP>(acc_dp, fix_dp, it0, wg, r_lo, cq);
    } else {
      wide_scores<L::FP, L::SP>(acc_s, fix_s, it0, wg, r_lo, cq);
    }
    mbar_wait(bar_full + 8 * s1, ((2 * t + 1) / L::SLOTS) & 1);
    if constexpr (DQ) {
      wide_scores<L::FP, L::SP>(acc_s, fix_s, it1, wg, r_lo, cq);
      mbar_arrive(bar_empty + 8 * s0);  // v is read for the last time
    } else {
      wide_scores<L::FP, L::SP>(acc_dp, fix_dp, it1, wg, r_lo, cq);
    }

    // the two halves summed (a + b == b + a: both warpgroups get the same S, dP)
    if (t > 0) named_bar_sync(1, 256);  // the other one has read the last tile's
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xch_mine[i * 128 + ltid] = acc_s[i];
      xch_mine[(8 + i) * 128 + ltid] = acc_dp[i];
    }
    named_bar_sync(1, 256);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc_s[i] += xch_other[i * 128 + ltid];
      acc_dp[i] += xch_other[(8 + i) * 128 + ltid];
    }

    // softcap (a uniform branch), mask, P and dS; acc_s becomes P (or
    // P^T), acc_dp dS (or dS^T).  lse and D belong to the query: the
    // column here (dK/dV pass), the row (dQ pass).
#pragma unroll
    for (int j = 0; j < C::BS / 8; ++j) {
      const int c0 = row0 + 8 * j + cq;
      float2 lse_c = make_float2(0.f, 0.f), d_c = make_float2(0.f, 0.f);
      if (!DQ) {
        const int64_t at = static_cast<int64_t>(sbh) * a.Tp + c0;
        lse_c = *reinterpret_cast<const float2*>(a.lse_p + at);
        d_c = *reinterpret_cast<const float2*>(a.d_p + at);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int i = 4 * j + 2 * e + f, col = c0 + f;
          float x = acc_s[i], g = 1.f;
          if (cap) {
            x = a.softcap * tanhf(x / a.softcap);
            const float u = x / a.softcap;
            g = 1.f - u * u;
          }
          const float lse = DQ ? lse_r[e] : (f ? lse_c.y : lse_c.x);
          const float dd = DQ ? d_r[e] : (f ? d_c.y : d_c.x);
          const float p = vlo[e] <= col && col <= vhi[e] ? expf(x - lse) : 0.f;
          acc_dp[i] = p * (acc_dp[i] - dd) * g;
          acc_s[i] = p;
        }
    }
    if constexpr (DS) {
      // the dS path: dS^T's key row r0 + r_lo + 8 wg (both warpgroups hold
      // the same dS; each stores one of its two rows) into dS [q head][query][key]
      const int key = r0 + r_lo + 8 * wg;
      if (key < a.Tk) {
        float* dst = a.ds + static_cast<int64_t>(sbh) * a.Tq * a.Tk + key;
#pragma unroll
        for (int j = 0; j < C::BS / 8; ++j)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int qi = row0 + 8 * j + cq + f;
            if (qi < a.Tq)
              dst[static_cast<int64_t>(qi) * a.Tk] = wg ? acc_dp[4 * j + 2 + f] : acc_dp[4 * j + f];
          }
      }
    }
    uint32_t fp[kParts][4], fd[kParts][4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      split3(acc_s[2 * f], acc_s[2 * f + 1], fp[0][f], fp[1][f], fp[2][f]);
      split3(acc_dp[2 * f], acc_dp[2 * f + 1], fd[0][f], fd[1][f], fd[2][f]);
    }

    // dK/dV pass: dK += dS^T . Q (item 0), then dV += P^T . dO (item 1);
    // dQ pass:    dQ += dS . K (item 1).  TN-column slices, two fresh
    // accumulators in turn: a slice's products run while the one before is
    // added.
    constexpr int NSL = C::HALF / C::TN;  // slices per output
    constexpr int NS = (DQ ? 1 : 2) * NSL;
    float tt[2][C::TN / 2];
#pragma unroll
    for (int q = 0; q <= NS; ++q) {
      if (q < NS) {
        if (DQ || q < NSL) {
          wide_slice<L::SP>(tt[q & 1], fd, DQ ? it1 : it0, wg, q % NSL);
        } else {
          wide_slice<L::SP>(tt[q & 1], fp, it1, wg, q % NSL);
        }
      }
      if (q > 0) {
        if (q < NS) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        const int d = q - 1;  // the slice that has finished
        if (d < NSL) {
          add_slice(o0, tt[d & 1], d);
        } else {
          add_slice(o1, tt[d & 1], d - NSL);
        }
        if (!DQ && d == NSL - 1) mbar_arrive(bar_empty + 8 * s0);  // q is read for the last time
      }
    }
    mbar_arrive(bar_empty + 8 * s1);
  }

  // dK/dV pass: rows are keys of kv head kvh (HS: the subset's partials
  // [split][b KV + kvh][key]); dQ pass: queries of head h
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + r_lo + 8 * e;
    if (r >= fixed_rows<DQ>(a)) continue;
    const int64_t at =
        DQ ? q_row(a, b, r, h)
           : HS ? ((static_cast<int64_t>(split) * a.B * a.KV + bh) * a.Tk + r) * C::HD
                : kv_row(a, b, r, kvh);
    float* dk = HS ? a.kv_part : a.dk;
    float* dv = HS ? a.kv_part + static_cast<int64_t>(a.nsplit) * a.B * a.KV * a.Tk * C::HD : a.dv;
#pragma unroll
    for (int j = 0; j < C::HALF / 8; ++j) {
      const int col = C::HALF * wg + 8 * j + cq;
      if (DQ) {
        *reinterpret_cast<float2*>(a.dq + at + col) =
            make_float2(o0[4 * j + 2 * e] / a.sqrt_hd, o0[4 * j + 2 * e + 1] / a.sqrt_hd);
      } else {
        *reinterpret_cast<float2*>(dk + at + col) =
            make_float2(o0[4 * j + 2 * e], o0[4 * j + 2 * e + 1]);
        *reinterpret_cast<float2*>(dv + at + col) =
            make_float2(o1[4 * j + 2 * e], o1[4 * j + 2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_dq_ds (the dS path's dQ, hd 256).  Grid (B x H, Tq / 64, nchunk), the
// longest row tiles first; 384 threads as bwd_wide's: warpgroup 0 the
// producer (one thread streams k's parts, 16-row items, through a ring of
// kDsSlots), warpgroups 1, 2 the consumers, each owning 128 of dQ's 256
// columns, with bwd_wide's fragment layout.  kmap: k's parts [part][B KV]
// [Tk][256], boxes of 16 rows.  part == nullptr (one chunk): dQ / sqrt(hd)
// written here; else the chunk's partial [nchunk][B H][Tq][256] (unscaled).
// ---------------------------------------------------------------------------

constexpr int kDsSlots = 8;
constexpr size_t kDsSmem = kDsSlots * Wd::ITEM + 2 * kDsSlots * 8 + 1024;  // + base alignment

__global__ void __launch_bounds__(Wd::THREADS, 1)
    bwd_dq_ds(const __grid_constant__ CUtensorMap kmap, BwdArgs a, int nchunk, int k_begin,
              int k_end, float* part) {
  using C = Wd;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t bar_full = s_ring + kDsSlots * C::ITEM, bar_empty = bar_full + 8 * kDsSlots;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kvh = h / a.groups;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int chunk = blockIdx.z;
  int lo, hi;  // the keys of this chunk that the block's rows see, as 16-key items
  stream_range<true>(a, r0, r0 + 63, lo, hi);
  lo = max(lo, attn_plan::chunk_begin(chunk, nchunk, k_begin, k_end));
  hi = min(hi, attn_plan::chunk_begin(chunk + 1, nchunk, k_begin, k_end) - 1);
  const int s_first = lo / C::BS;
  const int n_items = hi >= lo ? hi / C::BS - s_first + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kDsSlots; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      const int nbh = a.B * a.KV;
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kDsSlots;
        mbar_wait(bar_empty + 8 * s, ((i / kDsSlots) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, C::ITEM);
        for (int p = 0; p < kParts; ++p)
#pragma unroll
          for (int c = 0; c < C::NATOM; ++c)
            tma_load_3d(s_ring + s * C::ITEM + p * C::ITEM_PART + c * C::BS * C::SW, &kmap,
                        bar_full + 8 * s, c * C::ATOM, (s_first + i) * C::BS,
                        p * nbh + b * a.KV + kvh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = (tid >> 7) - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  int vlo[2], vhi[2];  // the keys each of the thread's rows sees (none past Tq)
  const float* ds_row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + r_lo + 8 * e;
    row_range<true>(a, r, vlo[e], vhi[e]);  // a row past Tq sees none
    ds_row[e] = a.ds + (r < a.Tq ? (static_cast<int64_t>(bh) * a.Tq + r) * a.Tk : 0);
  }
  // item i's A fragment (dS, rows r_lo, r_lo + 8 x keys cq, cq + 1, cq + 8,
  // cq + 9 of the item): zeros outside each row's visible keys, which are
  // never read
  auto load = [&](int i, float (&x)[8]) {
    const int k0 = (s_first + i) * C::BS + cq;
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = f & 1, key = k0 + 8 * (f >> 1) + u;
        x[2 * f + u] = vlo[e] <= key && key <= vhi[e] ? __ldg(ds_row[e] + key) : 0.f;
      }
  };
  float o0[C::HALF / 2];
#pragma unroll
  for (int i = 0; i < C::HALF / 2; ++i) o0[i] = 0.f;
  float cur[8];
  if (n_items > 0) load(0, cur);

  for (int i = 0; i < n_items; ++i) {
    const int s = i % kDsSlots;
    const uint32_t item = s_ring + s * C::ITEM;
    float nxt[8];  // the next item's dS, in flight during this item's products
    if (i + 1 < n_items) load(i + 1, nxt);
    uint32_t fd[kParts][4];
#pragma unroll
    for (int f = 0; f < 4; ++f) split3(cur[2 * f], cur[2 * f + 1], fd[0][f], fd[1][f], fd[2][f]);
    mbar_wait(bar_full + 8 * s, (i / kDsSlots) & 1);
    // dQ += dS . K: TN-column slices, two fresh accumulators in turn
    constexpr int NSL = C::HALF / C::TN;
    float tt[2][C::TN / 2];
#pragma unroll
    for (int q = 0; q <= NSL; ++q) {
      if (q < NSL) wide_slice<kParts>(tt[q & 1], fd, item, wg, q);
      if (q > 0) {
        if (q < NSL) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        add_slice(o0, tt[(q - 1) & 1], q - 1);
      }
    }
    mbar_arrive(bar_empty + 8 * s);
#pragma unroll
    for (int u = 0; u < 8; ++u) cur[u] = i + 1 < n_items ? nxt[u] : 0.f;
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + r_lo + 8 * e;
    if (r >= a.Tq) continue;
    float* dst = part == nullptr
                     ? a.dq + q_row(a, b, r, h)
                     : part + ((static_cast<int64_t>(chunk) * a.B * a.H + bh) * a.Tq + r) * C::HD;
    const float div = part == nullptr ? a.sqrt_hd : 1.f;  // a partial is merged unscaled
#pragma unroll
    for (int j = 0; j < C::HALF / 8; ++j) {
      const int col = C::HALF * wg + 8 * j + cq;
      *reinterpret_cast<float2*>(dst + col) =
          make_float2(o0[4 * j + 2 * e] / div, o0[4 * j + 2 * e + 1] / div);
    }
  }
}

// dQ = the chunks' partials summed in chunk order / sqrt(hd): one thread per
// 4 columns of a (b, t, h) row.
__global__ void __launch_bounds__(kThreads) bwd_dq_merge(BwdArgs a, int nchunk, const float* part) {
  constexpr int V = Wd::HD / 4;
  const int64_t n = static_cast<int64_t>(a.B) * a.H * a.Tq * V;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int col = static_cast<int>(i % V) * 4;
  const int64_t row = i / V;  // (b H + h) Tq + t
  const int t = static_cast<int>(row % a.Tq);
  const int bh = static_cast<int>(row / a.Tq), b = bh / a.H, h = bh % a.H;
  const int64_t stride = static_cast<int64_t>(a.B) * a.H * a.Tq * Wd::HD;
  float4 sum = *reinterpret_cast<const float4*>(part + row * Wd::HD + col);
  for (int c = 1; c < nchunk; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(part + c * stride + row * Wd::HD + col);
    sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
  }
  *reinterpret_cast<float4*>(a.dq + q_row(a, b, t, h) + col) =
      make_float4(sum.x / a.sqrt_hd, sum.y / a.sqrt_hd, sum.z / a.sqrt_hd, sum.w / a.sqrt_hd);
}

// dk, dv = the head subsets' partials ([nsplit][B KV][Tk][HDK] each) summed
// in subset order: one thread per 4 columns (below hd) of a (b, t, kv head) row.
template <int HDK>
__global__ void __launch_bounds__(kThreads) bwd_kv_merge(BwdArgs a) {
  constexpr int V = HDK / 4;
  const int64_t n = static_cast<int64_t>(a.B) * a.KV * a.Tk * V;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int col = static_cast<int>(i % V) * 4;
  if (col >= a.hd) return;
  const int64_t row = i / V;  // (b KV + kvh) Tk + t
  const int t = static_cast<int>(row % a.Tk);
  const int bkv = static_cast<int>(row / a.Tk), b = bkv / a.KV, kvh = bkv % a.KV;
  const int64_t stride = static_cast<int64_t>(a.B) * a.KV * a.Tk * HDK;
  const float* pk = a.kv_part + row * HDK + col;
  const float* pv = pk + a.nsplit * stride;
  float4 sk = *reinterpret_cast<const float4*>(pk), sv = *reinterpret_cast<const float4*>(pv);
  for (int c = 1; c < a.nsplit; ++c) {
    const float4 xk = *reinterpret_cast<const float4*>(pk + c * stride);
    const float4 xv = *reinterpret_cast<const float4*>(pv + c * stride);
    sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
    sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
  }
  *reinterpret_cast<float4*>(a.dk + kv_row(a, b, t, kvh) + col) = sk;
  *reinterpret_cast<float4*>(a.dv + kv_row(a, b, t, kvh) + col) = sv;
}

// The head split's merge of the dK and dV partials.
template <int HDK>
cudaError_t launch_kv_merge(const BwdArgs& a, cudaStream_t s) {
  const int64_t n = static_cast<int64_t>(a.B) * a.KV * a.Tk * (HDK / 4);
  bwd_kv_merge<HDK><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int HD, bool DQ, bool HS = false, bool KV1 = false>
cudaError_t launch_pass(const BwdArgs& a, cudaStream_t s) {
  using C = Bw<HD>;
  using L = BwL<HD, DQ, KV1>;
  CUtensorMap f0, f1, s0, s1;
  const int nq = a.B * a.H, nk = a.B * a.KV;
  // fixed: 64-row boxes of k, v (dK/dV pass) or q, dO (dQ pass); streamed:
  // BS-row boxes of the other two
  const void* fix[2] = {DQ ? a.qp : a.kp, DQ ? a.dop : a.vp};
  const void* str[2] = {DQ ? a.kp : a.qp, DQ ? a.vp : a.dop};
  const int64_t nfix = static_cast<int64_t>(L::FP) * (DQ ? nq : nk);
  const int64_t nstr = static_cast<int64_t>(L::SP) * (DQ ? nk : nq);
  const int tfix = DQ ? a.Tq : a.Tk, tstr = DQ ? a.Tk : a.Tq;
  const bool ok = make_parts_map(&f0, fix[0], HD, tfix, nfix, 64, C::ATOM, C::SW) &&
                  make_parts_map(&f1, fix[1], HD, tfix, nfix, 64, C::ATOM, C::SW) &&
                  make_parts_map(&s0, str[0], HD, tstr, nstr, C::BS, C::ATOM, C::SW) &&
                  make_parts_map(&s1, str[1], HD, tstr, nstr, C::BS, C::ATOM, C::SW);
  if (!ok) return cudaErrorInvalidValue;
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(bwd_wgmma<HD, DQ, HS, KV1>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(L::kSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid(DQ ? nq : nk, (tfix + C::ROWS - 1) / C::ROWS, HS ? a.nsplit : 1);
  bwd_wgmma<HD, DQ, HS, KV1><<<grid, C::THREADS, L::kSmem, s>>>(f0, f1, s0, s1, a);
  const cudaError_t e2 = cudaGetLastError();
  if constexpr (HS) {
    if (e2 == cudaSuccess) return launch_kv_merge<HD>(a, s);
  }
  return e2;
}

// The dS path's dQ: bwd_dq_ds over nchunk chunks of keys [k_begin, k_end),
// then (more than one chunk) bwd_dq_merge of the partials in `part`.
cudaError_t launch_dq_ds(const BwdArgs& a, int nchunk, int k_begin, int k_end, float* part,
                         cudaStream_t s) {
  using C = Wd;
  CUtensorMap km;
  if (!make_parts_map(&km, a.kp, C::HD, a.Tk, static_cast<int64_t>(kParts) * a.B * a.KV, C::BS,
                      C::ATOM, C::SW))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(bwd_dq_ds, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kDsSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.H, (a.Tq + 63) / 64, nchunk);
  bwd_dq_ds<<<grid, C::THREADS, kDsSmem, s>>>(km, a, nchunk, k_begin, k_end,
                                               nchunk > 1 ? part : nullptr);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess || nchunk == 1) return e2;
  const int64_t n = static_cast<int64_t>(a.B) * a.H * a.Tq * (C::HD / 4);
  bwd_dq_merge<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      a, nchunk, part);
  return cudaGetLastError();
}

template <bool DQ, bool DS = false, bool HS = false, bool KV1 = false>
cudaError_t launch_wide(const BwdArgs& a, cudaStream_t s) {
  using C = Wd;
  using L = WdL<DQ, KV1>;
  CUtensorMap s0, s1;
  // streamed: dK/dV pass q, dO; dQ pass v, k (16-row boxes)
  const void* str[2] = {DQ ? a.vp : a.qp, DQ ? a.kp : a.dop};
  const int64_t nstr = static_cast<int64_t>(L::SP) * (DQ ? a.B * a.KV : a.B * a.H);
  const int tfix = DQ ? a.Tq : a.Tk, tstr = DQ ? a.Tk : a.Tq;
  if (!make_parts_map(&s0, str[0], C::HD, tstr, nstr, C::BS, C::ATOM, C::SW) ||
      !make_parts_map(&s1, str[1], C::HD, tstr, nstr, C::BS, C::ATOM, C::SW))
    return cudaErrorInvalidValue;
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(bwd_wide<DQ, DS, HS, KV1>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(L::kSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid(DQ ? a.B * a.H : a.B * a.KV, (tfix + 63) / 64, HS ? a.nsplit : 1);
  bwd_wide<DQ, DS, HS, KV1><<<grid, C::THREADS, L::kSmem, s>>>(s0, s1, a);
  const cudaError_t e2 = cudaGetLastError();
  if constexpr (HS) {
    if (e2 == cudaSuccess) return launch_kv_merge<C::HD>(a, s);
  }
  return e2;
}

// bwd_wide's recomputing passes: dK/dV (head split where nsplit > 1), then
// dQ; KV1 the bf16-k/v instances.
template <bool KV1>
cudaError_t launch_wide_passes(const BwdArgs& a, cudaStream_t s) {
  const cudaError_t e = a.nsplit > 1 ? launch_wide<false, false, true, KV1>(a, s)
                                     : launch_wide<false, false, false, KV1>(a, s);
  if (e != cudaSuccess) return e;
  return launch_wide<true, false, false, KV1>(a, s);
}

// bwd_wgmma's passes: dK/dV (at hd 128 the head split's instance where
// nsplit > 1; attn_plan.h gives 32 and 64 one subset), then dQ; KV1 the
// bf16-k/v instances (hd 64).
template <int HD, bool KV1>
cudaError_t launch_wgmma_passes(const BwdArgs& a, cudaStream_t s) {
  cudaError_t e;
  if constexpr (HD == 128) {
    e = a.nsplit > 1 ? launch_pass<HD, false, true>(a, s) : launch_pass<HD, false>(a, s);
  } else {
    if (a.nsplit > 1) return cudaErrorInvalidValue;
    e = launch_pass<HD, false, false, KV1>(a, s);
  }
  if (e != cudaSuccess) return e;
  return launch_pass<HD, true, false, KV1>(a, s);
}

// The prologues, then the two passes: bwd_wgmma<HD, false / true>, or at hd
// 256 bwd_wide's recomputing passes (launch_wide_passes) or, where
// attn_plan.h's bwd_dq_chunks picks the dS path (nchunk > 0),
// bwd_wide<false, true> (dS stored) and bwd_dq_ds.  kv_parts 1: bf16 k/v
// (bwd_wgmma at hd 64, bwd_wide's recomputing passes).  The scratch as
// attn_plan::bwd_layout lays it out.
template <int HD>
cudaError_t launch_wgmma(BwdArgs a, void* scratch, int nchunk, int k_begin, int k_end,
                         int nsplit, int kv_parts, cudaStream_t s) {
  constexpr bool kKv1 = attn_plan::has_kv1(HD);  // the widths with bf16-k/v instances
  if (kv_parts == 1 && !kKv1) return cudaErrorInvalidValue;
  a.Tp = (a.Tq + kPadRows - 1) / kPadRows * kPadRows;
  const attn_plan::BwdLayout l =
      attn_plan::bwd_layout(HD, a.B, a.Tq, a.Tk, a.H, a.KV, nchunk, nsplit, kv_parts);
  uint8_t* p = static_cast<uint8_t*>(scratch);
  a.qp = reinterpret_cast<uint32_t*>(p + l.qp);
  a.dop = reinterpret_cast<uint32_t*>(p + l.dop);
  a.kp = reinterpret_cast<uint32_t*>(p + l.kp);
  a.vp = reinterpret_cast<uint32_t*>(p + l.vp);
  a.lse_p = reinterpret_cast<float*>(p + l.lse);
  a.d_p = reinterpret_cast<float*>(p + l.d);
  a.ds = nchunk > 0 ? reinterpret_cast<float*>(p + l.ds) : nullptr;
  a.kv_part = nsplit > 1 ? reinterpret_cast<float*>(p + l.kv_part) : nullptr;
  a.nsplit = nsplit;
  const int64_t qrows = static_cast<int64_t>(a.B) * a.Tp * a.H;
  const int64_t krows = static_cast<int64_t>(a.B) * a.Tk * a.KV;
  constexpr int kRowsPerBlock = kThreads / 32;
  bwd_prep_q<HD><<<static_cast<unsigned>((qrows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads,
                   0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned kv_blocks = static_cast<unsigned>((krows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (kv_parts == 1) {
    if constexpr (kKv1) bwd_prep_kv<HD, true><<<kv_blocks, kThreads, 0, s>>>(a);
  } else {
    bwd_prep_kv<HD><<<kv_blocks, kThreads, 0, s>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (HD == 256) {
    if (nchunk == 0)
      return kv_parts == 1 ? launch_wide_passes<true>(a, s) : launch_wide_passes<false>(a, s);
    e = launch_wide<false, true>(a, s);
    if (e != cudaSuccess) return e;
    return launch_dq_ds(a, nchunk, k_begin, k_end, reinterpret_cast<float*>(p + l.dq_part), s);
  } else {
    if constexpr (kKv1) {
      if (kv_parts == 1) return launch_wgmma_passes<HD, true>(a, s);
    }
    return launch_wgmma_passes<HD, false>(a, s);
  }
}

}  // namespace

// q, o, dout, dq: [B, Tq, H, hd]; k, v, dk, dv: [B, Tk, KV, hd]; lse: [B,
// H, Tq]; all contiguous, float32 but k and v, which are bfloat16 where
// kv_bf16 (taken only where attn_plan.h's bwd_kv_parts gives 1: bwd_wgmma at
// hd 64, bwd_wide's recomputing passes; else the caller passes their float32
// values).  q row
// i sits at position q_offset + i, any q_offset and Tq: a row that sees no
// key (past the keys by the window, or before key 0) adds nothing (its
// autograd term, do / Tk on every row of dv, is the wrapper's).
// scratch: scratch_bytes of device memory, at least attn_plan::bwd_layout's
// total for the plan a card of `sms` SMs gets (attn_plan.h's bwd_dq_chunks,
// bwd_kv_head_splits, bwd_kv_parts; rt_flash_attention_bwd_plan in
// attn_plan.cc gives it), 16-byte aligned.  hd 32, 64, 112 and 120 (the
// 128-wide template), 128: bwd_wgmma, at 112-128 with the head split where
// attn_plan.h takes it; 256: bwd_wide, on the dS path where its dQ grid is
// under one wave, with the head split where its dK/dV grid is; four to six
// launches, all on `stream`.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dk,
                                      void* dv, void* scratch, int64_t scratch_bytes, int hd,
                                      int B, int Tq, int Tk, int H, int KV, int q_offset,
                                      int window, int causal, float softcap, int kv_bf16,
                                      int sms, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hdk = hd == 112 || hd == 120 ? 128 : hd;
  int k_begin = 0, k_end = 0;
  const int nchunk = attn_plan::bwd_dq_chunks(hd, B, Tq, Tk, H, q_offset, window, causal, sms,
                                              &k_begin, &k_end);
  const int nsplit = attn_plan::bwd_kv_head_splits(hd, B, Tq, Tk, H, KV, q_offset, window, causal,
                                                   nchunk, sms);
  const int kv_parts = attn_plan::bwd_kv_parts(hd, kv_bf16, nchunk);
  if (kv_bf16 && kv_parts != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t need = attn_plan::bwd_layout(hdk, B, Tq, Tk, H, KV, nchunk, nsplit, kv_parts).total;
  if (scratch == nullptr || scratch_bytes < need ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = kv_bf16 ? nullptr : static_cast<const float*>(k);
  a.v = kv_bf16 ? nullptr : static_cast<const float*>(v);
  a.k16 = kv_bf16 ? static_cast<const uint32_t*>(k) : nullptr;
  a.v16 = kv_bf16 ? static_cast<const uint32_t*>(v) : nullptr;
  a.o = static_cast<const float*>(o);
  a.lse = static_cast<const float*>(lse);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.B = B; a.Tq = Tq; a.Tk = Tk; a.H = H; a.KV = KV; a.groups = H / KV; a.hd = hd;
  a.q_offset = q_offset; a.window = window; a.causal = causal;
  a.softcap = softcap;
  a.sqrt_hd = static_cast<float>(sqrt(static_cast<double>(hd)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 32: e = launch_wgmma<32>(a, scratch, 0, 0, 0, nsplit, kParts, s); break;
    case 64: e = launch_wgmma<64>(a, scratch, 0, 0, 0, nsplit, kv_parts, s); break;
    case 112:
    case 120:
    case 128: e = launch_wgmma<128>(a, scratch, 0, 0, 0, nsplit, kParts, s); break;
    case 256: e = launch_wgmma<256>(a, scratch, nchunk, k_begin, k_end, nsplit, kv_parts, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
