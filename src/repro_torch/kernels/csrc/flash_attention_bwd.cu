// Flash attention backward: dq, dk, dv of the forward in
// flash_attention.cu — every layer's backward on the training path.
//
// Replaces: no pallas_call.  The reference trains through jax.grad of the
// jnp attention (src/repro/models/layers.py:114 _attention_flash under
// jax.checkpoint, or _attention_direct below 2048 positions): XLA's
// transpose of the forward, on the TPU.  The port's forward is a hand-written
// kernel with no gradient, so its backward is one too.
//
// Semantics: the gradient of ref.attention_ref with q [B, T, H, hd] and
// k, v [B, T, KV, hd] float32 (H % KV == 0), q_offset 0 and kv_len T (the
// training path's only call; every row sees at least its own key), causal
// or not, a run-time sliding window (0 = none) and a tanh softcap c
// (d/ds of c tanh(s / c) is 1 - (s' / c)^2 with s' the capped score).
// With s = (q / sqrt(hd)) . k, p = exp(s' - lse) (lse from the forward),
// D = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * cap',
//   dQ = dS K / sqrt(hd),  dK = dS^T (Q / sqrt(hd)).
// Masked (query, key) pairs have p = 0 and pass no gradient.
//
// Bound: operations.  The least work is five products of 2 hd operations
// per visible (query, key) pair: S, dP, dV, dK, dQ, 10 hd in all (4 hd for
// the forward).  Every operand is float32 (q, k, v, dO are float32 products
// of float32 activations; P and dS are computed here), so on the bf16
// tensor cores each float32 product becomes BWD_SPLIT = 6 bf16 products:
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
// 6 move 0.08% (scripts/torch_bwd_split_choice.py).
//
// Two designs, by head width (the wrapper, kernel.bwd_design, mirrors it):
//
// * bwd_wgmma (hd 32, 64, 120 and 128; the training path's hd 64).  Four
//   launches: bwd_prep_q (D, and q / sqrt(hd) and dO split into their
//   three bf16 parts, lse and D copied into rows padded to 128), bwd_prep_kv
//   (k and v split), both into wrapper scratch in head-major order
//   [part][batch x head][T][hd]; then bwd_wgmma<HD, false> (dK, dV) and
//   bwd_wgmma<HD, true> (dQ).  Deterministic, no atomics: each output
//   element is written once by the thread whose registers summed it (the
//   kill/resume drill replays a loss trace bit for bit).  The price is the
//   FA2 split into two passes: S and dP are computed in both, 14 hd of
//   products per pair against the bound's 10, so the kernel can reach at
//   most 10/14 of its bound.
//   One block = NWG consumer warpgroups (64 "fixed" rows each) and a
//   producer warpgroup, one thread of which issues every copy; with NWG 2
//   the producer hands its registers to the consumers (setmaxnreg 24 /
//   240).  The fixed rows' two operands (dK/dV pass: 64 keys of k and v;
//   dQ pass: 64 queries of q and dO), all three parts, come in once by TMA;
//   the producer then streams tiles of BS rows of the other two (q and dO
//   of every query tile of every q head of the GQA group that can see the
//   keys; or k and v of every key tile the queries can see) through a
//   two-stage mbarrier ring, 128-byte (hd 32: 64-byte) swizzled.  Per
//   streamed tile a warpgroup computes, as FlashAttention-3 does,
//     dK/dV pass:  S^T = K Q^T and dP^T = V dO^T (A and B from shared
//                  memory, both K-major), then P^T and dS^T in registers,
//                  dV += P^T dO and dK += dS^T Q (A from registers: the
//                  accumulator layout is the A-operand layout; q and dO
//                  MN-major through the transpose bit), the sum over the
//                  GQA group in the same registers;
//     dQ pass:     S = Q K^T and dP = dO V^T, then dS, dQ += dS K.
//   wgmma's float32 accumulator rounds toward zero, which over the
//   thousands of steps of a long sum shrinks a gradient by ~1e-4 of itself
//   (dK, dV at 4096 positions x 4 heads of a GQA group failed BWD_TOL so),
//   so each streamed tile's dV, dK or dQ runs in a fresh accumulator and is
//   added to the running sum with float32 adds (products_rs).
//   Tiles that the causal or window mask hides completely are never
//   loaded, and a warpgroup skips a loaded tile that its own rows cannot
//   see.  hd 32 and 64: NWG 2 (128 fixed rows), BS 64, 192 KB of shared
//   memory at hd 64; 384 threads start at 168 registers each (three warps
//   share a sub-partition's 16K), too few for the dK/dV consumers without
//   the 240 that setmaxnreg gives them.  hd 128 (and 120, in the 128-wide template with
//   columns 120..127 zero): NWG 1 (256 threads, up to 255 registers), BS
//   32, 192 KB; its dK/dV pass (64 + 64 accumulator floats a thread) still
//   spills a few hundred bytes.
// * FA2 on the float32 CUDA cores (hd 256: gemma3-4b).  The split parts of a
//   64-row tile of two operands are 192 KB alone, so no stage of the other
//   two fits beside them in 227 KB.  Three launches: bwd_delta (D), bwd_dkdv
//   (one block per (batch, kv head, key tile) walks the query tiles of its
//   group, recomputing S, P, dP, dS; dK and dV in registers), bwd_dq (one
//   block per (batch, q head, query tile)); both as 32 x 32 tiles of float32
//   FMAs, q, dO, k, v staged in shared memory, p and dS through it.
//
// Tiles the causal or window mask hides completely are skipped in both
// designs: gemma3's local layers see 1024 of 4096 keys.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// FA2 on the float32 CUDA cores (hd 256).  Thread (ty, tx) of 16 x 16 owns,
// in S, rows TM ty .. TM ty + TM - 1 and keys tx + 16 j; in dK / dV, keys
// KO ty .. and columns tx + 16 c; in dQ, rows TM ty .. and columns tx + 16 c.
// Rows padded by 4 floats for conflict-free 16-byte reads.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

struct BwdArgs {
  const float* q;     // [B, T, H, hd]
  const float* k;     // [B, T, KV, hd]
  const float* v;
  const float* o;     // [B, T, H, hd]
  const float* lse;   // [B, H, T]
  const float* dout;  // [B, T, H, hd]
  float* dq;          // [B, T, H, hd]
  float* dk;          // [B, T, KV, hd]
  float* dv;
  float* delta;       // [B, H, T] scratch: D (FA2)
  // the tensor-core design's scratch: bf16 parts (as uint32 pairs) of
  // q / sqrt(hd), dO, k, v, and lse, D with rows padded to Tp
  uint32_t* qp;
  uint32_t* dop;
  uint32_t* kp;
  uint32_t* vp;
  float* lse_p;
  float* d_p;
  int B, T, Tp, H, KV, groups, hd;
  int window, causal;
  float softcap, sqrt_hd;
};

template <int HD>
struct Tile {
  static constexpr int BM = HD == 256 ? 32 : 64;  // query rows per tile
  static constexpr int BN = BM;                   // keys per tile
  static constexpr int TM = BM / 16;              // S rows per thread
  static constexpr int TN = BN / 16;              // S keys per thread
  static constexpr int KO = BN / 16;              // dK / dV keys per thread
  static constexpr int CO = HD / 16;              // output columns per thread
  static constexpr int LD = HD + 4;
  static constexpr int LDP = BN + 4;
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(2) * BM * LD + size_t(2) * BN * LD + size_t(2) * BM * LDP + 2 * BM);
};

__device__ __forceinline__ int64_t q_row(const BwdArgs& a, int b, int t, int h) {
  return ((static_cast<int64_t>(b) * a.T + t) * a.H + h) * a.hd;
}
__device__ __forceinline__ int64_t kv_row(const BwdArgs& a, int b, int t, int kvh) {
  return ((static_cast<int64_t>(b) * a.T + t) * a.KV + kvh) * a.hd;
}

// rows row0 .. row0 + N - 1 of one head -> shared [N][LD], divided by
// `div`; zeros past T and past hd.  row_offset(t) is row t's element offset.
template <int HD, int N, typename RowOffset>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int T, int hd,
                                      float div, RowOffset row_offset) {
  constexpr int LD = HD + 4;
  for (int i = threadIdx.x; i < N * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T && c < hd) {
      x = *reinterpret_cast<const float4*>(src + row_offset(row0 + r) + c);
      x.x /= div; x.y /= div; x.z /= div; x.w /= div;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// lse and D of rows m0 .. m0 + BM - 1 of head h -> shared (0 past T).
template <int BM>
__device__ __forceinline__ void stage_rows(const BwdArgs& a, float* lse_s, float* d_s, int b,
                                           int h, int m0) {
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int t = m0 + r;
    const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.T + t;
    lse_s[r] = t < a.T ? a.lse[at] : 0.f;
    d_s[r] = t < a.T ? a.delta[at] : 0.f;
  }
}

// For the query tile at m0 (Qs scaled by 1/sqrt(hd), dOs) and the key tile
// at n0 (Ks, Vs): P (if WANT_P) and dS -> shared [BM][LDP].
template <int HD, bool WANT_P>
__device__ __forceinline__ void tile_pds(const BwdArgs& a, const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs, const float* lse_s,
                                         const float* d_s, float* Ps, float* dSs, int m0,
                                         int n0) {
  using C = Tile<HD>;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float s[C::TM][C::TN], dp[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < HD; d += 4) {
    float4 qv[C::TM], ov[C::TM], kv[C::TN], vv[C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * C::TM + i) * C::LD + d);
      ov[i] = *reinterpret_cast<const float4*>(dOs + (ty * C::TM + i) * C::LD + d);
    }
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * C::LD + d);
      vv[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * C::LD + d);
    }
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        float x = s[i][j], y = dp[i][j];
        x = fmaf(qv[i].x, kv[j].x, x); y = fmaf(ov[i].x, vv[j].x, y);
        x = fmaf(qv[i].y, kv[j].y, x); y = fmaf(ov[i].y, vv[j].y, y);
        x = fmaf(qv[i].z, kv[j].z, x); y = fmaf(ov[i].z, vv[j].z, y);
        x = fmaf(qv[i].w, kv[j].w, x); y = fmaf(ov[i].w, vv[j].w, y);
        s[i][j] = x;
        dp[i][j] = y;
      }
  }
  const bool cap = a.softcap > 0.f;  // uniform
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = ty * C::TM + i, t = m0 + r;
    const int lo = a.window > 0 ? t - a.window + 1 : INT_MIN;
    const int hi = a.causal ? t : a.T - 1;
    const float lse = lse_s[r], dd = d_s[r];
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int key = n0 + tx + 16 * j;
      float x = s[i][j], g = 1.f;
      if (cap) {
        x = a.softcap * tanhf(x / a.softcap);
        const float u = x / a.softcap;
        g = 1.f - u * u;
      }
      const bool vis = t < a.T && key < a.T && lo <= key && key <= hi;
      const float p = vis ? expf(x - lse) : 0.f;
      if (WANT_P) Ps[r * C::LDP + tx + 16 * j] = p;
      dSs[r * C::LDP + tx + 16 * j] = p * (dp[i][j] - dd) * g;
    }
  }
}

// pass 1: D = rowsum(dO * O), one warp per (b, t, h) row
__global__ void __launch_bounds__(kThreads) bwd_delta(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t rows = static_cast<int64_t>(a.B) * a.T * a.H;
  if (row >= rows) return;
  const float* o = a.o + row * a.hd;
  const float* g = a.dout + row * a.hd;
  float acc = 0.f;
  for (int c = lane; c < a.hd; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // row = (b * T + t) * H + h  ->  delta[(b * H + h) * T + t]
    const int h = static_cast<int>(row % a.H);
    const int64_t bt = row / a.H;
    const int t = static_cast<int>(bt % a.T);
    const int64_t b = bt / a.T;
    a.delta[(b * a.H + h) * a.T + t] = acc;
  }
}

// pass 2: dK, dV of one key tile of one (batch, kv head)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) bwd_dkdv(BwdArgs a) {
  using C = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + C::BN * C::LD;
  float* Qs = Vs + C::BN * C::LD;
  float* dOs = Qs + C::BM * C::LD;
  float* Ps = dOs + C::BM * C::LD;
  float* dSs = Ps + C::BM * C::LDP;
  float* lse_s = dSs + C::BM * C::LDP;
  float* d_s = lse_s + C::BM;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * C::BN;  // the first key tiles have the most rows (causal)
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;

  stage<HD, C::BN>(Ks, a.k, n0, a.T, a.hd, 1.f, [&](int t) { return kv_row(a, b, t, kvh); });
  stage<HD, C::BN>(Vs, a.v, n0, a.T, a.hd, 1.f, [&](int t) { return kv_row(a, b, t, kvh); });

  float dk[C::KO][C::CO], dv[C::KO][C::CO];
#pragma unroll
  for (int u = 0; u < C::KO; ++u)
#pragma unroll
    for (int c = 0; c < C::CO; ++c) dk[u][c] = dv[u][c] = 0.f;

  // the query rows that can see a key of this tile
  const int t_lo = a.causal ? n0 : 0;
  int t_hi = a.T - 1;
  if (a.window > 0) t_hi = min(t_hi, n0 + C::BN - 1 + a.window - 1);

  for (int g = 0; g < a.groups; ++g) {
    const int h = kvh * a.groups + g;
    for (int m0 = (t_lo / C::BM) * C::BM; m0 <= t_hi; m0 += C::BM) {
      __syncthreads();  // the previous tile's Qs, dOs, Ps, dSs are no longer read
      stage<HD, C::BM>(Qs, a.q, m0, a.T, a.hd, a.sqrt_hd, [&](int t) { return q_row(a, b, t, h); });
      stage<HD, C::BM>(dOs, a.dout, m0, a.T, a.hd, 1.f,
                       [&](int t) { return q_row(a, b, t, h); });
      stage_rows<C::BM>(a, lse_s, d_s, b, h, m0);
      __syncthreads();
      tile_pds<HD, true>(a, Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, m0, n0);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < C::BM; ++r) {
        float p[C::KO], ds[C::KO];
#pragma unroll
        for (int u = 0; u < C::KO; ++u) {
          p[u] = Ps[r * C::LDP + ty * C::KO + u];
          ds[u] = dSs[r * C::LDP + ty * C::KO + u];
        }
#pragma unroll
        for (int c = 0; c < C::CO; ++c) {
          const float go = dOs[r * C::LD + tx + 16 * c];
          const float qq = Qs[r * C::LD + tx + 16 * c];
#pragma unroll
          for (int u = 0; u < C::KO; ++u) {
            dv[u][c] = fmaf(p[u], go, dv[u][c]);
            dk[u][c] = fmaf(ds[u], qq, dk[u][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < C::KO; ++u) {
    const int t = n0 + ty * C::KO + u;
    if (t >= a.T) continue;
    float* dkp = a.dk + kv_row(a, b, t, kvh);
    float* dvp = a.dv + kv_row(a, b, t, kvh);
#pragma unroll
    for (int c = 0; c < C::CO; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hd) {
        dkp[col] = dk[u][c];
        dvp[col] = dv[u][c];
      }
    }
  }
}

// pass 3: dQ of one query tile of one (batch, q head)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) bwd_dq(BwdArgs a) {
  using C = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + C::BN * C::LD;
  float* Qs = Vs + C::BN * C::LD;
  float* dOs = Qs + C::BM * C::LD;
  float* Ps = dOs + C::BM * C::LD;  // unused here (tile_pds<.., false>)
  float* dSs = Ps + C::BM * C::LDP;
  float* lse_s = dSs + C::BM * C::LDP;
  float* d_s = lse_s + C::BM;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * C::BM;  // the last query tiles see the most keys
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / a.groups;

  stage<HD, C::BM>(Qs, a.q, m0, a.T, a.hd, a.sqrt_hd, [&](int t) { return q_row(a, b, t, h); });
  stage<HD, C::BM>(dOs, a.dout, m0, a.T, a.hd, 1.f, [&](int t) { return q_row(a, b, t, h); });
  stage_rows<C::BM>(a, lse_s, d_s, b, h, m0);

  float dq[C::TM][C::CO];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int c = 0; c < C::CO; ++c) dq[i][c] = 0.f;

  // the keys some row of this tile can see
  const int k_lo = a.window > 0 ? max(0, m0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.T - 1, m0 + C::BM - 1) : a.T - 1;

  for (int n0 = (k_lo / C::BN) * C::BN; n0 <= k_hi; n0 += C::BN) {
    __syncthreads();  // the previous tile's Ks, Vs, dSs are no longer read
    stage<HD, C::BN>(Ks, a.k, n0, a.T, a.hd, 1.f, [&](int t) { return kv_row(a, b, t, kvh); });
    stage<HD, C::BN>(Vs, a.v, n0, a.T, a.hd, 1.f, [&](int t) { return kv_row(a, b, t, kvh); });
    __syncthreads();
    tile_pds<HD, false>(a, Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, m0, n0);
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < C::BN; ++key) {
      float ds[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) ds[i] = dSs[(ty * C::TM + i) * C::LDP + key];
#pragma unroll
      for (int c = 0; c < C::CO; ++c) {
        const float kk = Ks[key * C::LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < C::TM; ++i) dq[i][c] = fmaf(ds[i], kk, dq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int t = m0 + ty * C::TM + i;
    if (t >= a.T) continue;
    float* dqp = a.dq + q_row(a, b, t, h);
#pragma unroll
    for (int c = 0; c < C::CO; ++c) {
      const int col = tx + 16 * c;
      if (col < a.hd) dqp[col] = dq[i][c] / a.sqrt_hd;
    }
  }
}

template <int HD>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t s) {
  using C = Tile<HD>;
  const int64_t rows = static_cast<int64_t>(a.B) * a.T * a.H;
  bwd_delta<<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
              s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the opt-in above 48 KB holds per device, so it is set on every launch
  e = cudaFuncSetAttribute(bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return e;
  const unsigned tiles = static_cast<unsigned>((a.T + C::BM - 1) / C::BM);
  bwd_dkdv<HD><<<dim3(tiles, a.B * a.KV), kThreads, C::kSmem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq<HD><<<dim3(tiles, a.B * a.H), kThreads, C::kSmem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bwd_wgmma (hd 32, 64, 120/128).  Consumer thread (warpgroup w, warp v,
// lane l) holds, of its warpgroup's 64 fixed rows, rows 16 v + l / 4 and
// 16 v + l / 4 + 8 and, in every 8-column block j of an accumulator,
// columns 8 j + 2 (l % 4) and the next one (the wgmma accumulator layout).
// ---------------------------------------------------------------------------

constexpr int kParts = 3;   // bf16 parts of each float32 operand
constexpr int kSplit = 6;   // BWD_SPLIT: bf16 products per float32 product
// product p's parts (i of A, j of B): the pairs with i + j <= 2, smallest
// first: (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)
__host__ __device__ constexpr int pair_a(int p) { return p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0; }
__host__ __device__ constexpr int pair_b(int p) { return p == 2 ? 2 : p == 1 || p == 4 ? 1 : 0; }

template <int HD>
struct Bw {
  static constexpr int NWG = HD <= 64 ? 2 : 1;     // consumer warpgroups, 64 fixed rows each
  static constexpr int BS = HD <= 64 ? 64 : 32;    // rows of a streamed tile
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 * (NWG + 1);  // + the producer warpgroup
  static constexpr int TN = HD < 64 ? HD : 64;     // output columns per promoted product
  static constexpr int SW = HD >= 64 ? 128 : 64;   // swizzle span: bytes per row of an atom
  static constexpr int ATOM = SW / 2;              // bf16 columns per atom
  static constexpr int NATOM = HD / ATOM;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int FIX_TILE = NATOM * 64 * SW;  // one part of 64 fixed rows
  static constexpr int STR_TILE = NATOM * BS * SW;  // one part of a streamed tile
  // fixed: [warpgroup][operand 0/1][part]; a stage: [operand 0/1][part]
  static constexpr int OFF_STR = NWG * 2 * kParts * FIX_TILE;
  static constexpr int STAGE = 2 * kParts * STR_TILE;
  static constexpr int OFF_BAR = OFF_STR + STAGES * STAGE;
  static constexpr size_t kSmem = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + base alignment
  static constexpr int ROWS = 64 * NWG;            // fixed rows per block
};

constexpr int kPadRows = 128;  // lse and D rows padded to a multiple of every block's rows

// The streamed rows [lo, hi] that fixed rows r_first .. r_last can reach:
// dK/dV pass (fixed keys) the queries that see one of the keys; dQ pass
// (fixed queries) the keys one of the queries sees.  Empty when lo > hi.
template <bool DQ>
__device__ __forceinline__ void stream_range(const BwdArgs& a, int r_first, int r_last, int& lo,
                                             int& hi) {
  r_last = min(r_last, a.T - 1);
  if (DQ) {
    lo = a.window > 0 ? max(0, r_first - a.window + 1) : 0;
    hi = a.causal ? r_last : a.T - 1;
  } else {
    lo = a.causal ? r_first : 0;
    hi = a.window > 0 ? min(a.T - 1, r_last + a.window - 1) : a.T - 1;
  }
  if (r_first > r_last) hi = lo - 1;
}

// The streamed rows [lo, hi] that fixed row r sees (row r sees none past T).
template <bool DQ>
__device__ __forceinline__ void row_range(const BwdArgs& a, int r, int& lo, int& hi) {
  stream_range<DQ>(a, r, r, lo, hi);
  if (r >= a.T) { lo = 1; hi = 0; }
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
  if (t >= a.T) {
    if (lane == 0) a.lse_p[bh * a.Tp + t] = a.d_p[bh * a.Tp + t] = 0.f;
    return;
  }
  const int64_t src = ((static_cast<int64_t>(b) * a.T + t) * a.H + h) * a.hd;
  const float* o = a.o + src;
  const float* g = a.dout + src;
  float acc = 0.f;  // as bwd_delta
  for (int c = lane; c < a.hd; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    a.lse_p[bh * a.Tp + t] = a.lse[bh * a.T + t];
    a.d_p[bh * a.Tp + t] = acc;
  }
  const int64_t part = static_cast<int64_t>(a.B) * a.H * a.T * HDK / 2;  // uint32 per part
  const int64_t dst = (bh * a.T + t) * HDK / 2;
#pragma unroll
  for (int c = 2 * lane; c < HDK; c += 64) {
    float2 x = make_float2(0.f, 0.f), y = make_float2(0.f, 0.f);
    if (c < a.hd) {
      x = *reinterpret_cast<const float2*>(a.q + src + c);
      y = *reinterpret_cast<const float2*>(g + c);
      x.x /= a.sqrt_hd;
      x.y /= a.sqrt_hd;
    }
    uint32_t p[kParts];
    split3(x.x, x.y, p[0], p[1], p[2]);
#pragma unroll
    for (int i = 0; i < kParts; ++i) a.qp[i * part + dst + c / 2] = p[i];
    split3(y.x, y.y, p[0], p[1], p[2]);
#pragma unroll
    for (int i = 0; i < kParts; ++i) a.dop[i * part + dst + c / 2] = p[i];
  }
}

// Prologue, kv side: k and v of each (b, t, kv head) row split into three
// bf16 parts, [part][b * KV + kvh][t][HDK].
template <int HDK>
__global__ void __launch_bounds__(kThreads) bwd_prep_kv(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(a.B) * a.T * a.KV) return;
  const int kvh = static_cast<int>(row % a.KV);
  const int64_t bt = row / a.KV;
  const int t = static_cast<int>(bt % a.T);
  const int64_t b = bt / a.T;
  const int64_t part = static_cast<int64_t>(a.B) * a.KV * a.T * HDK / 2;
  const int64_t dst = ((b * a.KV + kvh) * a.T + t) * HDK / 2;
#pragma unroll
  for (int c = 2 * lane; c < HDK; c += 64) {
    float2 x = make_float2(0.f, 0.f), y = make_float2(0.f, 0.f);
    if (c < a.hd) {
      x = *reinterpret_cast<const float2*>(a.k + row * a.hd + c);
      y = *reinterpret_cast<const float2*>(a.v + row * a.hd + c);
    }
    uint32_t p[kParts];
    split3(x.x, x.y, p[0], p[1], p[2]);
#pragma unroll
    for (int i = 0; i < kParts; ++i) a.kp[i * part + dst + c / 2] = p[i];
    split3(y.x, y.y, p[0], p[1], p[2]);
#pragma unroll
    for (int i = 0; i < kParts; ++i) a.vp[i * part + dst + c / 2] = p[i];
  }
}

// acc = X . S^T over the kSplit part products: X the 64 fixed rows (three
// parts at x_parts, K-major, the A operand), S the streamed tile's rows
// (three parts at s_parts, K-major, the B operand); the first overwrites.
template <int HD>
__device__ __forceinline__ void products_ss(float (&acc)[Bw<HD>::BS / 2], uint32_t x_parts,
                                            uint32_t s_parts) {
  using C = Bw<HD>;
#pragma unroll
  for (int p = 0; p < kSplit; ++p)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int atom = kk * 16 / C::ATOM, col = (kk * 16 % C::ATOM) * 2;
      const uint64_t da = gmma_desc(x_parts + pair_a(p) * C::FIX_TILE + atom * 64 * C::SW + col,
                                    16, 8 * C::SW, C::LAYOUT);
      const uint64_t db = gmma_desc(s_parts + pair_b(p) * C::STR_TILE + atom * C::BS * C::SW + col,
                                    16, 8 * C::SW, C::LAYOUT);
      wgmma_ss<C::BS>(acc, da, db, p | kk);
    }
}

// o += A . S, A (64 x BS) in registers in the accumulator layout (P^T,
// dS^T or dS), S the streamed tile's BS rows (three parts at s_parts, the B
// operand, MN-major through the transpose bit), TN output columns at a
// time.  wgmma's float32 accumulator rounds its sums toward zero; over the
// thousands of steps of a long sum (6 products x 16 rows each) that shrinks
// a gradient by ~1e-4 of itself.  So each tile's product runs in a fresh
// accumulator of kSplit x BS / 16 steps and is added to o with float32
// (round-to-nearest) adds.
template <int HD>
__device__ __forceinline__ void products_rs(float (&o)[HD / 2], const float (&acc)[Bw<HD>::BS / 2],
                                            uint32_t s_parts) {
  using C = Bw<HD>;
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
        wgmma_rs<C::TN>(t, fr[pair_a(p)],
                        gmma_desc(s_parts + pair_b(p) * C::STR_TILE + col_off + kk * 16 * C::SW,
                                  C::BS * C::SW, 8 * C::SW, C::LAYOUT));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < C::TN / 2; ++i) o[c * C::TN / 2 + i] += t[i];
  }
}

// One block of either pass.  Grid (heads, tiles): blockIdx.x the fixed
// rows' (batch x head) (dK/dV: b * KV + kvh; dQ: b * H + h), blockIdx.y the
// tile of ROWS fixed rows, the longest first (dK/dV: the first key tiles,
// which the most queries see; dQ: the last query tiles).  Maps: fix0/fix1
// the fixed operands (k, v or q, dO; boxes of 64 rows), str0/str1 the
// streamed ones (q, dO or k, v; boxes of BS rows), all over the parts
// [part][batch x head][T][HDK].
template <int HD, bool DQ>
__global__ void __launch_bounds__(Bw<HD>::THREADS, 1)
    bwd_wgmma(const __grid_constant__ CUtensorMap fix0, const __grid_constant__ CUtensorMap fix1,
              const __grid_constant__ CUtensorMap str0, const __grid_constant__ CUtensorMap str1,
              BwdArgs a) {
  using C = Bw<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_fix = smem_u32(smem), s_str = s_fix + C::OFF_STR;
  const uint32_t bar_full = s_fix + C::OFF_BAR, bar_empty = bar_full + 8 * C::STAGES;
  const uint32_t bar_fix = bar_empty + 8 * C::STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int tile = DQ ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * C::ROWS;
  const int b = DQ ? bh / a.H : bh / a.KV;
  const int h = DQ ? bh % a.H : 0;                   // dQ pass: the q head
  const int kvh = DQ ? h / a.groups : bh % a.KV;
  const int nbh_fix = DQ ? a.B * a.H : a.B * a.KV;   // batch x heads of each map
  const int nbh_str = DQ ? a.B * a.KV : a.B * a.H;
  int lo, hi;
  stream_range<DQ>(a, r0, r0 + C::ROWS - 1, lo, hi);
  const int s_first = lo / C::BS;
  const int per_head = hi >= lo ? hi / C::BS - s_first + 1 : 0;
  const int n_tiles = (DQ ? 1 : a.groups) * per_head;
  // streamed tile t < n_tiles: its first row and its (batch x head)
  auto streamed = [&](int t, int& row0, int& sbh) {
    row0 = (s_first + t % per_head) * C::BS;
    sbh = DQ ? b * a.KV + kvh : b * a.H + kvh * a.groups + t / per_head;
  };

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * C::NWG);
    }
    mbar_init(bar_fix, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread starts every copy
    if (C::NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      // a warpgroup whose rows all lie past T loads nothing (its rows are
      // masked and never stored)
      const int live = min(C::NWG, (a.T - r0 + 63) / 64);
      mbar_expect_tx(bar_fix, live * 2 * kParts * C::FIX_TILE);
      for (int w = 0; w < live; ++w)
        for (int op = 0; op < 2; ++op)
          for (int i = 0; i < kParts; ++i)
#pragma unroll
            for (int c = 0; c < C::NATOM; ++c)
              tma_load_3d(s_fix + ((w * 2 + op) * kParts + i) * C::FIX_TILE + c * 64 * C::SW,
                          op ? &fix1 : &fix0, bar_fix, c * C::ATOM, r0 + 64 * w,
                          i * nbh_fix + bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, C::STAGE);
        int row0, sbh;
        streamed(t, row0, sbh);
        for (int op = 0; op < 2; ++op)
          for (int i = 0; i < kParts; ++i)
#pragma unroll
            for (int c = 0; c < C::NATOM; ++c)
              tma_load_3d(s_str + s * C::STAGE + (op * kParts + i) * C::STR_TILE +
                              c * C::BS * C::SW,
                          op ? &str1 : &str0, bar_full + 8 * s, c * C::ATOM, row0,
                          i * nbh_str + sbh);
      }
    }
    return;
  }

  if (C::NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = (tid >> 7) - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int fr0 = r0 + 64 * wg;  // this warpgroup's first fixed row
  const uint32_t s_mine = s_fix + wg * 2 * kParts * C::FIX_TILE;
  int wlo, whi;                  // the streamed rows this warpgroup's rows see
  stream_range<DQ>(a, fr0, fr0 + 63, wlo, whi);
  int vlo[2], vhi[2];            // the streamed rows each of the thread's rows sees
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

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    int row0, sbh;
    streamed(t, row0, sbh);
    const uint32_t s_st = s_str + s * C::STAGE;
    mbar_wait(bar_full + 8 * s, (t / C::STAGES) & 1);
    // the mask hides all of it from this warpgroup's rows (one warpgroup a
    // block: never, the block's range is its own)
    if (C::NWG > 1 && (row0 > whi || row0 + C::BS - 1 < wlo)) {
      mbar_arrive(bar_empty + 8 * s);
      continue;
    }

    // acc0 = X0 . S0^T (S^T or S), acc1 = X1 . S1^T (dP^T or dP)
    float acc0[C::BS / 2], acc1[C::BS / 2];
    wgmma_fence();
    products_ss<HD>(acc0, s_mine, s_st);
    products_ss<HD>(acc1, s_mine + kParts * C::FIX_TILE, s_st + kParts * C::STR_TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc0);
    fence_regs(acc1);

    // softcap (a uniform branch), mask, P and dS; acc0 becomes P (or P^T),
    // acc1 dS (or dS^T).  lse and D belong to the query: the column here
    // (dK/dV pass), the row (dQ pass).
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
          float x = acc0[i], g = 1.f;
          if (cap) {
            x = a.softcap * tanhf(x / a.softcap);
            const float u = x / a.softcap;
            g = 1.f - u * u;
          }
          const float lse = DQ ? lse_r[e] : (f ? lse_c.y : lse_c.x);
          const float dd = DQ ? d_r[e] : (f ? d_c.y : d_c.x);
          const float p = vlo[e] <= col && col <= vhi[e] ? expf(x - lse) : 0.f;
          acc1[i] = p * (acc1[i] - dd) * g;
          acc0[i] = p;
        }
    }

    // dK/dV pass: dV += P^T . dO (S1), dK += dS^T . Q (S0);
    // dQ pass:    dQ += dS . K (S0).
    if (!DQ) products_rs<HD>(o1, acc0, s_st + kParts * C::STR_TILE);
    products_rs<HD>(o0, acc1, s_st);
    mbar_arrive(bar_empty + 8 * s);
  }

  // dK/dV pass: rows are keys of kv head kvh; dQ pass: queries of head h
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = fr0 + r_lo + 8 * e;
    if (r >= a.T) continue;
    const int64_t at = DQ ? ((static_cast<int64_t>(b) * a.T + r) * a.H + h) * a.hd
                          : ((static_cast<int64_t>(b) * a.T + r) * a.KV + kvh) * a.hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + cq;
      if (col >= a.hd) continue;
      if (DQ) {
        *reinterpret_cast<float2*>(a.dq + at + col) =
            make_float2(o0[4 * j + 2 * e] / a.sqrt_hd, o0[4 * j + 2 * e + 1] / a.sqrt_hd);
      } else {
        *reinterpret_cast<float2*>(a.dk + at + col) =
            make_float2(o0[4 * j + 2 * e], o0[4 * j + 2 * e + 1]);
        *reinterpret_cast<float2*>(a.dv + at + col) =
            make_float2(o1[4 * j + 2 * e], o1[4 * j + 2 * e + 1]);
      }
    }
  }
}

// A 3-D TMA map of one operand's parts [3][nbh][T][HDK] bf16: a box of ATOM
// columns x `rows` rows, swizzled for wgmma; rows past T read as zeros.
template <int HD>
bool make_parts_map(CUtensorMap* map, const void* base, int T, int nbh, int rows) {
  using C = Bw<HD>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(kParts) * nbh};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * HD),
                                 static_cast<cuuint64_t>(2) * HD * T};
  const cuuint32_t box[3] = {C::ATOM, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Bytes of scratch the tensor-core design needs (kernel.py's
// bwd_scratch_bytes mirrors it): the parts of q, dO ([3][B H][T][HDK] bf16
// each) and of k, v ([3][B KV][T][HDK]), then lse and D as [B H][Tp].
int64_t wgmma_scratch_bytes(int HDK, int B, int T, int H, int KV) {
  const int64_t tp = (static_cast<int64_t>(T) + kPadRows - 1) / kPadRows * kPadRows;
  return 2 * 2 * kParts * static_cast<int64_t>(B) * T * HDK * (H + KV) +
         2 * 4 * static_cast<int64_t>(B) * H * tp;
}

template <int HD, bool DQ>
cudaError_t launch_pass(const BwdArgs& a, cudaStream_t s) {
  using C = Bw<HD>;
  CUtensorMap f0, f1, s0, s1;
  const int nq = a.B * a.H, nk = a.B * a.KV;
  // fixed: 64-row boxes of k, v (dK/dV pass) or q, dO (dQ pass); streamed:
  // BS-row boxes of the other two
  const void* fix[2] = {DQ ? a.qp : a.kp, DQ ? a.dop : a.vp};
  const void* str[2] = {DQ ? a.kp : a.qp, DQ ? a.vp : a.dop};
  const bool ok = make_parts_map<HD>(&f0, fix[0], a.T, DQ ? nq : nk, 64) &&
                  make_parts_map<HD>(&f1, fix[1], a.T, DQ ? nq : nk, 64) &&
                  make_parts_map<HD>(&s0, str[0], a.T, DQ ? nk : nq, C::BS) &&
                  make_parts_map<HD>(&s1, str[1], a.T, DQ ? nk : nq, C::BS);
  if (!ok) return cudaErrorInvalidValue;
  // the opt-in above 48 KB holds per device, so it is set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      bwd_wgmma<HD, DQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (e != cudaSuccess) return e;
  const dim3 grid(DQ ? nq : nk, (a.T + C::ROWS - 1) / C::ROWS);
  bwd_wgmma<HD, DQ><<<grid, C::THREADS, C::kSmem, s>>>(f0, f1, s0, s1, a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma(BwdArgs a, void* scratch, cudaStream_t s) {
  a.Tp = (a.T + kPadRows - 1) / kPadRows * kPadRows;
  const int64_t qpart = static_cast<int64_t>(a.B) * a.H * a.T * HD;  // bf16 per part
  const int64_t kpart = static_cast<int64_t>(a.B) * a.KV * a.T * HD;
  uint16_t* p = static_cast<uint16_t*>(scratch);
  a.qp = reinterpret_cast<uint32_t*>(p);
  a.dop = reinterpret_cast<uint32_t*>(p + kParts * qpart);
  a.kp = reinterpret_cast<uint32_t*>(p + 2 * kParts * qpart);
  a.vp = reinterpret_cast<uint32_t*>(p + 2 * kParts * qpart + kParts * kpart);
  a.lse_p = reinterpret_cast<float*>(p + 2 * kParts * (qpart + kpart));
  a.d_p = a.lse_p + static_cast<int64_t>(a.B) * a.H * a.Tp;
  const int64_t qrows = static_cast<int64_t>(a.B) * a.Tp * a.H;
  const int64_t krows = static_cast<int64_t>(a.B) * a.T * a.KV;
  constexpr int kRowsPerBlock = kThreads / 32;
  bwd_prep_q<HD><<<static_cast<unsigned>((qrows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads,
                   0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_prep_kv<HD><<<static_cast<unsigned>((krows + kRowsPerBlock - 1) / kRowsPerBlock), kThreads,
                    0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_pass<HD, false>(a, s);
  if (e != cudaSuccess) return e;
  return launch_pass<HD, true>(a, s);
}

}  // namespace

// q, o, dout, dq: [B, T, H, hd]; k, v, dk, dv: [B, T, KV, hd]; lse: [B, H,
// T]; all float32 and contiguous.  scratch: scratch_bytes of device memory,
// at least rt_flash_attention_bwd_scratch's (16-byte aligned).  hd 32, 64,
// 120 (the 128-wide template), 128: the tensor-core design (four launches);
// 256: FA2 (three launches).  All on `stream`.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dk,
                                      void* dv, void* scratch, int64_t scratch_bytes, int hd,
                                      int B, int T, int H, int KV, int window, int causal,
                                      float softcap, void* stream) {
  if (B < 1 || T < 1 || KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hdk = hd == 120 ? 128 : hd;
  const int64_t need = hdk == 256 ? static_cast<int64_t>(4) * B * H * T
                                  : wgmma_scratch_bytes(hdk, B, T, H, KV);
  if (scratch == nullptr || scratch_bytes < need ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.lse = static_cast<const float*>(lse);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.delta = static_cast<float*>(scratch);
  a.B = B; a.T = T; a.H = H; a.KV = KV; a.groups = H / KV; a.hd = hd;
  a.window = window; a.causal = causal;
  a.softcap = softcap;
  a.sqrt_hd = static_cast<float>(sqrt(static_cast<double>(hd)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 32: e = launch_wgmma<32>(a, scratch, s); break;
    case 64: e = launch_wgmma<64>(a, scratch, s); break;
    case 120:
    case 128: e = launch_wgmma<128>(a, scratch, s); break;
    case 256: e = launch_bwd<256>(a, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// The scratch bytes rt_flash_attention_bwd needs for these sizes, into
// *bytes; cudaErrorInvalidValue for a head width it does not take.
extern "C" int rt_flash_attention_bwd_scratch(int hd, int B, int T, int H, int KV, void* bytes) {
  int64_t* out = static_cast<int64_t*>(bytes);
  switch (hd) {
    case 32: case 64: case 128: *out = wgmma_scratch_bytes(hd, B, T, H, KV); break;
    case 120: *out = wgmma_scratch_bytes(128, B, T, H, KV); break;
    case 256: *out = static_cast<int64_t>(4) * B * H * T; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}
