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
// Bound: operations, 10 hd float32 flops per visible (query, key) pair (S
// and dP twice: once for dK and dV, once for dQ; then dV, dK, dQ) against
// 4 hd for the forward, on the CUDA cores (67 TFLOP/s).  This first design
// is the FA2 structure on the float32 CUDA cores, simple and deterministic
// (no atomics: the kill/resume drill replays a trajectory bit for bit):
//
//   pass 1 (bwd_delta): D = rowsum(dO * O), one warp per row.
//   pass 2 (bwd_dkdv):  one block per (batch, kv head, key tile); it walks
//     the query tiles of every q head of its group that can see the tile,
//     recomputes S, P, dP and dS, and accumulates dK and dV in registers:
//     the sum over the GQA group happens in the block.
//   pass 3 (bwd_dq):    one block per (batch, q head, query tile); it walks
//     the key tiles the tile can see and accumulates dQ in registers.
//
// Tiles the causal or window mask hides completely are skipped: gemma3's
// local layers see 1024 of 4096 keys.  Tiles: 64 queries x 64 keys, all of
// q, dO, k, v staged in shared memory as float32 (rows padded by 4 floats
// for conflict-free 16-byte reads), p and dS through shared memory; at
// hd 256, 32 x 32 tiles (four 32 x 260 float tiles = 133 KB, and dK, dV
// accumulators of 32 floats a thread each).  Thread (ty, tx) of 16 x 16
// owns, in S, rows TM ty .. TM ty + TM - 1 and keys tx + 16 j; in dK / dV,
// keys KO ty .. and columns tx + 16 c; in dQ, rows TM ty .. and columns
// tx + 16 c.  hd 120 runs the 128-wide template with a run-time valid
// width: columns past it load as zeros and are never stored.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

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
  float* delta;       // [B, H, T] scratch: D
  int B, T, H, KV, groups, hd;
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

}  // namespace

// q, o, dout, dq: [B, T, H, hd]; k, v, dk, dv: [B, T, KV, hd]; lse, delta:
// [B, H, T]; all float32 and contiguous.  hd: 32, 64, 120 (the 128-wide
// template), 128 or 256.  Three launches on `stream` (D, dK/dV, dQ).
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dk,
                                      void* dv, void* delta, int hd, int B, int T, int H, int KV,
                                      int window, int causal, float softcap, void* stream) {
  if (B < 1 || T < 1 || KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.lse = static_cast<const float*>(lse);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.delta = static_cast<float*>(delta);
  a.B = B; a.T = T; a.H = H; a.KV = KV; a.groups = H / KV; a.hd = hd;
  a.window = window; a.causal = causal;
  a.softcap = softcap;
  a.sqrt_hd = static_cast<float>(sqrt(static_cast<double>(hd)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 32: e = launch_bwd<32>(a, s); break;
    case 64: e = launch_bwd<64>(a, s); break;
    case 120:
    case 128: e = launch_bwd<128>(a, s); break;
    case 256: e = launch_bwd<256>(a, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
