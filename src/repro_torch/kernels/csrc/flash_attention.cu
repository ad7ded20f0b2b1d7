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
// kv_len; softmax over the Tk keys; o = p . v.  All arithmetic is float32:
// q is float32, k/v are bfloat16 (read from the KV cache) or float32, o is
// float32.  Masking with -1e30 (never -inf) makes a row with no valid key
// the uniform mean of v over all Tk keys, as in the reference.
//
// Layout: q [B, Tq, H, hd], k/v [B, Tk, KV, hd], o [B, Tq, H, hd], each
// read or written through (batch, seq, head) strides with hd contiguous, so
// a layer's slice of the KV cache is read in place.  Query head h reads kv
// head h / groups (groups = H / KV); nothing is repeated in memory.
//
// Bound on the card (H100 SXM): at prefill the operations (4 hd per valid
// (query, key) pair, float32 on the CUDA cores, 67 TFLOP/s); at decode the
// bytes of the cache (k and v over the keys the rows can see, 3.35 TB/s).
// Two designs, chosen by the wrapper:
//
// * flash_tiled (R = Tq * groups > 8 rows per kv head): one block of 256
//   threads per 64 query rows of one kv head, the rows being (position,
//   group) pairs, so the groups of a kv head share every k/v tile.  It walks
//   the 64-key tiles that the block's rows can see (all of them when a row
//   has no valid key, to keep the uniform-mean rule), stages q, k, v and p
//   in shared memory as float32 (216 KB at hd = 256) and keeps the 64 x hd
//   accumulator in registers, 4 rows x hd/16 columns per thread.  Both
//   products are 4x4 register micro-tiles of float32 FMAs.
// * flash_split + flash_combine (R <= 8: decode): a block per (kv head,
//   chunk of the visible keys), so that B * KV * chunks blocks fill the SMs
//   when B * H is small.  Each warp scores keys against the R rows held in
//   registers (one 16-byte load per lane), a warp per row takes the chunk's
//   max and sum, every thread accumulates p . v for its columns, and the
//   partial (m, l, acc) go to scratch; the combine pass merges the chunks.
//
// Tensor cores (wgmma), TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxSplitRows = 8;
constexpr int kMaxChunk = 1024;

struct Args {
  const float* q;
  const void* k;
  const void* v;
  float* o;
  int Tq, Tk, H, KV, groups;
  int64_t sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  int q_offset, window, kv_len, causal;
  float softcap, sqrt_hd;
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
__device__ __forceinline__ bool key_ok(const Args& a, int qpos, int kpos) {
  return (!a.causal || kpos <= qpos) && (a.window <= 0 || kpos > qpos - a.window) &&
         kpos < a.kv_len;
}
__device__ __forceinline__ float cap_logit(const Args& a, float s) {
  return a.softcap > 0.f ? a.softcap * tanhf(s / a.softcap) : s;
}

// n consecutive elements of a k/v row as float32 (n * sizeof(T) a multiple
// of 16 bytes, the address 16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* out);

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
template <>
__device__ __forceinline__ void load_row<float, 8>(const float* p, float* out) {
  load_row<float, 4>(p, out);
  load_row<float, 4>(p + 4, out + 4);
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
template <>
__device__ __forceinline__ void load_row<uint16_t, 4>(const uint16_t* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(x.x << 16);
  out[1] = __uint_as_float(x.x & 0xffff0000u);
  out[2] = __uint_as_float(x.y << 16);
  out[3] = __uint_as_float(x.y & 0xffff0000u);
}
template <>
__device__ __forceinline__ void load_row<uint16_t, 2>(const uint16_t* p, float* out) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  out[0] = __uint_as_float(x << 16);
  out[1] = __uint_as_float(x & 0xffff0000u);
}
template <>
__device__ __forceinline__ void load_row<float, 2>(const float* p, float* out) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  out[0] = x.x; out[1] = x.y;
}
template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p, float* out) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load_row<uint16_t, 1>(const uint16_t* p, float* out) {
  out[0] = __uint_as_float(static_cast<uint32_t>(*p) << 16);
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
__device__ __forceinline__ float warp_sum32(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max32(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_tiled(Args a) {
  using C = Tiled<HD>;
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
    if (m < M) {
      const int t = m / a.groups, h = kvh * a.groups + m % a.groups;
      x = *reinterpret_cast<const float4*>(a.q + b * a.sqb + t * a.sqt + h * a.sqh + c);
      x.x /= a.sqrt_hd; x.y /= a.sqrt_hd; x.z /= a.sqrt_hd; x.w /= a.sqrt_hd;
    }
    *reinterpret_cast<float4*>(Qs + r * C::LDQ + c) = x;
  }

  // keys the block's rows can see; every key when a row sees none
  const int qp_first = a.q_offset + m0 / a.groups;
  const int qp_last = a.q_offset + m_last / a.groups;
  const bool any_empty = key_lo(a, qp_first) > key_hi(a, qp_first) ||
                         key_lo(a, qp_last) > key_hi(a, qp_last);
  const int k_lo = any_empty ? 0 : key_lo(a, qp_first);
  const int k_hi = any_empty ? a.Tk - 1 : key_hi(a, qp_last);

  int qpos[4];
  float m_i[4], l_i[4], acc[4][C::DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = a.q_offset + (m0 + ty * 4 + i) / a.groups;
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
      if (n0 + r < a.Tk) {
        load_row<T, EPV>(kbase + (n0 + r) * a.skt + c, kx);
        load_row<T, EPV>(vbase + (n0 + r) * a.svt + c, vx);
      } else {  // past Tk: zeros, so that p = 0 times v adds nothing
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

    // mask, online softmax; p -> Ps (transposed)
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = n0 + tx + 16 * j;
        float x = cap_logit(a, s[i][j]);
        x = key_ok(a, qpos[i], kpos) ? x : kMask;
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
      for (int e = 0; e < C::VEC; ++e)
        op[tx * C::VEC + 16 * C::VEC * ch + e] = acc[i][ch * C::VEC + e] / den;
  }
}

// ---------------------------------------------------------------------------
// flash_split / flash_combine: R <= 8 query rows per kv head (decode).
// Grid (chunks, B * KV).  part: [B * KV, chunks, R, 2 + HD] float32 holding
// (m, l, acc[HD]) of each chunk.
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_split(Args a, int k_begin, int k_end,
                                                         int chunk, float* part) {
  constexpr int DPL = HD / 32;   // columns per lane in the scores
  constexpr int PARTS = kThreads / HD;  // threads sharing one output column
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);      // [kMaxSplitRows][chunk]
  float* red = Ss + kMaxSplitRows * chunk;          // [PARTS][kMaxSplitRows][HD]
  __shared__ float stat_m[kMaxSplitRows], stat_l[kMaxSplitRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bkv = blockIdx.y, b = bkv / a.KV, kvh = bkv % a.KV;
  const int R = a.Tq * a.groups;
  const int kb = k_begin + split * chunk;
  const int n = min(chunk, k_end - kb);

  float qreg[kMaxSplitRows][DPL];
  int qpos[kMaxSplitRows];
#pragma unroll
  for (int r = 0; r < kMaxSplitRows; ++r) {
    const int t = r / a.groups, h = kvh * a.groups + r % a.groups;
    qpos[r] = a.q_offset + t;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      qreg[r][e] = r < R ? a.q[b * a.sqb + t * a.sqt + h * a.sqh + lane * DPL + e] / a.sqrt_hd
                         : 0.f;
  }

  const T* kbase = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
#pragma unroll 4
  for (int c = warp; c < n; c += kThreads / 32) {
    float kx[DPL];
    load_row<T, DPL>(kbase + (kb + c) * a.skt + lane * DPL, kx);
#pragma unroll
    for (int r = 0; r < kMaxSplitRows; ++r) {
      if (r >= R) break;
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) x = fmaf(qreg[r][e], kx[e], x);
      x = warp_sum32(x);
      if (lane == 0) {
        x = cap_logit(a, x);
        Ss[r * chunk + c] = key_ok(a, qpos[r], kb + c) ? x : kMask;
      }
    }
  }
  __syncthreads();

  if (warp < R) {  // one warp per row: chunk max, p, chunk sum
    float* sr = Ss + warp * chunk;
    float mx = kMask;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, sr[c]);
    mx = warp_max32(mx);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float pv = expf(sr[c] - mx);
      sr[c] = pv;
      sum += pv;
    }
    sum = warp_sum32(sum);
    if (lane == 0) {
      stat_m[warp] = mx;
      stat_l[warp] = sum;
    }
  }
  __syncthreads();

  const int d = tid % HD, pidx = tid / HD;
  float acc[kMaxSplitRows];
#pragma unroll
  for (int r = 0; r < kMaxSplitRows; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int c = pidx; c < n; c += PARTS) {
    float vv;
    load_row<T, 1>(vbase + (kb + c) * a.svt + d, &vv);
#pragma unroll
    for (int r = 0; r < kMaxSplitRows; ++r)
      if (r < R) acc[r] = fmaf(Ss[r * chunk + c], vv, acc[r]);
  }
  if (PARTS > 1) {
#pragma unroll
    for (int r = 0; r < kMaxSplitRows; ++r) red[(pidx * kMaxSplitRows + r) * HD + d] = acc[r];
    __syncthreads();
    if (pidx == 0) {
      for (int pp = 1; pp < PARTS; ++pp)
#pragma unroll
        for (int r = 0; r < kMaxSplitRows; ++r) acc[r] += red[(pp * kMaxSplitRows + r) * HD + d];
    }
  }
  if (pidx == 0) {
    for (int r = 0; r < R; ++r) {
      float* pr = part + ((static_cast<int64_t>(bkv) * nsplit + split) * R + r) * (2 + HD);
      if (d == 0) {
        pr[0] = stat_m[r];
        pr[1] = stat_l[r];
      }
      pr[2 + d] = acc[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads) flash_combine(Args a, int nsplit, int hd,
                                                           const float* part) {
  const int bkv = blockIdx.x, b = bkv / a.KV, kvh = bkv % a.KV;
  const int R = a.Tq * a.groups;
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    const float* p0 = part + (static_cast<int64_t>(bkv) * nsplit * R + r) * (2 + hd);
    const int64_t step = static_cast<int64_t>(R) * (2 + hd);
    float mx = kMask;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, p0[s * step]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(p0[s * step] - mx);
      l = fmaf(p0[s * step + 1], w, l);
      acc = fmaf(p0[s * step + 2 + d], w, acc);
    }
    const int t = r / a.groups, h = kvh * a.groups + r % a.groups;
    a.o[b * a.sob + t * a.sot + h * a.soh + d] = acc / fmaxf(l, 1e-30f);
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int B, float* part, int nsplit, int k_begin, int k_end,
                   int chunk, cudaStream_t stream) {
  if (part == nullptr) {
    // the opt-in above 48 KB holds per device, so it is set on every launch
    // (cheap) rather than once per process
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tiled<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tiled<HD>::kSmem));
    if (e != cudaSuccess) return e;
    const int M = a.Tq * a.groups;
    const dim3 grid((M + BM - 1) / BM, B * a.KV);
    flash_tiled<T, HD><<<grid, kThreads, Tiled<HD>::kSmem, stream>>>(a);
  } else {
    const size_t smem =
        sizeof(float) * (size_t(kMaxSplitRows) * chunk + size_t(kThreads) * kMaxSplitRows);
    flash_split<T, HD><<<dim3(nsplit, B * a.KV), kThreads, smem, stream>>>(a, k_begin, k_end,
                                                                           chunk, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_combine<<<B * a.KV, kThreads, 0, stream>>>(a, nsplit, HD, part);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, int B, float* part, int nsplit, int k_begin,
                        int k_end, int chunk, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, B, part, nsplit, k_begin, k_end, chunk, stream);
    case 64: return launch<T, 64>(a, B, part, nsplit, k_begin, k_end, chunk, stream);
    case 128: return launch<T, 128>(a, B, part, nsplit, k_begin, k_end, chunk, stream);
    case 256: return launch<T, 256>(a, B, part, nsplit, k_begin, k_end, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q (b, t, h), k (b, t, kv), v (b, t, kv), o (b, t, h), in elements.
// part == nullptr: the tiled kernel; otherwise the split kernel over keys
// [k_begin, k_end) in nsplit chunks of `chunk` keys, then the combine.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int kv_bf16, int hd, int B, int Tq, int Tk, int H, int KV,
                                  const void* strides, int q_offset, int window, int kv_len,
                                  int causal, float softcap, void* part, int nsplit,
                                  int k_begin, int k_end, int chunk, void* stream) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  if (part != nullptr && (Tq * (H / KV) > kMaxSplitRows || chunk > kMaxChunk || chunk < 1))
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
  a.sqrt_hd = static_cast<float>(sqrt(static_cast<double>(hd)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  const cudaError_t e =
      kv_bf16 ? dispatch_hd<uint16_t>(hd, a, B, pp, nsplit, k_begin, k_end, chunk, s)
              : dispatch_hd<float>(hd, a, B, pp, nsplit, k_begin, k_end, chunk, s);
  return static_cast<int>(e);
}
