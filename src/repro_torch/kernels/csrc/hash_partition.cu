// Row hash, destination bucket and bucket histogram — shuffle phase 1.
//
// Replaces: src/repro/kernels/hash_partition/kernel.py, _hash_kernel (via
// hash_partition), the Pallas TPU kernel that computes the murmur3 finalizer
// and the bucket h % P over int32 keys in 1 x 8192 VMEM tiles.
//
// Two entries:
//   rt_hash_row_buckets  the main path: the combined row hash of
//       dataframe.partition.hash_columns (boost-style mix seeded with
//       seed ^ 0x51ED270B) over up to four key columns, the bucket h % P with
//       padding rows (row >= *count, count read on the device) sent to the
//       sentinel P, and the P+1-bin histogram build_partition_payload needs —
//       one pass over the keys instead of hash, bucket and bincount passes.
//   rt_hash_partition    the single-column (hash32(k), hash32(k) % P)
//       contract of kernel.py:36.
//
// Bound on the card: memory.  Per row it reads 4 bytes of key and writes 4
// bytes of bucket (plus 4 of hash where asked); the ~12 integer operations
// per row are far below the ALU rate.  The design streams: one thread per
// row (four rows with 16-byte vector loads and stores where the single key
// column and the outputs are 16-byte aligned), a grid-stride loop over a
// grid of a few blocks per SM, and a shared-memory histogram per block,
// aggregated per warp with __match_any_sync and flushed with one integer
// atomicAdd per bin per block, so the histogram is exact and deterministic.
//
// uint32 arithmetic wraps mod 2^32 exactly as the reference's does; an int32
// key is reinterpreted as uint32 (two's complement, as astype(uint32)); an
// int64 key contributes its low 32 bits, as astype(uint32) truncates it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kSeedMix = 0x9E3779B9u;
constexpr uint32_t kRowSeed = 0x51ED270Bu;
constexpr int kBlock = 256;

struct KeyCols {
  const void* ptr[4];
  int width[4];  // bytes per key: 4 (int32/uint32) or 8 (int64)
  int ncols;
};

__device__ __forceinline__ uint32_t hash32(uint32_t x, uint32_t seed_mixed) {
  uint32_t h = x ^ seed_mixed;
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_mix(uint32_t h, uint32_t ch) {
  return h ^ (ch + kSeedMix + (h << 6) + (h >> 2));
}

__device__ __forceinline__ uint32_t load_key(const void* p, int width, int64_t row) {
  if (width == 8) return (uint32_t)(static_cast<const unsigned long long*>(p)[row]);
  return static_cast<const uint32_t*>(p)[row];
}

// one histogram increment per distinct bucket in the warp
__device__ __forceinline__ void hist_add(int* s_hist, int b) {
  const unsigned peers = __match_any_sync(__activemask(), b);
  const int leader = __ffs(peers) - 1;
  if ((threadIdx.x & 31) == leader) atomicAdd(&s_hist[b], __popc(peers));
}

template <bool kVec4>
__global__ void __launch_bounds__(kBlock) row_buckets_kernel(
    KeyCols cols, int64_t n, uint32_t seed, uint32_t seed_mixed, int P,
    const int* count, uint32_t* h_out, int* bucket_out, int* hist) {
  extern __shared__ int s_hist[];
  const bool do_hist = hist != nullptr;
  if (do_hist) {
    for (int i = threadIdx.x; i <= P; i += blockDim.x) s_hist[i] = 0;
  }
  __syncthreads();
  int64_t valid = count ? static_cast<int64_t>(*count) : n;
  const uint32_t h0 = seed ^ kRowSeed;
  const uint32_t up = static_cast<uint32_t>(P);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t scalar_from = 0;
  if (kVec4) {
    const int64_t nvec = n >> 2;
    const uint4* keys4 = static_cast<const uint4*>(cols.ptr[0]);
    for (int64_t v = tid; v < nvec; v += stride) {
      const uint4 k = keys4[v];
      const uint32_t h[4] = {
          row_mix(h0, hash32(k.x, seed_mixed)), row_mix(h0, hash32(k.y, seed_mixed)),
          row_mix(h0, hash32(k.z, seed_mixed)), row_mix(h0, hash32(k.w, seed_mixed))};
      int b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = (4 * v + j < valid) ? static_cast<int>(h[j] % up) : P;
        if (do_hist) hist_add(s_hist, b[j]);
      }
      if (h_out) reinterpret_cast<uint4*>(h_out)[v] = make_uint4(h[0], h[1], h[2], h[3]);
      if (bucket_out) reinterpret_cast<int4*>(bucket_out)[v] = make_int4(b[0], b[1], b[2], b[3]);
    }
    scalar_from = nvec << 2;
  }
  for (int64_t row = scalar_from + tid; row < n; row += stride) {
    uint32_t h = h0;
    for (int c = 0; c < cols.ncols; ++c) {
      h = row_mix(h, hash32(load_key(cols.ptr[c], cols.width[c], row), seed_mixed));
    }
    const int b = row < valid ? static_cast<int>(h % up) : P;
    if (h_out) h_out[row] = h;
    if (bucket_out) bucket_out[row] = b;
    if (do_hist) hist_add(s_hist, b);
  }
  __syncthreads();
  if (do_hist) {
    for (int i = threadIdx.x; i <= P; i += blockDim.x) {
      const int c = s_hist[i];
      if (c) atomicAdd(&hist[i], c);
    }
  }
}

__global__ void __launch_bounds__(kBlock) hash_partition_kernel(
    const uint32_t* __restrict__ keys, int64_t n, uint32_t seed_mixed, int P,
    uint32_t* __restrict__ h_out, int* __restrict__ b_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t h = hash32(keys[i], seed_mixed);
    h_out[i] = h;
    b_out[i] = static_cast<int>(h % static_cast<uint32_t>(P));
  }
}

int grid_for(int64_t work, int blocks_per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (work + kBlock - 1) / kBlock;
  const int64_t cap = static_cast<int64_t>(sms) * blocks_per_sm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int rt_hash_row_buckets(
    const void* c0, const void* c1, const void* c2, const void* c3,
    int w0, int w1, int w2, int w3, int ncols, int64_t n, uint32_t seed,
    uint32_t seed_mixed, int P, const int* count, uint32_t* h_out, int* bucket_out,
    int* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hist) {
    const cudaError_t e = cudaMemsetAsync(hist, 0, sizeof(int) * (P + 1), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n > 0) {
    const KeyCols cols{{c0, c1, c2, c3}, {w0, w1, w2, w3}, ncols};
    const size_t smem = hist ? sizeof(int) * (P + 1) : 0;
    const bool vec4 = ncols == 1 && w0 == 4 && aligned16(c0) &&
                      (!h_out || aligned16(h_out)) && (!bucket_out || aligned16(bucket_out));
    if (vec4) {
      row_buckets_kernel<true><<<grid_for((n + 3) / 4, 8), kBlock, smem, s>>>(
          cols, n, seed, seed_mixed, P, count, h_out, bucket_out, hist);
    } else {
      row_buckets_kernel<false><<<grid_for(n, 8), kBlock, smem, s>>>(
          cols, n, seed, seed_mixed, P, count, h_out, bucket_out, hist);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_hash_partition(const void* keys, int64_t n, uint32_t seed_mixed, int P,
                                 void* h_out, void* b_out, void* stream) {
  if (n > 0) {
    hash_partition_kernel<<<grid_for(n, 8), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), n, seed_mixed, P, static_cast<uint32_t*>(h_out),
        static_cast<int*>(b_out));
  }
  return static_cast<int>(cudaGetLastError());
}
