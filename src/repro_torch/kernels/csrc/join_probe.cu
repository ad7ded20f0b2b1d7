// Sorted probe — the probe of dataframe.ops_local.join_unique.
//
// Replaces: src/repro/kernels/join_probe/kernel.py, _probe_kernel (via
// probe_sorted), the Pallas TPU kernel that holds a sorted, INT32_MAX-padded
// right-key page resident in VMEM (capped at 32768 keys) and runs a
// branchless lower-bound binary search of every left key against it.
//
// For each left key: pos = lower_bound(right, key) clipped to page-1, and
// hit = right[pos] == key.  A left key equal to INT32_MAX "hits" the sentinel
// padding; join_unique guards that with pos < right.count, as the reference
// does.  Any page of 1 .. 2^31-1 keys, any n >= 0.
//
// Bound on the card: bytes (each left key read once, idx and hit written
// once, the page read once: 13 bytes per key at the main path), but a plain
// binary search is latency-bound.  On the main path the page is the receive
// capacity, about 20M int32 (80 MB, larger than the 50 MB L2), and a search
// in it is ~25 dependent 4-byte loads, each touching its own 32-byte sector:
// the first design (one thread per key searching the page in global memory)
// made ~500M sector loads per call and ran at 3% of the bound.
//
// This design cuts the dependent loads to one smem search and one 32-byte
// sector per level.  Level k of a search index holds every 8^k-th key of the
// page (level 0 is the page itself), each level padded with INT32_MAX to a
// whole number of 8-key sectors.  The top level is the first with at most
// kTopMax keys (4,888 at the main path, 8^4 = 4096 apart).
//
// * build_index (first launch of the call) writes levels 1 .. top into the
//   scratch the wrapper allocates; at the main path 2.86M keys (11.4 MB),
//   which stay in the L2.
// * probe (second launch) is persistent: each block copies the top level
//   into shared memory once and then takes left keys in a grid-stride loop.
//   A key's lower bound j in level k says the answer lies in the 8 entries
//   8(j-1) .. 8j-1 of level k-1 (the entry 8j is the level-k entry j itself),
//   so each lower level is one aligned sector, read as two 16-byte loads and
//   counted branch-free.  At the main path: a 13-step search in shared
//   memory, then 4 sector loads (3 from the index, in L2, and 1 from the
//   page) instead of ~25.  The key at the lower bound rides down the levels,
//   so hit needs no extra load.
//
// Small pages (<= kTopMax keys) have no index: the page itself is the top
// level, searched in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFan = 8;          // keys per 32-byte sector: the fan-out per level
constexpr int kTopMax = 8192;    // top level held in shared memory (32 KB)
constexpr int kMaxLevels = 12;   // 8^11 > 2^31
constexpr int kBuildBlock = 256;
constexpr int kProbeBlock = 512;
constexpr int kIntMax = 0x7fffffff;

struct Plan {
  int top;                        // level searched in shared memory
  int64_t count[kMaxLevels];      // keys in level k (k = 0: the page)
  int64_t offset[kMaxLevels];     // where level k >= 1 starts in the scratch
  int64_t total;                  // scratch entries, all levels padded to 8
};

Plan make_plan(int64_t page) {
  Plan p{};
  p.count[0] = page;
  int64_t off = 0;
  int k = 0;
  while (p.count[k] > kTopMax) {
    ++k;
    p.count[k] = (p.count[k - 1] + kFan - 1) / kFan;
    p.offset[k] = off;
    off += (p.count[k] + kFan - 1) / kFan * kFan;
  }
  p.top = k;
  p.total = off;
  return p;
}

__global__ void __launch_bounds__(kBuildBlock) build_index(const int* __restrict__ right,
                                                           int* __restrict__ index, Plan plan) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < plan.total;
       e += stride) {
    int k = 1;
    while (k < plan.top && e >= plan.offset[k + 1]) ++k;
    const int64_t i = e - plan.offset[k];
    index[e] = i < plan.count[k] ? __ldg(right + (i << (3 * k))) : kIntMax;
  }
}

// The 8 keys of one sector; entries at or past `valid` read as INT32_MAX.
template <bool kVec>
__device__ __forceinline__ void load_sector(const int* p, int64_t base, int64_t valid, int* w) {
  if (kVec && base + kFan <= valid) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p + base));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p + base) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kFan; ++e) w[e] = base + e < valid ? __ldg(p + base + e) : kIntMax;
  }
}

// kVecPage: the page is 16-byte aligned (the index always is).
template <bool kVecPage>
__global__ void __launch_bounds__(kProbeBlock) probe_kernel(
    const int* __restrict__ right, const int* __restrict__ left, int64_t n,
    int* __restrict__ idx, uint8_t* __restrict__ hit, const int* __restrict__ index, Plan plan) {
  extern __shared__ int top[];
  const int n_top = static_cast<int>(plan.count[plan.top]);
  const int* top_src = plan.top ? index + plan.offset[plan.top] : right;
  for (int i = threadIdx.x; i < n_top; i += blockDim.x) top[i] = __ldg(top_src + i);
  __syncthreads();

  const int64_t page = plan.count[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int key = __ldg(left + i);
    int lo = 0, hi = n_top;  // lower bound in the top level
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (top[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int64_t j = lo;
    int at = lo < n_top ? top[lo] : kIntMax;  // the key at the lower bound
    for (int k = plan.top; k >= 1; --k) {
      const int64_t base = (j > 0 ? j - 1 : 0) * kFan;
      int w[kFan];
      if (k == 1) {
        load_sector<kVecPage>(right, base, page, w);
      } else {
        const int64_t padded = (plan.count[k - 1] + kFan - 1) / kFan * kFan;
        load_sector<true>(index + plan.offset[k - 1], base, padded, w);
      }
      int below = 0, first = kIntMax;
#pragma unroll
      for (int e = 0; e < kFan; ++e) {
        below += w[e] < key;
        first = w[e] >= key ? min(first, w[e]) : first;
      }
      j = base + below;
      at = below < kFan ? first : at;  // below == 8: the lower bound is entry 8j itself
    }
    const bool inside = j < page;
    idx[i] = static_cast<int>(inside ? j : page - 1);
    hit[i] = inside && at == key;
  }
}

}  // namespace

// scratch: at least scratch_entries int32 (the wrapper's index_entries(page)).
extern "C" int rt_probe_sorted(const void* right, int64_t page, const void* left, int64_t n,
                               void* idx, void* hit, void* scratch, int64_t scratch_entries,
                               void* stream) {
  if (page < 1 || page > kIntMax) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(page);
  if (plan.total > scratch_entries) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int* index = static_cast<int*>(scratch);
  if (plan.top > 0) {
    const int64_t want = (plan.total + kBuildBlock - 1) / kBuildBlock;
    const int grid = static_cast<int>(want < sms * 8 ? want : sms * 8);
    build_index<<<grid, kBuildBlock, 0, s>>>(static_cast<const int*>(right), index, plan);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = sizeof(int) * static_cast<size_t>(plan.count[plan.top]);
  const bool vec = reinterpret_cast<uintptr_t>(right) % 16 == 0;
  auto* kernel = vec ? probe_kernel<true> : probe_kernel<false>;
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kProbeBlock, smem);
  const int64_t want = (n + kProbeBlock - 1) / kProbeBlock;
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(want < cap ? want : cap);
  kernel<<<grid, kProbeBlock, smem, s>>>(
      static_cast<const int*>(right), static_cast<const int*>(left), n, static_cast<int*>(idx),
      static_cast<uint8_t*>(hit), index, plan);
  return static_cast<int>(cudaGetLastError());
}
