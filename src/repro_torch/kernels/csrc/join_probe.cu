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
// does.
//
// Bound on the card: latency.  The bytes are small (4 B read and 5 B written
// per left key, the page read once), but each key walks ceil(log2(page))+1
// dependent loads.  On the main path the page is the receive capacity, about
// 20M int32 (80 MB), larger than the 50 MB L2, so the lower levels of every
// search miss to device memory.  This first design has no page-size cap: one
// thread per left key searches the page in global memory with a bounded
// lower-bound loop (the interval halves each step, so it ends within
// bit_length(page) steps), and relies on the L2 keeping the upper levels of
// the implicit search tree, which every thread touches.  Staging those upper
// levels in shared memory, or sorting the probe side for locality, is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) probe_kernel(
    const int* __restrict__ right, uint32_t page, const int* __restrict__ left, int64_t n,
    int* __restrict__ idx, uint8_t* __restrict__ hit) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int key = left[i];
    uint32_t lo = 0, hi = page;  // lo + hi < 2^32: page < 2^31
    while (lo < hi) {
      const uint32_t mid = (lo + hi) >> 1;
      if (right[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const uint32_t pos = lo < page ? lo : page - 1;
    idx[i] = static_cast<int>(pos);
    hit[i] = right[pos] == key;
  }
}

}  // namespace

extern "C" int rt_probe_sorted(const void* right, int64_t page, const void* left, int64_t n,
                               void* idx, void* hit, void* stream) {
  if (n > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t want = (n + kBlock - 1) / kBlock;
    const int64_t cap = static_cast<int64_t>(sms) * 16;
    const int grid = static_cast<int>(want < cap ? want : cap);
    probe_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(right), static_cast<uint32_t>(page),
        static_cast<const int*>(left), n, static_cast<int*>(idx), static_cast<uint8_t*>(hit));
  }
  return static_cast<int>(cudaGetLastError());
}
