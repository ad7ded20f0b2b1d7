// Sorted-segment sum — every groupby sum/count aggregate.
//
// Replaces: src/repro/kernels/segment_reduce/kernel.py, _segsum_kernel (via
// segment_sum_blocked) plus the combine in segment_reduce/ops.py:11, the
// Pallas TPU kernel that re-expresses each 1024-row block's reduction as a
// one-hot matmul into [n_blocks, max_seg] partials.  That design silently
// drops rows when a block spans more than max_seg segments; this one has no
// such bound and drops no row at any segment density.
//
// out[s] = sum of vals[i] over rows with seg[i] == s, for seg sorted
// ascending; ids outside [0, num_segments) are dropped, as
// jax.ops.segment_sum drops them.  int32 values accumulate as uint32, so the
// sum wraps mod 2^32 exactly as the reference's int32 segment_sum does;
// float32 values accumulate in float32.
//
// Bound on the card: memory (8 bytes read per row, 4 written per segment).
// Design: every warp owns one contiguous chunk of rows and walks it 32 rows
// at a time with coalesced loads (the next step's loads issued before the
// current step is reduced).  A step is reduced with a segmented inclusive
// warp scan on the head flags (shuffles only).  A run that ends inside the
// step is flushed with one atomicAdd to out[seg]; the step's last run is
// carried in registers into the next step, so a long segment costs one
// atomic per warp chunk, not one per row or per step.  Float atomics make
// the order of a float sum vary from run to run; integer sums are exact.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoSeg = INT_MAX;  // seg id of the lanes past the chunk's end

template <typename T>
struct Acc;
template <>
struct Acc<int> {
  using type = unsigned int;
};
template <>
struct Acc<float> {
  using type = float;
};

template <typename T>
__global__ void __launch_bounds__(kBlock) segsum_kernel(
    const int* __restrict__ seg, const T* __restrict__ vals, int64_t n, int64_t num_segments,
    int64_t chunk, typename Acc<T>::type* out) {
  using A = typename Acc<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t begin = warp * chunk;
  if (begin >= n) return;  // warp-uniform
  const int64_t end = begin + chunk < n ? begin + chunk : n;

  auto in_range = [num_segments](int s) { return s >= 0 && s < num_segments; };
  bool have_carry = false;
  int carry_seg = 0;
  A carry = 0;

  int s_nxt = kNoSeg;
  A v_nxt = 0;
  if (begin + lane < end) {
    s_nxt = seg[begin + lane];
    v_nxt = static_cast<A>(vals[begin + lane]);
  }
  for (int64_t base = begin; base < end; base += 32) {
    int s = s_nxt;
    A v = v_nxt;
    const int64_t nxt = base + 32 + lane;
    s_nxt = kNoSeg;
    v_nxt = 0;
    if (nxt < end) {
      s_nxt = seg[nxt];
      v_nxt = static_cast<A>(vals[nxt]);
    }
    // segmented inclusive scan: seg is sorted, so equal ids at distance
    // `off` mean every lane between belongs to the same run
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const A up_v = __shfl_up_sync(kFull, v, off);
      const int up_s = __shfl_up_sync(kFull, s, off);
      if (lane >= off && up_s == s) v += up_v;
    }
    const int s_next = __shfl_down_sync(kFull, s, 1);
    const int s_first = __shfl_sync(kFull, s, 0);
    const bool tail = s != kNoSeg && (lane == 31 || s_next != s);
    // only the step's first run can continue the carried segment
    const A total = (have_carry && s == carry_seg) ? v + carry : v;
    if (tail && lane != 31 && in_range(s)) atomicAdd(out + s, total);
    if (have_carry && s_first != carry_seg && lane == 0 && in_range(carry_seg)) {
      atomicAdd(out + carry_seg, carry);
    }
    const int s_last = __shfl_sync(kFull, s, 31);
    const A t_last = __shfl_sync(kFull, total, 31);
    have_carry = s_last != kNoSeg;
    carry_seg = s_last;
    carry = t_last;
  }
  if (have_carry && lane == 0 && in_range(carry_seg)) atomicAdd(out + carry_seg, carry);
}

template <typename T>
int launch(const void* seg, const void* vals, int64_t n, int64_t num_segments, void* out,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(out, 0, sizeof(T) * num_segments, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t max_warps = static_cast<int64_t>(sms) * 64;  // one full wave
    const int64_t steps = (n + 31) / 32;
    const int64_t warps = steps < max_warps ? steps : max_warps;
    const int64_t chunk = ((steps + warps - 1) / warps) * 32;
    const int64_t used = (n + chunk - 1) / chunk;
    const int grid = static_cast<int>((used + kWarpsPerBlock - 1) / kWarpsPerBlock);
    segsum_kernel<T><<<grid, kBlock, 0, s>>>(
        static_cast<const int*>(seg), static_cast<const T*>(vals), n, num_segments, chunk,
        static_cast<typename Acc<T>::type*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_segment_sum_i32(const void* seg, const void* vals, int64_t n,
                                  int64_t num_segments, void* out, void* stream) {
  return launch<int>(seg, vals, n, num_segments, out, stream);
}

extern "C" int rt_segment_sum_f32(const void* seg, const void* vals, int64_t n,
                                  int64_t num_segments, void* out, void* stream) {
  return launch<float>(seg, vals, n, num_segments, out, stream);
}
