// The key-split rule of attn_plan.h for the Python wrappers, with a plain C
// interface (loaded with ctypes; built by the host C++ compiler, so that the
// wrappers and the CPU tests read the same rule the CUDA entry points
// apply).  Each returns 0, or 1 for sizes it does not take.

#include "attn_plan.h"

namespace {

void fill_bounds(int nchunk, int k_begin, int k_end, int* bounds) {
  for (int c = 0; c <= nchunk; ++c) bounds[c] = attn_plan::chunk_begin(c, nchunk, k_begin, k_end);
}

}  // namespace

// flash_tiled (float32 k/v at hd 256): *nchunk chunks (1: unsplit), the
// scratch bytes of the split's partials (0 unsplit), and the chunks' key
// bounds[0 .. *nchunk] (bounds holds attn_plan::kMaxChunks + 1 ints).
extern "C" int rt_flash_tiled_plan(int B, int Tq, int Tk, int H, int KV, int q_offset, int window,
                                   int kv_len, int causal, int sms, int* nchunk,
                                   int64_t* scratch_bytes, int* bounds) {
  if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0 || sms < 1) return 1;
  int lo, hi;
  *nchunk = attn_plan::tiled_chunks(B, Tq, Tk, H, KV, q_offset, window, kv_len, causal, sms, &lo,
                                    &hi);
  *scratch_bytes = attn_plan::tiled_scratch_bytes(*nchunk, B, Tq, H, KV);
  fill_bounds(*nchunk, lo, hi, bounds);
  return 0;
}

// The backward at head width hd: *nchunk 0 for the recomputing dQ pass,
// else the dS path's chunks (and bounds[0 .. *nchunk]); the scratch bytes
// of the call.
extern "C" int rt_flash_attention_bwd_plan(int hd, int B, int Tq, int Tk, int H, int KV,
                                           int q_offset, int window, int causal, int sms,
                                           int* nchunk, int64_t* scratch_bytes, int* bounds) {
  if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0 || sms < 1) return 1;
  if (hd != 32 && hd != 64 && hd != 112 && hd != 120 && hd != 128 && hd != 256) return 1;
  int lo, hi;
  *nchunk = attn_plan::bwd_dq_chunks(hd, B, Tq, Tk, H, q_offset, window, causal, sms, &lo, &hi);
  const int hdk = hd == 112 || hd == 120 ? 128 : hd;
  *scratch_bytes = attn_plan::bwd_layout(hdk, B, Tq, Tk, H, KV, *nchunk).total;
  if (*nchunk > 0) fill_bounds(*nchunk, lo, hi, bounds);
  return 0;
}
