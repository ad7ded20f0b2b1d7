// The split rules of attn_plan.h for the Python wrappers, with a plain C
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

// flash_wgmma at head width hd on bf16 (kv_bf16) or float32 k/v: the keys
// of a streamed tile and the ring's stages; on float32 k/v (flash_wgmma_split)
// the keys [*k_begin, *k_end) its prologue splits and the scratch bytes of
// their parts ([k, v][part][B KV][keys][hdk] bf16); on bf16 k/v 0 bytes.
extern "C" int rt_flash_fwd_plan(int hd, int kv_bf16, int B, int Tq, int Tk, int H, int KV,
                                 int q_offset, int window, int kv_len, int causal, int* tile_keys,
                                 int* stages, int* k_begin, int* k_end, int64_t* scratch_bytes) {
  if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0) return 1;
  if (hd != 32 && hd != 64 && hd != 112 && hd != 120 && hd != 128 && hd != 256) return 1;
  const int hdk = hd == 112 || hd == 120 ? 128 : hd;
  const bool split = !kv_bf16;
  if (split && hdk > 128) return 1;  // float32 k/v at hd 256: flash_tiled
  *tile_keys = attn_plan::fwd_tile_keys(hdk, split);
  *stages = attn_plan::fwd_stages(hdk, split);
  *k_begin = 0;
  *k_end = Tk;
  *scratch_bytes = 0;
  if (split) {
    attn_plan::fwd_parts_keys(Tq, Tk, causal, window, q_offset, kv_len, k_begin, k_end);
    *scratch_bytes = 2 * static_cast<int64_t>(attn_plan::kParts) * B * KV * (*k_end - *k_begin) *
                     hdk * 2;
  }
  return 0;
}

// The backward at head width hd with k/v bfloat16 (kv_bf16) or float32:
// *nchunk 0 for the recomputing dQ pass, else the dS path's chunks (and
// bounds[0 .. *nchunk]); *nsplit the dK/dV pass's head subsets (1:
// unsplit); *kv_parts the bf16 parts it holds of k and v (1: bf16 k/v taken
// as they are; 3: float32 values, which the wrapper must pass); the
// scratch bytes of the call.
extern "C" int rt_flash_attention_bwd_plan(int hd, int B, int Tq, int Tk, int H, int KV,
                                           int q_offset, int window, int causal, int kv_bf16,
                                           int sms, int* nchunk, int* nsplit, int* kv_parts,
                                           int64_t* scratch_bytes, int* bounds) {
  if (B < 1 || Tq < 1 || Tk < 1 || KV < 1 || H % KV != 0 || sms < 1) return 1;
  if (hd != 32 && hd != 64 && hd != 112 && hd != 120 && hd != 128 && hd != 256) return 1;
  int lo, hi;
  *nchunk = attn_plan::bwd_dq_chunks(hd, B, Tq, Tk, H, q_offset, window, causal, sms, &lo, &hi);
  *nsplit = attn_plan::bwd_kv_head_splits(hd, B, Tq, Tk, H, KV, q_offset, window, causal,
                                           *nchunk, sms);
  *kv_parts = attn_plan::bwd_kv_parts(hd, kv_bf16, *nchunk);
  const int hdk = hd == 112 || hd == 120 ? 128 : hd;
  *scratch_bytes =
      attn_plan::bwd_layout(hdk, B, Tq, Tk, H, KV, *nchunk, *nsplit, *kv_parts).total;
  if (*nchunk > 0) fill_bounds(*nchunk, lo, hi, bounds);
  return 0;
}
