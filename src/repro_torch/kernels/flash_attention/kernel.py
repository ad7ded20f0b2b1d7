"""Launch wrapper for ``csrc/flash_attention.cu`` (CUDA tensors only).

``flash_attention`` takes the model layout (q [B, Tq, H, hd], k/v
[B, Tk, KV, hd], any strides with hd contiguous, e.g. a layer's slice of the
KV cache in place); ``flash_attention_heads`` the Pallas kernel's head-major
contract (q [BH, Tq, hd], k/v [BKV, Tk, hd]), which is the same kernel with
other strides.  The designs (``csrc/flash_attention.cu``; ``fwd_design``
names the one a call runs): with more than ``SPLIT_ROWS`` query rows per kv
head (Tq * groups) one block covers 64 rows on the bf16 tensor cores, two
consumer warpgroups taking its key tiles in turns, ``flash_wgmma`` when k/v
are bfloat16 (every prefill of the serve path) and ``flash_wgmma_split``
when they are float32 (the keys some row sees split into three bf16 parts
by a prologue, into scratch this wrapper allocates: ``fwd_plan``), except
at head width 256, where float32 k/v run ``flash_tiled`` on the float32
CUDA cores;
with at most ``SPLIT_ROWS`` (decode) ``flash_decode`` cuts the keys the rows
can see into chunks, one block each, and the last block of each kv head to
finish merges them, in the same launch.

The split rules of the hd-256 designs (``csrc/attn_plan.h``): where
``flash_tiled``'s grid, or ``bwd_wide``'s dQ grid, is under one wave of the
card's SMs (gemma3-4b's sequence-split islands), the CUDA entry point cuts
the visible keys into chunks of whole 64-key tiles and merges the chunks'
partials in chunk order; where ``bwd_wide``'s dK/dV grid is
(recurrentgemma-9b's 16-head MQA group over one kv head), or where
``bwd_wgmma``'s 128-wide dK/dV grid is under two waves and unbalanced
(the causal GQA-4 rank islands of qwen3-moe and kimi-k2), it cuts the
group's query heads into subsets and merges their partial dK, dV in subset
order.  The wrappers ask the same rules for the scratch (``tiled_plan``,
``bwd_plan``) and count the calls that take them (``split_launches``:
"flash_tiled" the forwards with more than one chunk, "bwd_wide" the
backwards on the dS path; ``head_split_launches``: the backwards whose
dK/dV pass splits the heads, by design).

``flash_attention_lse`` is the training path's forward: a prefill design
(``flash_wgmma`` for bfloat16 k/v, the float32-k/v designs else), which
also writes each row's log-sum-exp, at any ``q_offset``, Tq, Tk and kv_len
(a sequence-split island, a cross-attention); ``flash_attention_bwd``
launches the backward (``csrc/flash_attention_bwd.cu``) from it, in the
design ``bwd_design`` names for the head width, both on the bf16 tensor
cores (``BWD_SPLIT`` bf16 products per float32 product of float32 operands)
in four CUDA launches (the two prologues, dK/dV, dQ; one more for each
merge: the dK/dV partials of a head split, the dQ partials of the dS path
with more than one chunk): ``bwd_wgmma`` for every width but 256,
``bwd_wide`` for 256.  bfloat16 k/v: ``bwd_wgmma`` at hd 64 and
``bwd_wide``'s recomputing passes take them as they are
(``bwd_plan(...).kv_parts`` 1; ``bf16_kv_launches``, by design), where
each product with k or v makes three bf16 products (``bwd_products``);
``bwd_wgmma`` at hd 32 and 112-128 and the dS path take their float32
values (exact) and make six.  ``launches`` counts forward calls and
``fwd_design_launches`` the forward calls of each design; ``bwd_launches``
backward calls, and ``bwd_design_launches`` the backward calls of each
design.

Head widths: ``HEAD_DIMS``.  112 (kimi-k2) and 120 (h2o-danube-3-4b) run
the 128-wide kernels with a run-time valid width (``kernel_head_dim``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

launches = 0
fwd_design_launches = {"flash_wgmma": 0, "flash_wgmma_split": 0, "flash_tiled": 0,
                       "flash_decode": 0}
bwd_launches = 0
bwd_design_launches = {"bwd_wgmma": 0, "bwd_wide": 0}
# calls that took the key split (each also counted above)
split_launches = {"flash_tiled": 0, "bwd_wide": 0}
# backward calls whose dK/dV pass took the head split, and those that took
# bf16 k/v as they are (each also counted above)
head_split_launches = {"bwd_wgmma": 0, "bwd_wide": 0}
bf16_kv_launches = {"bwd_wgmma": 0, "bwd_wide": 0}

HEAD_DIMS = (32, 64, 112, 120, 128, 256)
SPLIT_ROWS = 8     # csrc kMaxSplitRows
BWD_SPLIT = 6      # bf16 products per product of two float32 operands (csrc kSplit)
MIN_CHUNK = 64     # keys per block of the decode design: at least this,
MAX_CHUNK = 1024   # and at most this while it takes no more than
MAX_CHUNKS = 1024  # this many chunks per kv head (csrc kMaxChunks)
MAX_PLAN_CHUNKS = 256  # key-split chunks a call may have (csrc attn_plan::kMaxChunks)

# per device: the decode design's scratch, and how many of its leading
# words are known to be zero (see _decode_scratch)
_scratch: dict[str, torch.Tensor] = {}
_zeroed: dict[str, int] = {}


def key_range(tq: int, tk: int, *, causal: bool, window: int, q_offset: int,
              kv_len: int) -> tuple[int, int]:
    """Keys [lo, hi) that some query row can see.  All Tk keys when some row
    sees none: such a row is the mean of v over every key."""
    last_key = min(kv_len, tk) - 1

    def lo(p):
        return max(0, p - window + 1) if window > 0 else 0

    def hi(p):
        return min(last_key, p) if causal else last_key

    first, last = q_offset, q_offset + tq - 1
    if lo(first) > hi(first) or lo(last) > hi(last):
        return 0, tk
    return lo(first), hi(last) + 1


def split_plan(n_keys: int, blocks: int, sms: int) -> tuple[int, int]:
    """(chunks, keys per chunk) for ``n_keys`` keys and ``blocks`` kv heads:
    at most one block per SM in all (one wave: a second block on an SM
    doubles the call's time), chunks of MIN_CHUNK..MAX_CHUNK keys (more
    only where MAX_CHUNKS chunks would not hold them), none empty."""
    want = max(1, sms // blocks)
    nsplit = max(min(want, -(-n_keys // MIN_CHUNK)), -(-n_keys // MAX_CHUNK))
    nsplit = min(nsplit, MAX_CHUNKS)
    chunk = -(-n_keys // nsplit)
    return -(-n_keys // chunk), chunk


def _decode_scratch(dev: torch.device, bkv: int, partial_floats: int) -> torch.Tensor:
    """The decode design's scratch on ``dev``: one uint32 counter per
    (batch, kv head), padded to 32, then the chunks' partial (m, l, acc).
    The kernel leaves every counter it used at 0, so the buffer is made
    (zeroed) once and reused by later calls on the same stream; it grows by
    reallocation.  A call's partials start right after its own counters, so
    a later call with more (batch, kv head) pairs finds partials where its
    extra counters lie: those words are zeroed first (``_zeroed`` counts the
    leading words known to be zero)."""
    counters = -(-bkv // 32) * 32
    need = counters + partial_floats
    key = str(dev)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.float32, device=dev)
        _scratch[key] = buf
    elif _zeroed[key] < counters:
        buf[_zeroed[key]:counters].zero_()
    _zeroed[key] = counters  # this call writes its partials past its counters
    return buf


@dataclasses.dataclass(frozen=True)
class KeySplit:
    """A call's plan, as ``csrc/attn_plan.h`` decides it: ``chunks``
    (``tiled_plan``: 1 = unsplit; ``bwd_plan``: 0 = the recomputing dQ pass),
    the call's scratch bytes, and the chunks' key bounds (chunk c holds keys
    ``bounds[c]`` .. ``bounds[c + 1] - 1``); for the backward also the dK/dV
    pass's ``head_splits`` (1 = unsplit) and the bf16 ``kv_parts`` it holds
    of k and v (1: bf16 k/v taken as they are; 3: float32 values)."""

    chunks: int
    scratch_bytes: int
    bounds: tuple[int, ...]
    head_splits: int = 1
    kv_parts: int = 3


def _plan_call(fn, *args, extra: int = 0) -> KeySplit:
    """``fn``'s plan for ``args``: its outputs are the chunk count, ``extra``
    more ints (the backward's head splits and k/v parts), the scratch bytes
    and the chunks' bounds."""
    nchunk, nbytes = ctypes.c_int(), ctypes.c_int64()
    more = [ctypes.c_int() for _ in range(extra)]
    bounds = (ctypes.c_int * (MAX_PLAN_CHUNKS + 1))()
    rc = fn(*(int(a) for a in args), ctypes.addressof(nchunk),
            *(ctypes.addressof(m) for m in more), ctypes.addressof(nbytes),
            ctypes.addressof(bounds))
    if rc != 0:
        raise ValueError(f"flash_attention: no key-split plan for sizes {args}")
    n = nchunk.value
    return KeySplit(n, nbytes.value, tuple(bounds[:n + 1]) if n else (),
                    *(m.value for m in more))


def tiled_plan(b: int, tq: int, tk: int, h: int, kvh: int, *, causal: bool, window: int,
               q_offset: int, kv_len: int, sms: int) -> KeySplit:
    """``flash_tiled``'s key split on a card of ``sms`` SMs (the rule the CUDA
    entry point applies)."""
    return _plan_call(_build.plan_library().rt_flash_tiled_plan, b, tq, tk, h, kvh, q_offset,
                      window, kv_len, causal, sms)


def bwd_plan(hd: int, b: int, tq: int, tk: int, h: int, kvh: int, *, causal: bool, window: int,
             q_offset: int, sms: int, kv_bf16: bool = False) -> KeySplit:
    """The backward's plan and scratch on a card of ``sms`` SMs, for float32
    or (``kv_bf16``) bfloat16 k/v (the rules the CUDA entry point applies):
    0 chunks for the recomputing dQ pass (every width but 256, and
    ``bwd_wide`` where its dQ grid fills a wave), else ``bwd_wide``'s dS
    path; the dK/dV pass's head subsets (more than 1 in ``bwd_wide`` under
    a wave of dK/dV blocks, and in ``bwd_wgmma``'s 128-wide template where
    subsets shorten an unbalanced grid of under two waves); 1 k/v part
    where bf16 k/v are taken as they are (``bwd_wgmma`` at hd 64,
    ``bwd_wide``'s recomputing passes), else 3."""
    return _plan_call(_build.plan_library().rt_flash_attention_bwd_plan, hd, b, tq, tk, h, kvh,
                      q_offset, window, causal, kv_bf16, sms, extra=2)


def bwd_products(kv_parts: int) -> dict[str, int]:
    """bf16 products per float32 product of each of the backward's five
    matrix products in the instance that runs with ``kv_parts`` parts of k
    and v (``bwd_plan``): ``BWD_SPLIT`` each for 3 (float32 values); for 1
    (bf16 k/v in ``bwd_wgmma`` at hd 64 and in ``bwd_wide``) 3 in S, dP and
    dQ, whose one operand is k or v, and ``BWD_SPLIT`` in dV and dK."""
    kv = {3: BWD_SPLIT, 1: 3}[kv_parts]
    return {"S": kv, "dP": kv, "dV": BWD_SPLIT, "dK": BWD_SPLIT, "dQ": kv}


def _empty_out(shape: tuple, dev: torch.device) -> torch.Tensor:
    """A float32 output of the training forward (o, lse): uninitialised; the
    kernels write every element."""
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _scratch_bytes(nbytes: int, dev: torch.device) -> torch.Tensor:
    """A call's own scratch (the key split's partials and dS, the backward's
    parts): uninitialised, from the caching allocator; the kernels write
    every word they read."""
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def kernel_head_dim(hd: int) -> int:
    """The kernels' template width for head width ``hd``: ``hd`` itself, or
    128 for 112 and 120 (the columns past hd load as zeros and are never
    stored).  Raises for a width no kernel serves."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    return 128 if hd in (112, 120) else hd


def fwd_design(hd: int, kv_dtype: torch.dtype, rows_per_kv_head: int, lse: bool = False) -> str:
    """The forward's design (as the CUDA entry point chooses) for head width
    ``hd``, k/v of ``kv_dtype`` and Tq * groups query rows per kv head:
    ``flash_decode`` for at most ``SPLIT_ROWS`` rows (unless the
    log-sum-exp is wanted), else ``flash_wgmma`` for bfloat16 k/v,
    ``flash_wgmma_split`` for float32 k/v up to width 128 and
    ``flash_tiled`` for float32 k/v at 256, whose split parts do not fit the
    shared memory two stages deep."""
    if not lse and rows_per_kv_head <= SPLIT_ROWS:
        return "flash_decode"
    if kv_dtype == torch.bfloat16:
        return "flash_wgmma"
    return "flash_wgmma_split" if kernel_head_dim(hd) <= 128 else "flash_tiled"


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """``flash_wgmma``'s plan for a call, as ``csrc/attn_plan.h`` decides it:
    the keys of a streamed tile and the ring's stages of the instance that
    runs, and on float32 k/v (``flash_wgmma_split``) the keys
    [``k_begin``, ``k_end``) whose bf16 parts its prologue writes and the
    scratch bytes they take ([k, v][part][B x KV][keys][kernel_head_dim(hd)]
    bf16); on bfloat16 k/v 0 bytes."""

    tile_keys: int
    stages: int
    k_begin: int
    k_end: int
    scratch_bytes: int


def fwd_plan(hd: int, kv_dtype: torch.dtype, b: int, tq: int, tk: int, h: int, kvh: int, *,
             causal: bool, window: int, q_offset: int, kv_len: int) -> FwdPlan:
    """``flash_wgmma``'s plan at head width ``hd`` on k/v of ``kv_dtype``
    (the rule the CUDA entry point applies)."""
    out = [ctypes.c_int() for _ in range(4)]
    nbytes = ctypes.c_int64()
    rc = _build.plan_library().rt_flash_fwd_plan(
        hd, int(kv_dtype == torch.bfloat16), b, tq, tk, h, kvh, q_offset, window, kv_len,
        int(causal), *(ctypes.addressof(x) for x in out), ctypes.addressof(nbytes))
    if rc != 0:
        raise ValueError(f"flash_attention: no flash_wgmma plan for hd {hd}, {kv_dtype}, sizes "
                         f"{(b, tq, tk, h, kvh)}")
    return FwdPlan(*(x.value for x in out), nbytes.value)


def rows_seeing_keys(tq: int, tk: int, *, causal: bool, window: int, q_offset: int,
                     kv_len: int | None) -> tuple[int, int]:
    """The query rows [first, end) that see a key (``ref.key_mask``'s
    non-empty rows; first >= end where none does).  The rows that see none
    lie at the two ends, each the mean of v over all Tk keys: before the
    first key's position (causal), or past the last key by the window.  In
    closed form, host ints (a fake tensor holds no mask)."""
    last = (tk if kv_len is None else min(int(kv_len), tk)) - 1
    if last < 0:
        return 0, 0
    first = min(tq, max(0, -q_offset)) if causal else 0  # position >= 0
    end = tq if window <= 0 else min(tq, last + window - q_offset)  # position - window < last
    return first, max(first, end)


def bwd_design(hd: int) -> str:
    """The backward's design at head width ``hd`` (as the CUDA entry point
    chooses): ``bwd_wgmma`` for 32, 64, 112, 120, 128; ``bwd_wide`` for 256, whose
    split operands do not fit bwd_wgmma's layout (fixed operands kept
    float32, two warpgroups that split the columns)."""
    return "bwd_wgmma" if kernel_head_dim(hd) <= 128 else "bwd_wide"


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v) -> torch.device:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor on {dev}, got {t.device}")
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention: q must be float32, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: k/v must both be bfloat16 or float32, got {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q [B,Tq,H,hd], k/v [B,Tk,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    kernel_head_dim(hd)
    if tq < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: Tq and Tk must be >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        per16 = 16 // t.element_size()  # 16-byte vector loads of each row
        if t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} rows must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")
    return dev


def _launch(q, k, v, o, *, causal, window, softcap, q_offset, kv_len, lse=None) -> None:
    global launches
    dev = _check(q, k, v)
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    kv_len = tk if kv_len is None else int(kv_len)
    window, q_offset = int(window), int(q_offset)
    if max(b * tq * h, b * tk * kvh, abs(q_offset) + tq, abs(kv_len)) >= 2**31:
        raise ValueError("flash_attention: sizes must fit int32")
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                    *o.stride()[:3])
    design = fwd_design(hd, k.dtype, tq * (h // kvh), lse=lse is not None)
    sms = _sm_count(dev.index or 0)
    part, kv_parts, nsplit, k_begin, k_end, chunk = None, None, 0, 0, 0, 0
    split = None  # flash_tiled's key-split partials (none unsplit)
    if design == "flash_decode":
        k_begin, k_end = key_range(tq, tk, causal=causal, window=window, q_offset=q_offset,
                                   kv_len=kv_len)
        nsplit, chunk = split_plan(k_end - k_begin, b * kvh, sms)
        part = _decode_scratch(dev, b * kvh, b * kvh * nsplit * tq * (h // kvh)
                               * (2 + kernel_head_dim(hd)))
    elif design == "flash_wgmma_split":
        plan = fwd_plan(hd, k.dtype, b, tq, tk, h, kvh, causal=causal, window=window,
                        q_offset=q_offset, kv_len=kv_len)
        kv_parts = _scratch_bytes(plan.scratch_bytes, dev)
    elif design == "flash_tiled":
        plan = tiled_plan(b, tq, tk, h, kvh, causal=causal, window=window, q_offset=q_offset,
                          kv_len=kv_len, sms=sms)
        if plan.scratch_bytes:
            split = _scratch_bytes(plan.scratch_bytes, dev)
    rc = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(k.dtype == torch.bfloat16), hd, b, tq, tk, h, kvh, ctypes.addressof(strides),
        q_offset, window, kv_len, int(causal), float(softcap), _build.ptr(lse),
        _build.ptr(kv_parts), _build.ptr(part), nsplit, k_begin, k_end, chunk,
        _build.ptr(split), 0 if split is None else split.numel(), sms, _build.stream(dev),
    )
    _build.check(rc, "flash_attention")
    launches += 1
    fwd_design_launches[design] += 1
    if split is not None:
        split_launches["flash_tiled"] += 1


def flash_attention(
    q: torch.Tensor,       # [B, Tq, H, hd] float32
    k: torch.Tensor,       # [B, Tk, KV, hd] bfloat16 or float32
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """[B, Tq, H, hd] float32 attention output (semantics of ``ref.attention_ref``)."""
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch(q, k, v, o, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
            kv_len=kv_len)
    return o


def flash_attention_heads(
    q: torch.Tensor,       # [BH, Tq, hd], BH = BKV * groups
    k: torch.Tensor,       # [BKV, Tk, hd]
    v: torch.Tensor,
    kv_len: int,
    *,
    groups: int = 1,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The Pallas kernel's head-major contract; [BH, Tq, hd] float32."""
    bh, tq, hd = q.shape
    bkv = k.shape[0]
    if bh != bkv * groups:
        raise ValueError(f"flash_attention_heads: BH {bh} != BKV {bkv} x groups {groups}")
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch(q.view(bkv, groups, tq, hd).transpose(1, 2), k[:, :, None], v[:, :, None],
            o.view(bkv, groups, tq, hd).transpose(1, 2), causal=causal, window=window,
            softcap=softcap, q_offset=0, kv_len=kv_len)
    return o


def flash_attention_lse(
    q: torch.Tensor,       # [B, Tq, H, hd] float32
    k: torch.Tensor,       # [B, Tk, KV, hd] bfloat16 or float32
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training path's forward: (o [B, Tq, H, hd], lse [B, H, Tq])
    float32 from a prefill design (``fwd_design`` with lse)."""
    b, t, h, _ = q.shape
    o = _empty_out(tuple(q.shape), q.device)
    lse = _empty_out((b, h, t), q.device)
    _launch(q, k, v, o, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
            kv_len=kv_len, lse=lse)
    return o, lse


def flash_attention_bwd(
    q: torch.Tensor,       # [B, Tq, H, hd] float32
    k: torch.Tensor,       # [B, Tk, KV, hd] float32 or bfloat16
    v: torch.Tensor,
    o: torch.Tensor,       # [B, Tq, H, hd]: the forward's output
    lse: torch.Tensor,     # [B, H, Tq]: the forward's log-sum-exp
    do: torch.Tensor,      # [B, Tq, H, hd]: the gradient of o
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_lse``'s output at kv_len Tk
    (semantics of ``ref.attention_bwd_ref``: a row that sees no key adds
    nothing); every tensor contiguous, on one card, any q_offset, Tq and Tk.
    k and v are float32 or both
    bfloat16: bfloat16 k/v enter the kernel as they are where ``bwd_plan``
    gives one k/v part (``bwd_wgmma`` at hd 64, ``bwd_wide``'s recomputing
    passes), else as their float32 values (exact); dk, dv come back rounded to bfloat16, as the
    gradient of the reference's upcast is; everything else is float32."""
    global bwd_launches
    dev = _build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    kv_dtype = k.dtype
    if kv_dtype not in (torch.float32, torch.bfloat16) or v.dtype != kv_dtype:
        raise ValueError(f"flash_attention_bwd: k/v must both be float32 or bfloat16, got "
                         f"{k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("o", o), ("lse", lse), ("do", do)):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: {name} must be float32, got {t.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention_bwd: want q [B,Tq,H,hd], k/v [B,Tk,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, hd) or h % kvh:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, t):
        raise ValueError("flash_attention_bwd: o and do must have q's shape, lse [B, H, Tq]")
    kernel_head_dim(hd)
    if max(b * t * h, b * tk * kvh) * hd >= 2**31:
        raise ValueError("flash_attention_bwd: sizes must fit int32")
    dq = torch.empty_like(q)
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(v.shape, dtype=torch.float32, device=dev)
    sms = _sm_count(dev.index or 0)
    # the parts of q, dO, k, v, the padded lse, D, on the dS path dS and the
    # dQ partials, with a head split the dK and dV partials
    plan = bwd_plan(hd, b, t, tk, h, kvh, causal=bool(causal), window=int(window),
                    q_offset=int(q_offset), sms=sms, kv_bf16=kv_dtype == torch.bfloat16)
    kv_bf16 = plan.kv_parts == 1
    if not kv_bf16:
        k, v = k.float(), v.float()
    scratch = _scratch_bytes(plan.scratch_bytes, dev)
    rc = _build.library().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), scratch.numel(), hd, b, t,
        tk, h, kvh, int(q_offset), int(window), int(causal), float(softcap), int(kv_bf16), sms,
        _build.stream(dev),
    )
    _build.check(rc, "flash_attention_bwd")
    bwd_launches += 1
    bwd_design_launches[bwd_design(hd)] += 1
    if plan.chunks:
        split_launches["bwd_wide"] += 1
    if plan.head_splits > 1:
        head_split_launches[bwd_design(hd)] += 1
    if kv_bf16:
        bf16_kv_launches[bwd_design(hd)] += 1
    return dq, dk.to(kv_dtype), dv.to(kv_dtype)
