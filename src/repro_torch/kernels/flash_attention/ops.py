"""Public flash-attention ops: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

Each call goes through a ``torch.library.custom_op`` (``repro_torch::``
``flash_attention``, ``flash_attention_lse``, ``flash_attention_bwd``,
``flash_attention_heads``), whose implementation the dispatcher picks by
the tensors' device: on the CPU the plain version (``ref.py``), on the card
the kernel's wrapper (``kernel.py``), which launches it or raises.  There is
no other branch: a fake tensor (``torch._subclasses.FakeTensorMode``, the
dry-run's) reaches neither, only the op's fake implementation, which gives
the outputs' shapes and types and allocates, as fakes, the scratch the CUDA
wrapper allocates for the same call (read from ``kernel.py``'s own plan
functions at the H100's ``H100_SMS`` SMs), so that a memory count sees what
the card holds.  Each op carries a ``FlopCounterMode`` formula for the
kernel's own work: 4 hd operations per visible (query, key) pair forward, 10
hd backward (S recomputed, dP, dV, dK, dQ), the pairs in closed form
(``visible_pairs``, never a mask).

``flash_attention`` takes the differentiable path (:class:`FlashAttention`:
the forward kernel that keeps each row's log-sum-exp, and the backward
kernel) when autograd records and q, k or v requires a gradient: the
training forward, the islands of the sequence-split attention (a
``q_offset``, Tq < Tk) and a cross-attention (Tq != Tk), at any kv_len and
q_offset, as the reference's ``jax.grad`` takes them.  Serving never records
a graph and keeps the forward designs of ``kernel.py``."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import kernel, ref

H100_SMS = 132   # the SMs of an H100 SXM5: the plans the fakes' scratch is read from

# bytes of scratch the fake implementations allocated, one entry per call,
# for a memory count to take (``launch.hlo_analysis``); None: not kept
fake_scratch: list[int] | None = None


def visible_pairs(tq: int, tk: int, *, causal: bool, window: int, q_offset: int,
                  kv_len: int | None) -> int:
    """Σ over the query rows of the keys each row sees (``ref.key_mask``'s
    row sums), a row that sees none counted as all Tk (it averages them):
    in closed form, the per-row count being linear between the rows where
    the causal edge meets the last key and where the window's edge leaves
    key 0."""
    last = (tk if kv_len is None else min(kv_len, tk)) - 1

    def count(p: int) -> int:
        hi = min(last, p) if causal else last
        lo = max(0, p - window + 1) if window > 0 else 0
        return hi - lo + 1

    p0, p1 = q_offset, q_offset + tq          # rows p0 .. p1 - 1
    cuts = sorted({p0, p1} | {c for c in (last + 1, window) if p0 < c < p1})
    total = 0
    for a, b in zip(cuts, cuts[1:]):
        c0, s = count(a), (count(a + 1) - count(a) if b - a > 1 else 0)
        # rows a .. b - 1 see c0 + s (p - a) keys: positive on [a, e)
        if s >= 0:
            first = a if c0 > 0 else (b if s == 0 else min(b, a + (-c0) // s + 1))
            n = b - first
            c_first = c0 + s * (first - a)
            total += n * c_first + s * n * (n - 1) // 2 + (first - a) * tk
        else:
            e = min(b, a + (c0 - 1) // (-s) + 1) if c0 > 0 else a
            n = e - a
            total += n * c0 + s * n * (n - 1) // 2 + (b - e) * tk
    return total


def _kv_len(kv_len: int) -> int | None:
    return None if kv_len < 0 else kv_len


def _note_scratch(nbytes: int, device: torch.device) -> None:
    """A fake call's scratch: allocated (a fake) and dropped, as the CUDA
    wrapper's is within its call, and kept for the memory count."""
    if nbytes:
        torch.empty(nbytes, dtype=torch.uint8, device=device)
        if fake_scratch is not None:
            fake_scratch.append(nbytes)


def _fwd_scratch(q, k, *, causal, window, q_offset, kv_len, lse: bool) -> int:
    """Scratch bytes of one forward call, as ``kernel._launch`` allocates them."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    kv_len = tk if kv_len is None else int(kv_len)
    design = kernel.fwd_design(hd, k.dtype, tq * (h // kvh), lse=lse)
    if design == "flash_wgmma_split":
        return kernel.fwd_plan(hd, k.dtype, b, tq, tk, h, kvh, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len).scratch_bytes
    if design == "flash_tiled":
        return kernel.tiled_plan(b, tq, tk, h, kvh, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len, sms=H100_SMS).scratch_bytes
    if design == "flash_decode":
        k0, k1 = kernel.key_range(tq, tk, causal=causal, window=window, q_offset=q_offset,
                                  kv_len=kv_len)
        nsplit, _ = kernel.split_plan(k1 - k0, b * kvh, H100_SMS)
        counters = -(-b * kvh // 32) * 32
        return 4 * (counters + b * kvh * nsplit * tq * (h // kvh)
                     * (2 + kernel.kernel_head_dim(hd)))
    return 0


# -- the forward -------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
         softcap: float, q_offset: int, kv_len: int) -> torch.Tensor:
    return ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             q_offset=q_offset, kv_len=_kv_len(kv_len))


@_fwd.register_kernel("cuda")
def _fwd_cuda(q, k, v, causal, window, softcap, q_offset, kv_len):
    return kernel.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                  q_offset=q_offset, kv_len=_kv_len(kv_len))


@_fwd.register_fake
def _fwd_fake(q, k, v, causal, window, softcap, q_offset, kv_len):
    _note_scratch(_fwd_scratch(q, k, causal=causal, window=window, q_offset=q_offset,
                               kv_len=_kv_len(kv_len), lse=False), q.device)
    return torch.empty(q.shape, dtype=torch.float32, device=q.device)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=(),
                         device_types="cpu")
def _fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
             softcap: float, q_offset: int,
             kv_len: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    return ref.attention_lse_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                 q_offset=q_offset, kv_len=_kv_len(kv_len))


@_fwd_lse.register_kernel("cuda")
def _fwd_lse_cuda(q, k, v, causal, window, softcap, q_offset, kv_len=-1):
    return kernel.flash_attention_lse(q, k, v, causal=causal, window=window, softcap=softcap,
                                      q_offset=q_offset, kv_len=_kv_len(kv_len))


@_fwd_lse.register_fake
def _fwd_lse_fake(q, k, v, causal, window, softcap, q_offset, kv_len=-1):
    _note_scratch(_fwd_scratch(q, k, causal=causal, window=window, q_offset=q_offset,
                               kv_len=_kv_len(kv_len), lse=True), q.device)
    b, t, h, _ = q.shape
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty((b, h, t), dtype=torch.float32, device=q.device))


# -- the backward ------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
         do: torch.Tensor, causal: bool, window: int, softcap: float,
         q_offset: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dq, dk, dv = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                       softcap=softcap, q_offset=q_offset)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


@_bwd.register_kernel("cuda")
def _bwd_cuda(q, k, v, o, lse, do, causal, window, softcap, q_offset):
    return kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                      softcap=softcap, q_offset=q_offset)


@_bwd.register_fake
def _bwd_fake(q, k, v, o, lse, do, causal, window, softcap, q_offset):
    b, t, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    plan = kernel.bwd_plan(hd, b, t, tk, h, kvh, causal=causal, window=window,
                           q_offset=q_offset, sms=H100_SMS, kv_bf16=k.dtype == torch.bfloat16)
    extra = 0
    if k.dtype != torch.float32:  # float32 dk, dv before their cast; k, v as float32
        extra = 2 * k.numel() * 4 * (1 if plan.kv_parts == 1 else 2)
    _note_scratch(plan.scratch_bytes + extra, q.device)
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=q.device),
            torch.empty(v.shape, dtype=v.dtype, device=q.device))


# -- the head-major contract -------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention_heads", mutates_args=(),
                         device_types="cpu")
def _heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int, groups: int,
           causal: bool, window: int, softcap: float) -> torch.Tensor:
    return ref.attention_heads_ref(q, k, v, kv_len, groups=groups, causal=causal, window=window,
                                   softcap=softcap)


@_heads.register_kernel("cuda")
def _heads_cuda(q, k, v, kv_len, groups, causal, window, softcap):
    return kernel.flash_attention_heads(q, k, v, kv_len, groups=groups, causal=causal,
                                        window=window, softcap=softcap)


@_heads.register_fake
def _heads_fake(q, k, v, kv_len, groups, causal, window, softcap):
    bkv, tk, hd = k.shape
    q4 = q.view(bkv, groups, q.shape[1], hd).transpose(1, 2)
    _note_scratch(_fwd_scratch(q4, k[:, :, None], causal=causal, window=window, q_offset=0,
                               kv_len=kv_len, lse=False), q.device)
    return torch.empty(q.shape, dtype=torch.float32, device=q.device)


# -- the kernels' work ---------------------------------------------------------


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _fwd_flops(q, k, v, causal, window, softcap, q_offset, kv_len, out_shape=None, **kw):
    b, tq, h, hd = q
    return 4 * hd * b * h * visible_pairs(tq, k[1], causal=causal, window=window,
                                          q_offset=q_offset, kv_len=_kv_len(kv_len))


@register_flop_formula(torch.ops.repro_torch.flash_attention_lse)
def _fwd_lse_flops(q, k, v, causal, window, softcap, q_offset, kv_len=-1, out_shape=None, **kw):
    b, tq, h, hd = q
    return 4 * hd * b * h * visible_pairs(tq, k[1], causal=causal, window=window,
                                          q_offset=q_offset, kv_len=_kv_len(kv_len))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, v, o, lse, do, causal, window, softcap, q_offset, out_shape=None, **kw):
    b, tq, h, hd = q
    return 10 * hd * b * h * visible_pairs(tq, k[1], causal=causal, window=window,
                                           q_offset=q_offset, kv_len=None)


@register_flop_formula(torch.ops.repro_torch.flash_attention_heads)
def _heads_flops(q, k, v, kv_len, groups, causal, window, softcap, out_shape=None, **kw):
    bh, tq, hd = q
    return 4 * hd * bh * visible_pairs(tq, k[1], causal=causal, window=window, q_offset=0,
                                       kv_len=kv_len)


class FlashAttention(torch.autograd.Function):
    """Attention with a hand-written backward.  forward saves q, k, v, o and
    lse; backward calls ``repro_torch::flash_attention_bwd`` (the card:
    ``csrc/flash_attention_bwd.cu``; the CPU: ``ref.attention_bwd_ref``).
    q of another float type is taken as its float32 value, and k/v as they
    are (float32 or bfloat16: the forward reads bf16 k/v as they are, and so
    does the backward where ``kernel.bwd_plan`` gives one k/v part,
    ``bwd_wgmma`` at hd 64 and ``bwd_wide``, its products with k or v then
    three bf16 products each; elsewhere the backward reads their float32
    values); o is float32,
    and each gradient comes back in its input's type.

    Through a partly filled cache (kv_len < Tk) the backward runs on k and v
    cut to their first kv_len rows, and dk, dv are 0 past them: no row sees
    a key there.  A row that sees no key at all is the mean of v over all
    Tk keys (the reference masks with a finite -1e30): it adds do / Tk to
    every row of dv and nothing to dq or dk (``_empty_rows_dv``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float, q_offset: int,
                kv_len: int | None):
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        ctx.q_dtype = q.dtype
        q = q.float()
        o, lse = torch.ops.repro_torch.flash_attention_lse(
            q, k, v, causal, window, softcap, q_offset, -1 if kv_len is None else kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.kv_len = kw, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kw = ctx.kw
        do = do.contiguous()
        tk = k.shape[1]
        seen = tk if ctx.kv_len is None else max(0, min(ctx.kv_len, tk))
        if seen:
            kc, vc = (k, v) if seen == tk else (k[:, :seen].contiguous(), v[:, :seen].contiguous())
            dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
                q, kc, vc, o, lse, do, kw["causal"], kw["window"], kw["softcap"], kw["q_offset"])
            if seen < tk:  # no row sees a key past kv_len
                pad = (0, 0, 0, 0, 0, tk - seen)
                dk, dv = torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)
        else:
            dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        extra = _empty_rows_dv(do, k, causal=kw["causal"], window=kw["window"],
                               q_offset=kw["q_offset"], kv_len=ctx.kv_len)
        if extra is not None:
            dv = (dv.float() + extra).to(v.dtype)
        return (dq.to(ctx.q_dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def _empty_rows_dv(do, k, *, causal, window, q_offset, kv_len) -> torch.Tensor | None:
    """dv's term from the rows that see no key, each the mean of v over all
    Tk keys: the sum of their do over the query heads of each kv head, / Tk,
    on every key ([B, 1, KV, hd] float32); None where every row sees one."""
    b, tq, h, hd = do.shape
    tk, kvh = k.shape[1], k.shape[2]
    first, end = kernel.rows_seeing_keys(tq, tk, causal=causal, window=window, q_offset=q_offset,
                                         kv_len=kv_len)
    if (first, end) == (0, tq):
        return None
    g = do[:, :first].float().sum(1) + do[:, end:].float().sum(1)     # [B, H, hd]
    return (g.reshape(b, kvh, h // kvh, hd).sum(2) / tk)[:, None]


def flash_attention(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
                                    int(window), float(softcap), int(q_offset),
                                    None if kv_len is None else int(kv_len))
    return torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), int(window), float(softcap), int(q_offset),
        -1 if kv_len is None else int(kv_len))


def flash_attention_heads(
    q: torch.Tensor,       # [BH, Tq, hd]
    k: torch.Tensor,       # [BKV, Tk, hd]
    v: torch.Tensor,
    kv_len: int,
    *,
    groups: int = 1,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    return torch.ops.repro_torch.flash_attention_heads(q, k, v, int(kv_len), int(groups),
                                                       bool(causal), int(window), float(softcap))
