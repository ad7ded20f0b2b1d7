"""Public flash-attention ops: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

``flash_attention`` takes the differentiable path (:class:`FlashAttention`:
the forward kernel that keeps each row's log-sum-exp, and the backward
kernel) when autograd records and q, k or v requires a gradient: the
training forward, the islands of the sequence-split attention (a
``q_offset``, Tq < Tk) and a cross-attention (Tq != Tk), with kv_len Tk and
the shapes ``kernel.check_grad_shape`` admits.  Serving never records a
graph and keeps the forward designs of ``kernel.py``."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


class FlashAttention(torch.autograd.Function):
    """Attention with a hand-written backward.  forward saves q, k, v, o and
    lse; backward launches ``csrc/flash_attention_bwd.cu`` (a CPU tensor:
    ``ref.attention_bwd_ref``).  q of another float type is taken as its
    float32 value, and k/v as they are (float32 or bfloat16: the forward
    reads bf16 k/v as they are, and so does the backward's hd-256 design
    ``bwd_wide`` where ``kernel.bwd_plan`` gives one k/v part, its products
    with k or v then three bf16 products each; elsewhere the backward reads
    their float32 values); o is float32, and each gradient comes back in
    its input's type."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float, q_offset: int):
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        ctx.q_dtype = q.dtype
        q = q.float()
        if q.device.type == "cpu":
            o, lse = ref.attention_lse_ref(q, k, v, **kw)
        else:
            o, lse = kernel.flash_attention_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = ref.attention_bwd_ref(q, k, v, o, lse, do, **ctx.kw)
        else:
            dq, dk, dv = kernel.flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq.to(ctx.q_dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


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
        if kv_len is not None and kv_len != k.shape[1]:
            raise NotImplementedError("flash_attention's gradient covers kv_len == Tk (no "
                                      "training path reads a partly filled cache)")
        kernel.check_grad_shape(q.shape[1], k.shape[1], causal=bool(causal), window=int(window),
                                q_offset=int(q_offset))
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
                                    int(window), float(softcap), int(q_offset))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, **kw)
    return kernel.flash_attention(q, k, v, **kw)


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
    kw = dict(groups=groups, causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.attention_heads_ref(q, k, v, kv_len, **kw)
    return kernel.flash_attention_heads(q, k, v, kv_len, **kw)
