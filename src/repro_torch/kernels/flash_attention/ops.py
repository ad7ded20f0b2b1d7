"""Public flash-attention ops: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


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
