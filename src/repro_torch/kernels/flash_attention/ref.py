"""Plain PyTorch version of the flash-attention kernel
(``csrc/flash_attention.cu``): the naive full softmax.

It is the counterpart of both ``repro.kernels.flash_attention.ref.
attention_ref`` and ``repro.models.layers._attention_direct``: model layout,
GQA, causal, a run-time sliding ``window`` (0 = none), ``q_offset`` (the
absolute position of q[:, 0]), ``kv_len`` (the valid prefix of k/v) and a
tanh ``softcap``.  Masked logits are set to -1e30, never -inf, so a row with
no valid key comes out as the uniform mean of v over all Tk keys, as in the
reference.  Arithmetic is float32 whatever the input types; the result has
q's dtype.

:func:`attention_split_ref` emulates the numerics of the kernel's
tensor-core design (bf16 products of three-part splits, float32 sums); the
tests hold it against :func:`attention_ref` and the reference.  The model
path never calls it.
"""

from __future__ import annotations

import math

import torch

MASK_VALUE = -1e30


def key_mask(tq: int, tk: int, *, causal: bool, window: int, q_offset: int,
             kv_len: int | None, device) -> torch.Tensor:
    """[Tq, Tk] bool: which key each query row may attend to."""
    qpos = torch.arange(tq, device=device) + q_offset
    kpos = torch.arange(tk, device=device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    return mask


def attention_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd], H % KV == 0
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    qf = q.float() / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    # [B, KV, G, Tq, hd] x [B, Tk, KV, hd] -> [B, KV, G, Tq, Tk]
    qf = qf.reshape(b, tq, kvh, groups, hd).permute(0, 2, 3, 1, 4)
    logits = torch.einsum("bkgqh,bskh->bkgqs", qf, kf)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = key_mask(tq, tk, causal=causal, window=int(window), q_offset=int(q_offset),
                    kv_len=None if kv_len is None else int(kv_len), device=q.device)
    logits = logits.masked_fill(~mask, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bkgqh", probs, vf)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, hd).to(q.dtype)


def split_bf16(x: torch.Tensor, parts: int = 3) -> list[torch.Tensor]:
    """x as ``parts`` bfloat16 tensors: part i = bf16(x - the parts before
    it), rounded to nearest even.  Three parts keep all 24 bits of a float32
    mantissa, so their float32 sum is x to within float32 rounding."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16)
        out.append(part)
        rest = rest - part.float()
    return out


def attention_split_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd] bfloat16 (others are rounded to it)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
    parts: int = 3,
) -> torch.Tensor:
    """The tensor-core design's arithmetic: S = sum_i Qi . K^T with Qi the
    ``parts`` bf16 parts of q / sqrt(hd), p = exp(S - max) un-normalised,
    O = sum_i Pi . V / sum(p); every product of bf16 operands, every sum in
    float32.  [B, Tq, H, hd] float32."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    kf = k.to(torch.bfloat16).float()
    vf = v.to(torch.bfloat16).float()
    qf = (q.float() / math.sqrt(hd)).reshape(b, tq, kvh, groups, hd).permute(0, 2, 3, 1, 4)
    logits = sum(torch.einsum("bkgqh,bskh->bkgqs", part.float(), kf)
                 for part in split_bf16(qf, parts))
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = key_mask(tq, tk, causal=causal, window=int(window), q_offset=int(q_offset),
                    kv_len=None if kv_len is None else int(kv_len), device=q.device)
    logits = logits.masked_fill(~mask, MASK_VALUE)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = sum(torch.einsum("bkgqs,bskh->bkgqh", part.float(), vf)
              for part in split_bf16(p, parts))
    out = out / p.sum(-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, hd)


def attention_heads_ref(
    q: torch.Tensor,       # [BH, Tq, hd], BH = BKV * groups, head-major
    k: torch.Tensor,       # [BKV, Tk, hd]
    v: torch.Tensor,
    kv_len: int,
    *,
    groups: int = 1,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The Pallas kernel's head-major contract: q row ``i`` reads k/v row
    ``i // groups``.  The same function as :func:`attention_ref` with
    B = BKV, KV = 1 and H = groups."""
    bh, tq, hd = q.shape
    bkv, tk, _ = k.shape
    qm = q.reshape(bkv, groups, tq, hd).transpose(1, 2)
    out = attention_ref(qm, k[:, :, None], v[:, :, None], causal=causal, window=window,
                        softcap=softcap, kv_len=kv_len)
    return out.transpose(1, 2).reshape(bh, tq, hd)
