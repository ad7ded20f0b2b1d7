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
