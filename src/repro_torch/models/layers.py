"""Shared neural layers: RMSNorm, RoPE, GQA attention (windowed / cached),
gated MLP, embeddings, cross-entropy — the port of ``repro.models.layers``.

Every attention call goes to ``kernels/flash_attention/ops.py``: the
hand-written CUDA kernel for CUDA tensors, its plain version for CPU
tensors.  There is no direct/blocked split by sequence length as in the
reference; the kernel covers both, and applies the logit softcap itself.  When autograd records and an input
requires a gradient (the training forward), the call goes through the
kernel's ``autograd.Function``, whose backward is the hand-written backward
kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on split halves. x: [B, T, H, hd]; positions: [B, T] or [T]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, T, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """GQA scaled-dot-product attention.

    q: [B, Tq, H, hd]; k, v: [B, Tk, KV, hd] with H % KV == 0.  ``window`` > 0
    masks keys ``window`` or more behind the query (a host int, so one call
    serves local and global layers); ``q_offset`` is the absolute position
    of q[:, 0]; ``kv_len`` masks the valid prefix of the KV buffer.
    """
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                  q_offset=q_offset, kv_len=kv_len)


def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """wi: [d, 2*ff] (gate||up fused); wo: [ff, d]."""
    ff = wo.shape[0]
    gu = x @ wi
    gate, up = gu[..., :ff], gu[..., ff:]
    # jax.nn.gelu defaults to the tanh approximation
    a = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return (a * up) @ wo


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False) -> torch.Tensor:
    """Rows of ``table``; ``scale`` multiplies by sqrt(d) in float32 (the
    reference's numpy scalar promotes a bfloat16 table to float32)."""
    x = table[tokens]
    if scale:
        x = x.float() * np.float32(np.sqrt(table.shape[-1])).item()
    return x


def init_linear(gen: torch.Generator | None, shape, scale=None, device=None) -> torch.Tensor:
    """Normal(0, 1) * scale (default 1/sqrt(fan_in)) from ``gen``, float32.
    On the meta device only the shape is made."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    device = torch.device(device) if device is not None else gen.device
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(s)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None,
                  z_coef: float = 1e-4) -> torch.Tensor:
    """Token-mean CE + z-loss (``z_coef * lse^2``); logits [.., V] in float32,
    labels [..] int, mask [..] (bool or float) or None."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    per_tok = (lse - ll) + z_coef * lse.square()
    if mask is None:
        return per_tok.sum() / labels.numel()
    per_tok = per_tok * mask
    return per_tok.sum() / torch.clamp(mask.sum(), min=1)
