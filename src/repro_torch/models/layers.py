"""Shared neural layers: RMSNorm, RoPE, GQA attention (windowed / cached),
gated MLP, embeddings, cross-entropy — the port of ``repro.models.layers``.

Every attention call goes to ``kernels/flash_attention/ops.py``: the
hand-written CUDA kernel for CUDA tensors, its plain version for CPU
tensors.  There is no direct/blocked split by sequence length as in the
reference; the kernel covers both, and applies the logit softcap itself.  When autograd records and an input
requires a gradient (the training forward), the call goes through the
kernel's ``autograd.Function``, whose backward is the hand-written backward
kernel.  ``attention_sharded`` splits a call over a mesh's tensor-parallel
axis (``core.backends.direct``), each rank's island a plain local call.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.backends import direct
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

    q may be of any float type: the kernel takes its float32 value, and the
    output comes back in q's type, as the reference's attention upcasts
    inside and casts back.  k/v go through as they are: bfloat16 k/v (a
    cache, or a bfloat16 model's projections) equal their float32 value,
    which the reference reads, and keep the kernel on its bf16 designs.
    """
    out = fa_ops.flash_attention(q.float(), k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    return out.to(q.dtype)


def copy_to_group(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """``x``, held alike by every rank of mesh axis ``axis``, into a
    computation each rank runs on its own part of it: the backward sums the
    ranks' gradients, so that every rank gets the whole gradient."""
    return _CopyToGroup.apply(x, axis, mesh)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward on a tensor every rank of ``group`` holds alike; the
    backward sums the ranks' gradients (each rank's island reads only its
    part of it), so every rank gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return direct.allreduce(g, ctx.axis, ctx.mesh), None, None


def shard_plan(h: int, kvh: int, t: int, tps: int) -> str | None:
    """The reference's choice for ``attention_sharded``: ``"head"`` when the
    q heads split over the tp ranks (H % tp == 0, and each rank's heads map
    to a contiguous kv subset), else ``"seq"`` when the sequence splits into
    pieces of at least 256 rows, else None (no split)."""
    g = h // kvh
    if h % tps == 0 and h >= tps:
        h_local = h // tps
        if h_local % g == 0 or g % h_local == 0:
            return "head"
    if t % tps == 0 and t // tps >= 256:
        return "seq"
    return None


def attention_island(q_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rank: int, tps: int,
                     *, plan: str, causal: bool = True, window: int = 0, softcap: float = 0.0,
                     q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """Tp rank ``rank``'s island of :func:`attention_sharded`: a plain local
    attention call, no collective.  ``q_l`` is the rank's piece of q (plan
    ``"head"``: its H / tp heads; ``"seq"``: its T / tp rows), k and v the
    whole (replicated) tensors.  A head split reads the kv heads its q heads
    map to (a contiguous slice, no copy); a sequence split offsets the
    positions by the piece's first row, so it attends at ``q_offset + rank
    x T / tp`` over every key (the backward at a query offset, Tq < Tk)."""
    if plan == "head":
        h_local, g = q_l.shape[2], q_l.shape[2] * tps // k.shape[2]
        first = rank * h_local // g
        n_kv = max(1, h_local // g)
        k, v = k[:, :, first:first + n_kv], v[:, :, first:first + n_kv]
    else:
        q_offset = q_offset + rank * q_l.shape[1]
    return attention(q_l, k, v, causal=causal, window=window, softcap=softcap,
                     q_offset=q_offset, kv_len=kv_len)


def attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ctx, *,
                      causal: bool = True, window: int = 0, softcap: float = 0.0,
                      q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """Attention split over the tensor-parallel axis ``ctx.tp_axis``: each tp
    rank runs a fully local flash island on its heads (``"head"``) or its
    rows (``"seq"``, context-parallel: k/v whole, positions offset), then
    the islands' outputs are all-gathered (``shard_plan`` chooses, as the
    reference does).  Every rank of the tp axis holds the same q, k, v (the
    activations are replicated over it); the gradients reach every rank
    whole (the copy's backward sums the islands' pieces).  The reference's
    ``b % dp`` condition has no counterpart: a rank already holds only its
    dp shard of the batch.  Without a tp axis of size > 1 in the mesh, or
    with no admissible split, this is :func:`attention`."""
    mesh, tp = ctx.mesh, ctx.tp_axis
    tps = direct.axis_size(tp, mesh) if mesh is not None and tp in mesh.mesh_dim_names else 1
    plan = shard_plan(q.shape[2], k.shape[2], q.shape[1], tps) if tps > 1 else None
    if plan is None:
        return attention(q, k, v, causal=causal, window=window, softcap=softcap,
                         q_offset=q_offset, kv_len=kv_len)
    rank = direct.axis_index(tp, mesh)
    q, k, v = (copy_to_group(x, tp, mesh) for x in (q, k, v))
    dim = 2 if plan == "head" else 1
    n = q.shape[dim] // tps
    q_l = q.narrow(dim, rank * n, n)
    out = attention_island(q_l, k, v, rank, tps, plan=plan, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    return direct.allgather_alike(out.contiguous(), tp, dim=dim, mesh=mesh)


def remat(cfg, fn, x: torch.Tensor, *args):
    """``fn(x, *args)``, one layer of a training forward: with ``cfg.remat``
    and autograd recording, under ``torch.utils.checkpoint``, so that its
    activations are recomputed in the backward (the reference's
    ``jax.checkpoint`` saves its products instead, which changes memory,
    not the result)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(x, *args)


def check_products(device: torch.device, dtype: torch.dtype) -> None:
    """Refuse to run on the card where cuBLAS would compute other products
    than the reference's: float32 products in TF32
    (``torch.backends.cuda.matmul.allow_tf32``, off by default), or
    ``dtype`` (the model's activations) bfloat16 with partial sums in
    bfloat16 (``allow_bf16_reduced_precision_reduction``, on by default;
    the reference's bfloat16 products sum in float32)."""
    if device.type != "cuda":
        return
    matmul = torch.backends.cuda.matmul
    if matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: the reference's "
                           "float32 products would be computed in TF32")
    if dtype == torch.bfloat16 and matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError("torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction "
                           "is on: the reference's bfloat16 products sum in float32; set it "
                           "to False")


def kv_as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """k or v as attention reads the reference's ``t.astype(dtype)``: a
    bfloat16 tensor as it is (its values are exact in any wider type, and
    the kernel upcasts them itself), any other cast to ``dtype``."""
    return t if t.dtype == torch.bfloat16 else t.to(dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` under the reference's type promotion: operands of two float
    types meet in the wider one (bfloat16 activations times float32
    weights, or float32 times bfloat16, is a float32 product)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation).  In float32 the
    fused ``F.gelu`` agrees to 1e-6; in a narrower type the reference
    evaluates the formula op by op, each rounded to that type (its
    constants too), which a fused kernel's single rounding would not
    reproduce, so the port does the same."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")

    def const(c):
        return torch.tensor(c, dtype=torch.float32, device=x.device).to(x.dtype)

    inner = const(np.sqrt(2 / np.pi)) * (x + const(0.044715) * x ** 3)
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """wi: [d, 2*ff] (gate||up fused); wo: [ff, d]."""
    ff = wo.shape[0]
    gu = x @ wi
    gate, up = gu[..., :ff], gu[..., ff:]
    a = F.silu(gate) if act == "silu" else gelu(gate)
    return (a * up) @ wo


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False) -> torch.Tensor:
    """Rows of ``table``; ``scale`` multiplies by sqrt(d) in float32 (the
    reference's numpy scalar promotes a bfloat16 table to float32)."""
    x = table[tokens]
    if scale:
        x = x.float() * np.float32(np.sqrt(table.shape[-1])).item()
    return x


_INIT_PIECE = 1 << 26   # float32 scratch elements per draw of a narrower leaf


def init_linear(gen: torch.Generator | None, shape, scale=None, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 1) * scale (default 1/sqrt(fan_in)) from ``gen``, drawn in
    float32 and held in ``dtype``.  A narrower leaf is drawn in pieces of
    ``_INIT_PIECE`` elements, so a layer of bfloat16 experts never exists
    in float32 at once.  On the meta device only the shape is made."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    device = torch.device(device) if device is not None else gen.device
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(s)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _INIT_PIECE):
        piece = flat[i:i + _INIT_PIECE]
        piece.copy_(torch.randn(piece.shape, generator=gen, dtype=torch.float32,
                                device=device).mul_(s))
    return out


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        z_coef: float = 1e-4) -> tuple[torch.Tensor, torch.Tensor | int]:
    """The numerator and denominator of :func:`cross_entropy`: the masked sum
    of the per-token CE + z-loss, and the mask's sum (the token count
    without a mask), each to be summed over the data-parallel shards of a
    global mean."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    per_tok = (lse - ll) + z_coef * lse.square()
    if mask is None:
        return per_tok.sum(), labels.numel()
    return (per_tok * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None,
                  z_coef: float = 1e-4) -> torch.Tensor:
    """Token-mean CE + z-loss (``z_coef * lse^2``); logits [.., V] in float32,
    labels [..] int, mask [..] (bool or float) or None."""
    total, count = cross_entropy_terms(logits, labels, mask, z_coef)
    if mask is None:
        return total / count
    return total / torch.clamp(count, min=1)
