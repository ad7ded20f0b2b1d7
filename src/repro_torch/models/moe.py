"""Mixture-of-Experts block (qwen3-moe, kimi-k2) — the port of
``repro.models.moe``: local and expert-parallel dispatch.

Token -> expert dispatch is the paper's shuffle on one device: route each
token to its top-k experts, bucket the (token, slot) pairs by expert in a
stable sort (the partition phase of ``dataframe.partition``), run each
expert's FFN over its bucket, and combine the weighted outputs back per
token.  Capacity-factor dropping follows the reference: a pair past its
expert's ``cap`` rows contributes zero.  Routing is exact against the
reference: the same ``topi``, stable order, counts, slots and ``keep``.

The expert-parallel dispatch (``_moe_ep``, with a ``ctx`` whose
``ep_axis`` is set) is the dataframe shuffle at the tensor level: the
experts are split over the ep axis, each rank routes its share of the
tokens, all-to-alls the per-expert buckets to the experts' ranks
(``core.backends.direct``), runs its own experts and sends the results
back.  A rank holds either every expert or only its slice
(``interop.expert_slice`` cuts it from the reference's state).  It is
differentiable, as the reference's ``shard_map`` is under ``jax.grad``
(the collectives' autograd rules, and the rule in ``_moe_ep``'s doc).

Memory.  The expert stacks hold ``num_experts_padded`` experts, as the
reference's parameter tree does, but the padding experts are dead: the
router is ``num_experts`` wide, so no pair is ever bucketed to one, its
bucket rows are zeros and its outputs are never gathered.  The port
buckets and computes the live experts only, and reads their weights
``_EXPERT_SLICE`` experts at a time (each slice cast to ``cfg.dtype`` and
back to float32, as the reference's ``astype`` then float32 product reads
it), so a layer's float32 expert stack never exists at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.backends import direct
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

_EXPERT_SLICE = 16   # experts whose weights are read in float32 at once


def init_moe_block(cfg: ArchConfig, gen: torch.Generator | None, lcount: int, device,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Router [L, d, E] and the padded expert stacks [L, E_pad, d, 2 ff] /
    [L, E_pad, ff, d], held in ``dtype``."""
    e, d, ff = cfg.num_experts_padded, cfg.d_model, cfg.moe_d_ff
    return {
        "router": L.init_linear(gen, (lcount, d, cfg.num_experts), device=device, dtype=dtype),
        "wi": L.init_linear(gen, (lcount, e, d, 2 * ff), device=device, dtype=dtype),
        "wo": L.init_linear(gen, (lcount, e, ff, d), device=device, dtype=dtype),
    }


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``idx`` (int64 [n]): ``torch.bincount``
    with ``minlength=n`` for indices below n, at a length fixed by ``n``
    alone, so a step traces on tensors without data (fake tensors)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx.long(), torch.ones(idx.shape, dtype=torch.int64, device=idx.device))


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """Top-k routing. x2d: [N, d] -> (weights [N, k], experts [N, k], aux)."""
    logits = x2d.float() @ router.float()               # [N, E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.experts_per_token, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * P_e
    e = cfg.num_experts
    density = _counts(topi[:, 0], e).float() / topi.shape[0]
    mean_probs = probs.mean(0)
    aux = cfg.router_aux_coef * e * torch.sum(density * mean_probs)
    return topv, topi, aux


def _bucket_by_expert(x2d, topv, topi, num_experts: int, cap: int):
    """Scatter (token, slot) pairs into [E, cap, ...] buckets; returns the
    buckets and (e_sorted, slot_row, tok_sorted, w_sorted, keep), each in
    the stable expert order.  ``slot_row`` is ``cap`` for a dropped pair."""
    n, k = topi.shape
    flat_e = topi.reshape(-1)                            # [N*k]
    flat_w = topv.reshape(-1)
    flat_tok = torch.arange(n, device=topi.device).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    counts = _counts(flat_e, num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=topi.device) - starts[e_sorted]
    keep = pos < cap
    slot_row = torch.where(keep, pos, torch.full_like(pos, cap))
    tok_sorted = flat_tok[order]
    w_sorted = torch.where(keep, flat_w[order], torch.zeros_like(flat_w))

    buf = torch.zeros((num_experts, cap + 1, x2d.shape[-1]), dtype=x2d.dtype, device=x2d.device)
    buf[e_sorted, slot_row] = x2d[tok_sorted]   # every dropped pair lands in row cap
    return buf[:, :cap], (e_sorted, slot_row, tok_sorted, w_sorted, keep)


def _expert_ffn(buf, wi, wo, act: str):
    """Grouped FFN: buf [E, C, d] x wi [E, d, 2ff] -> [E, C, d]."""
    ff = wo.shape[-2]
    gu = torch.bmm(buf, wi)
    gate, up = gu[..., :ff], gu[..., ff:]
    a = F.silu(gate) if act == "silu" else L.gelu(gate)
    return torch.bmm(a * up, wo)


def _experts(cfg: ArchConfig, buf, wi, wo) -> torch.Tensor:
    """``_expert_ffn`` over the live experts' buckets, ``_EXPERT_SLICE``
    experts of weights at a time, each read as the reference's
    ``astype(cfg.dtype)`` in a float32 product."""
    cd = getattr(torch, cfg.dtype)
    out = torch.empty_like(buf)
    for e0 in range(0, buf.shape[0], _EXPERT_SLICE):
        e1 = min(e0 + _EXPERT_SLICE, buf.shape[0])
        out[e0:e1] = _expert_ffn(buf[e0:e1], wi[e0:e1].to(cd).float(), wo[e0:e1].to(cd).float(),
                                 cfg.act)
    return out


def moe_block(x: torch.Tensor, moe_params: dict, cfg: ArchConfig, ctx=None):
    """MoE FFN over x [B, T, d]; returns (out [B, T, d], aux loss scalar).
    With ``ctx.ep_axis`` set, the expert-parallel dispatch."""
    b, t, d = x.shape
    args = (x.reshape(b * t, d), moe_params["router"], moe_params["wi"], moe_params["wo"], cfg)
    if ctx is not None and ctx.ep_axis is not None:
        out2d, aux = _moe_ep(*args, ctx)
    else:
        out2d, aux = _moe_local(*args)
    return out2d.reshape(b, t, d), aux


def _moe_local(x2d, router, wi, wo, cfg: ArchConfig):
    """The reference's local dispatch over the live experts: ``wi`` / ``wo``
    may hold padding experts past ``num_experts`` (module doc)."""
    n = x2d.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = int(math.ceil(n * k / cfg.num_experts * cfg.capacity_factor))
    topv, topi, aux = _route(x2d, router, cfg)
    buf, (e_sorted, slot_row, tok_sorted, w_sorted, keep) = _bucket_by_expert(
        x2d, topv, topi, e, cap)
    out_buf = _experts(cfg, buf, wi[:e], wo[:e])
    gathered = out_buf[e_sorted, torch.clamp(slot_row, max=cap - 1)]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    out = torch.zeros_like(x2d)
    out.index_add_(0, tok_sorted, gathered * w_sorted[:, None].to(gathered.dtype))
    return out, aux


class _OneCopy(torch.autograd.Function):
    """Identity forward on an output of the expert-parallel dispatch that
    every rank of the ep axis holds alike and reads into the same loss; the
    backward passes on 1/P of the cotangent: the share of one copy of that
    loss (``_moe_ep``'s doc)."""

    @staticmethod
    def forward(ctx, x, p: int):
        ctx.p = p
        return x

    @staticmethod
    def backward(ctx, g):
        return g / ctx.p, None


def _moe_ep(x2d, router, wi, wo, cfg: ArchConfig, ctx):
    """Expert-parallel dispatch over ``ctx.ep_axis``.

    Each axis of ``ctx.ep_axis`` is either a dp axis of ``ctx``, whose ranks
    hold their own shards of the batch, or one the activations are
    replicated over (a tensor-parallel axis, say); the production mesh's
    joint ('data', 'model') axis is both.  Over the replicated axes R every
    rank holds the same ``x2d``: the tokens are padded to a multiple of R's
    size and the rank at R-index r routes the r-th share, and the shares'
    outputs are all-gathered over R.  Over the dp axes each rank routes its
    own tokens, as the reference's ``shard_map`` does with the tokens
    sharded over the axis.  Either way a rank's per-expert buckets [E_pad,
    cap, d] go to the experts' owners over the whole ep axis ([E_pad / p, p
    cap, d] each), which run their experts (the live ones: padding experts
    get no token) and send the outputs back.  ``wi`` / ``wo`` hold every
    padded expert or only this rank's E_pad / p.  The aux loss is the mean
    of the ranks' (as the reference's ``pmean``).

    Gradients.  The collectives' rules (``core.backends.direct``) give the
    gradient of the sum of the ep ranks' losses.  Over the dp axes that is
    the dp convention of ``api.loss_fn`` (each rank's gradient is dp times
    its share, and ``train_step`` averages over the dp axes), so nothing is
    added there; an expert slice's owner then holds the dp-fold gradient of
    its experts, which ``train_step`` divides by the size of the ep axes
    that are dp axes (``train_step._reduce``).  Over R every rank computes
    the same loss, and the sum counts it |R| times: the gather's backward
    sums |R| equal cotangents, and the pmean's passes each rank the aux
    loss's whole cotangent.  So each output (the combined tokens before the
    gather, the aux loss after the pmean) passes 1/|R| of its cotangent back
    (``_OneCopy``): then each rank holds its share's exact gradient (its
    ``x2d`` rows, its routing's part of the router's, 1/|R| of each aux
    term's) and its experts' whole one (their owner received every rank's
    rows).  The inputs every rank of R holds alike (``x2d``, the router, a
    rank's every expert) then sum R's gradients (``layers.copy_to_group``),
    in float32 for the router (its bfloat16 storage rounds the sum once, as
    the local dispatch's does) and exactly for every expert (each is nonzero
    on its owner only); an expert slice keeps its own.  Every rank then
    holds the whole gradient of its inputs, as the model's other replicated
    layers do, and a slice its experts' whole gradient."""
    axes = tuple(ctx.ep_axis) if isinstance(ctx.ep_axis, (tuple, list)) else (ctx.ep_axis,)
    mesh = ctx.mesh
    rep = tuple(a for a in axes if a not in ctx.dp_axes)
    p, rank = direct.axis_size(axes, mesh), direct.axis_index(axes, mesh)
    pr = direct.axis_size(rep, mesh) if rep else 1
    e_pad, k = cfg.num_experts_padded, cfg.experts_per_token
    e_loc = e_pad // p
    every = wi.shape[0] == e_pad
    if pr > 1:
        x2d, router = (L.copy_to_group(t, rep, mesh) for t in (x2d, router.float()))
        if every:
            wi, wo = (L.copy_to_group(w, rep, mesh) for w in (wi, wo))
    if every and e_loc != e_pad:
        wi, wo = wi[rank * e_loc:(rank + 1) * e_loc], wo[rank * e_loc:(rank + 1) * e_loc]
    n_in = x2d.shape[0]
    if not rep:
        x_local = x2d
    else:
        pad = (-n_in) % pr
        if pad:  # decode-scale batches: pad tokens to divide the replicated axes
            x2d = torch.cat([x2d, x2d.new_zeros((pad, x2d.shape[1]))])
        n_local = x2d.shape[0] // pr
        r = direct.axis_index(rep, mesh)
        x_local = x2d[r * n_local:(r + 1) * n_local]
    cap = max(int(math.ceil(x_local.shape[0] * k / cfg.num_experts * cfg.capacity_factor)), 8)
    topv, topi, aux = _route(x_local, router, cfg)
    buf, (e_sorted, slot_row, tok_sorted, w_sorted, keep) = _bucket_by_expert(
        x_local, topv, topi, e_pad, cap)
    # shuffle: [E, cap, d] -> [E / p, p cap, d] on the experts' owner
    recv = direct.alltoall(buf, axes, split_dim=0, concat_dim=1, mesh=mesh)
    out_recv = torch.zeros_like(recv)
    live = min(max(cfg.num_experts - rank * e_loc, 0), e_loc)
    if live:
        out_recv[:live] = _experts(cfg, recv[:live], wi[:live], wo[:live])
    # shuffle back: [E / p, p cap, d] -> [E, cap, d]
    out_buf = direct.alltoall(out_recv, axes, split_dim=1, concat_dim=0, mesh=mesh)
    gathered = out_buf[e_sorted, torch.clamp(slot_row, max=cap - 1)]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    out = torch.zeros_like(x_local)
    out.index_add_(0, tok_sorted, gathered * w_sorted[:, None].to(gathered.dtype))
    aux = direct.allreduce_mean(aux, axes, mesh)
    if pr > 1:
        out, aux = _OneCopy.apply(out, pr), _OneCopy.apply(aux, pr)
    if rep:
        out = direct.allgather(out, rep, dim=0, mesh=mesh)[:n_in]
    return out, aux
