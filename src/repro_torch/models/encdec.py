"""Whisper-style encoder-decoder (whisper-medium): the port of
``repro.models.encdec``.

The conv audio frontend is a stub: ``batch["frames"]`` holds precomputed
frame embeddings [B, S_src, d] (post-conv, pre-encoder).  The encoder keeps
sinusoidal positions over its ``source_positions`` frames and attends
without a mask; the decoder uses RoPE, causal cached self-attention, and
cross-attention over K/V computed once from the encoder output at prefill.

Arithmetic follows the reference per leaf.  The encoder computes in
``cfg.dtype`` (bfloat16: ``frames.astype(dt)``) and casts its matrix leaves
to it.  The decoder's embedding scale promotes the bfloat16 table to
float32 (as in ``transformer``), so the decoder computes in float32 and its
own leaves are cast to float32, i.e. read unrounded; the cross K/V come
from the bfloat16 encoder output through ``xk`` / ``xv`` cast to bfloat16,
and the tied output head is the embedding cast to ``cfg.dtype``.  The port
holds each leaf in the type its products read (``hold_leaf``).  Attention
reads the bfloat16 self-attention cache and cross K/V as they are
(``layers.kv_as``), which keeps the kernel on its bf16 designs.

Training (``forward``, through ``api.loss_fn``) takes float32 master weights
(``init_params(..., master=True)``), cast to their products' types inside
the autograd graph (the encoder's and the cross K/V's to bfloat16, whose
transpose rounds their gradients), and runs every encoder and decoder
layer under ``layers.remat``, each decoder layer making its cross K/V
from the encoder states inside its recompute.  Attention's training path
takes bfloat16 q/k/v (the encoder) and bfloat16 k/v (the cross-attention)
as they are (``kernels/flash_attention``).

Sharded execution (``ctx``, a ``transformer.DistContext``): a rank holds
its dp shard of the batch, its activations alike over the tensor-parallel
axis.  With spec trees on ``ctx`` each leaf is gathered at use
(``sharding.use``), but where the rules put the encoder's or the
decoder's product leaves on ``ctx.tp_axis`` (``TP_ROLES``) and its heads
divide over it (``_tp``), their products run on the rank's block, as the
reference's partitioner runs them: ``wq`` / ``wk`` / ``wv`` / ``xq`` /
``xk`` / ``xv`` column-parallel, so that the encoder's attention, the
decoder's self- and cross-attention run on the rank's H / tp heads,
``wo`` / ``xo`` row-parallel, the MLPs ``layers.gated_mlp_parallel``.
The decoder's caches (``self_kv``, ``cross_k``, ``cross_v``) are read and
written as the rank's head blocks, which their specs split over the axis
(``sharding.use_state(..., keep_tp=True)``).  The tied head is used whole
(whisper-medium's 51,865-row vocabulary divides no tp axis, and the
reference's rules keep it so).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import sharding
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

_ENC_MATRIX = ("wq", "wk", "wv", "wo", "wi", "wo_m")
_DEC_CAST = ("xk", "xv")   # decoder leaves read by the bfloat16 encoder output


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The type of the encoder's activations, the narrowest the products
    read: ``cfg.dtype``."""
    return getattr(torch, cfg.dtype)


def hold_leaf(cfg: ArchConfig, path: tuple[str, ...], t: torch.Tensor,
              master: bool = False) -> torch.Tensor:
    """Leaf ``path`` (``t``, in ``cfg.param_dtype``) as the port holds it
    (module doc)."""
    cast = (path == ("embed",) or (path[0] == "encoder" and path[-1] in _ENC_MATRIX)
            or (path[0] == "decoder" and path[-1] in _DEC_CAST))
    return t.to(getattr(torch, cfg.dtype if cast and not master else cfg.param_dtype))


def _sinusoid(n: int, d: int) -> torch.Tensor:
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32))


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device=None, *,
                master: bool = False) -> dict:
    """The reference's tree, each leaf held as ``hold_leaf`` does."""
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    le, ld = cfg.encoder_layers, cfg.num_layers
    dev = torch.device(device) if device is not None else gen.device
    pd = getattr(torch, cfg.param_dtype)

    def lin(path, shape, scale=None):
        w = L.init_linear(gen, shape, scale=scale, device=dev, dtype=pd)
        return hold_leaf(cfg, path, w, master)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    enc = {
        "ln1": zeros(le, d),
        "ln2": zeros(le, d),
        "wq": lin(("encoder", "wq"), (le, d, h * hd)),
        "wk": lin(("encoder", "wk"), (le, d, kv * hd)),
        "wv": lin(("encoder", "wv"), (le, d, kv * hd)),
        "wo": lin(("encoder", "wo"), (le, h * hd, d)),
        "wi": lin(("encoder", "wi"), (le, d, 2 * cfg.d_ff)),
        "wo_m": lin(("encoder", "wo_m"), (le, cfg.d_ff, d)),
    }
    dec = {
        "ln1": zeros(ld, d),
        "ln_x": zeros(ld, d),
        "ln2": zeros(ld, d),
        **{name: lin(("decoder", name), (ld,) + shape) for name, shape in (
            ("wq", (d, h * hd)), ("wk", (d, kv * hd)), ("wv", (d, kv * hd)), ("wo", (h * hd, d)),
            ("xq", (d, h * hd)), ("xk", (d, kv * hd)), ("xv", (d, kv * hd)), ("xo", (h * hd, d)),
            ("wi", (d, 2 * cfg.d_ff)), ("wo_m", (cfg.d_ff, d)))},
    }
    return {
        "embed": lin(("embed",), (cfg.vocab_size, d), d ** -0.5),
        "encoder": enc,
        "decoder": dec,
        "enc_norm": zeros(d),
        "final_norm": zeros(d),
    }


def _layer(tree: dict, i: int) -> dict:
    return {n: w[i] for n, w in tree.items()}


# the tensor-parallel role (``sharding.tp_role``) each product's leaf needs
# for the encoder's and the decoder's layers to run on the rank's heads
TP_ROLES = {
    "encoder": {**{n: "column" for n in ("wq", "wk", "wv", "wi")}, "wo": "row", "wo_m": "row"},
    "decoder": {**{n: "column" for n in ("wq", "wk", "wv", "xq", "xk", "xv", "wi")},
                **{n: "row" for n in ("wo", "xo", "wo_m")}},
}


def _tp(cfg: ArchConfig, ctx, part: str) -> tuple[dict, L.TP]:
    """(the roles, the axis) the layers of ``part`` ("encoder" / "decoder")
    run their products on: ``TP_ROLES[part]`` and ``ctx.tp_axis`` where the
    rules give every such leaf its role and the q and kv heads divide over
    the axis, else none: the layers run on whole leaves."""
    roles = sharding.tp_roles(ctx, TP_ROLES[part], part)
    if not roles:
        return {}, L.TP()
    tp = L.TP(ctx.tp_axis, ctx.mesh)
    if cfg.num_heads % tp.size or cfg.num_kv_heads % tp.size:
        return {}, L.TP()
    return roles, tp


def _mlp(y, wi, wo, tp: L.TP):
    if tp.axis is None:
        return L.gated_mlp(y, wi, wo, "gelu")
    return L.gated_mlp_parallel(y, wi, wo, tp.axis, tp.mesh, "gelu")


def _enc_layer(cfg, x, blk, ctx=None):
    roles, tp = _tp(cfg, ctx, "encoder")
    blk = sharding.use(ctx, blk, "encoder", layer=True, keep_tp=roles)
    dt = x.dtype
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    yc = tp.copy(y)   # one copy for q, k and v: the rank's heads
    q, k, v = ((yc @ blk[n].to(dt)).view(b, s, -1, hd) for n in ("wq", "wk", "wv"))
    att = L.attention(q, k, v, causal=False)
    x = x + tp.sum(att.reshape(b, s, -1) @ blk["wo"].to(dt))
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + _mlp(y2, blk["wi"].to(dt), blk["wo_m"].to(dt), tp)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, ctx=None) -> torch.Tensor:
    """frames: [B, S_src, d] (stub embeddings) -> encoder states in cfg.dtype;
    each layer under ``layers.remat`` (which runs it plainly unless
    autograd records and ``cfg.remat``)."""
    dt = getattr(torch, cfg.dtype)
    b, s, d = frames.shape
    x = frames.to(dt) + _sinusoid(s, d).to(device=frames.device, dtype=dt)[None]
    for i in range(cfg.encoder_layers):
        x = L.remat(cfg, lambda x, blk: _enc_layer(cfg, x, blk, ctx), x,
                    _layer(params["encoder"], i))
    return L.rms_norm(x, sharding.use(ctx, params["enc_norm"], "enc_norm"), cfg.norm_eps)


def _dec_block(cfg, x, blk, pos, enc_kv, self_cache=None, kv_len: int = 0, ctx=None,
               tp: L.TP = L.TP()):
    """One decoder layer (``blk`` gathered: ``_dec_weights``); with
    ``self_cache`` ([2, B, S, KV, hd]) the layer's k/v are written into it
    in place.  ``enc_kv``: the cross K/V, or a function of the weights that
    makes them.  On ``tp``'s axis every attention runs on the rank's heads,
    and the caches hold them (the specs put their heads on the axis)."""
    if callable(enc_kv):
        enc_kv = enc_kv(blk)
    dt = x.dtype
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    # self attention (causal, cached on decode)
    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    yc = tp.copy(y)
    q = L.rope((yc @ blk["wq"].to(dt)).view(b, t, -1, hd), pos, cfg.rope_theta)
    k = L.rope((yc @ blk["wk"].to(dt)).view(b, t, -1, hd), pos, cfg.rope_theta)
    v = (yc @ blk["wv"].to(dt)).view(b, t, -1, hd)
    q_off, att_kv_len = 0, None
    if self_cache is not None:
        start = kv_len if t == 1 else 0
        if start + t > self_cache.shape[2]:
            raise ValueError(f"KV cache of {self_cache.shape[2]} positions is full")
        keep = tp.axis is not None
        local, self_cache = self_cache, sharding.use_state(ctx, self_cache, "self_kv",
                                                              batch_dim=1, layer=True,
                                                              keep_tp=keep)
        _check_heads(self_cache, k)
        self_cache[0, :, start:start + t] = k
        self_cache[1, :, start:start + t] = v
        if self_cache is not local:  # write the rank's block of the new positions back
            local[:, :, start:start + t] = sharding.own_state(
                ctx, self_cache[:, :, start:start + t], local, "self_kv", batch_dim=1,
                layer=True, keep_tp=keep)
        k, v = L.kv_as(self_cache[0], dt), L.kv_as(self_cache[1], dt)
        q_off, att_kv_len = start, kv_len + t
    att = L.attention(q, k, v, causal=True, q_offset=q_off, kv_len=att_kv_len)
    x = x + tp.sum(att.reshape(b, t, -1) @ blk["wo"].to(dt))
    # cross attention to the encoder states (precomputed K/V)
    y = L.rms_norm(x, blk["ln_x"], cfg.norm_eps)
    xq = (tp.copy(y) @ blk["xq"].to(dt)).view(b, t, -1, hd)
    xk, xv = enc_kv
    att = L.attention(xq, L.kv_as(xk, dt), L.kv_as(xv, dt), causal=False)
    x = x + tp.sum(att.reshape(b, t, -1) @ blk["xo"].to(dt))
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + _mlp(y2, blk["wi"].to(dt), blk["wo_m"].to(dt), tp)


def _check_heads(cache: torch.Tensor, k: torch.Tensor) -> None:
    """A cache as a layer reads it must hold the heads its products make
    (with the products split over tp, the state specs must split the
    cache's heads over it too, as ``sharding.cache_specs`` does)."""
    if cache.shape[-2] != k.shape[2]:
        raise ValueError(f"a cache of {cache.shape[-2]} heads for k/v of {k.shape[2]}: "
                         "tensor-parallel products need the cache's heads on the tp axis")


def _cross_kv(cfg, blk, enc_out, tp: L.TP = L.TP()):
    """Layer ``blk``'s cross K/V from the encoder states: [B, S_src, KV, hd] x2
    (the rank's KV / tp heads on ``tp``'s axis)."""
    dt = enc_out.dtype
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    ec = tp.copy(enc_out)
    k = (ec @ blk["xk"].to(dt)).view(b, s, -1, hd)
    v = (ec @ blk["xv"].to(dt)).view(b, s, -1, hd)
    return k, v


def _dec_weights(cfg, ctx, blk) -> tuple[dict, L.TP]:
    """A decoder layer's weights gathered at use, but the blocks its
    tensor-parallel products take, and their axis (``_tp``)."""
    roles, tp = _tp(cfg, ctx, "decoder")
    return sharding.use(ctx, blk, "decoder", layer=True, keep_tp=roles), tp


def _embed(cfg, params, tokens, ctx=None):
    table = sharding.use(ctx, params["embed"], "embed").to(getattr(torch, cfg.dtype))
    return L.embed(tokens, table, scale=True)


def _logits(cfg, params, x, ctx=None):
    """The tied output head: the embedding cast to cfg.dtype."""
    x = L.rms_norm(x, sharding.use(ctx, params["final_norm"], "final_norm"), cfg.norm_eps)
    return L.mm(x, sharding.use(ctx, params["embed"], "embed").to(getattr(torch, cfg.dtype)).T)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, frames: torch.Tensor, *,
            ctx=None):
    """Teacher-forced forward: (logits over the decoder positions, aux 0);
    the training forward too, each layer under ``layers.remat`` (module
    doc)."""
    L.check_products(tokens.device, compute_dtype(cfg))
    enc_out = encode(cfg, params, frames, ctx)
    t = tokens.shape[1]
    x = _embed(cfg, params, tokens, ctx)
    pos = torch.arange(t, device=x.device)

    def layer(x, blk, enc):
        blk, tp = _dec_weights(cfg, ctx, blk)
        return _dec_block(cfg, x, blk, pos, lambda w: _cross_kv(cfg, w, enc, tp), ctx=ctx, tp=tp)

    for i in range(cfg.num_layers):
        x = L.remat(cfg, layer, x, _layer(params["decoder"], i), enc_out)
    return _logits(cfg, params, x, ctx), torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """{"self_kv": [L, 2, B, S, KV, hd], "cross_k" / "cross_v": [L, B,
    S_src, KV, hd], "len": host int}."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    s_src = cfg.source_positions
    return {
        "self_kv": torch.zeros((cfg.num_layers, 2, batch, max_len, kv, hd), dtype=dtype,
                               device=device),
        "cross_k": torch.zeros((cfg.num_layers, batch, s_src, kv, hd), dtype=dtype, device=device),
        "cross_v": torch.zeros((cfg.num_layers, batch, s_src, kv, hd), dtype=dtype, device=device),
        "len": 0,
    }


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor, frames: torch.Tensor,
            cache: dict, *, ctx=None):
    """Encode the source, store the cross K/V, run the prompt into the
    cache (in place); returns last-position logits and the cache."""
    L.check_products(tokens.device, compute_dtype(cfg))
    enc_out = encode(cfg, params, frames, ctx)
    t = tokens.shape[1]
    x = _embed(cfg, params, tokens, ctx)
    pos = torch.arange(t, device=x.device)
    for i in range(cfg.num_layers):
        blk, tp = _dec_weights(cfg, ctx, _layer(params["decoder"], i))
        xk, xv = _cross_kv(cfg, blk, enc_out, tp)
        for n, t_ in (("cross_k", xk), ("cross_v", xv)):
            cache[n][i] = sharding.own_state(ctx, t_, cache[n][i], n, batch_dim=0, layer=True,
                                             keep_tp=tp.axis is not None)
        x = _dec_block(cfg, x, blk, pos, (xk, xv), self_cache=cache["self_kv"][i], kv_len=0,
                       ctx=ctx, tp=tp)
    return _logits(cfg, params, x[:, -1:], ctx), {**cache, "len": t}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict, *, ctx=None):
    """One token: the self-attention cache is updated in place."""
    L.check_products(tokens.device, compute_dtype(cfg))
    kv_len = int(cache["len"])
    x = _embed(cfg, params, tokens, ctx)
    pos = torch.arange(kv_len, kv_len + 1, device=x.device)
    for i in range(cfg.num_layers):
        blk, tp = _dec_weights(cfg, ctx, _layer(params["decoder"], i))
        cross = tuple(sharding.use_state(ctx, cache[n][i], n, batch_dim=0, layer=True,
                                         keep_tp=tp.axis is not None)
                      for n in ("cross_k", "cross_v"))
        x = _dec_block(cfg, x, blk, pos, cross, self_cache=cache["self_kv"][i], kv_len=kv_len,
                       ctx=ctx, tp=tp)
    return _logits(cfg, params, x, ctx), {**cache, "len": kv_len + 1}
