"""Dense decoder-only transformer — gemma3 / minicpm / starcoder2 /
h2o-danube / the internvl2 text backbone: the port of
``repro.models.transformer``.

Parameters keep the reference's stacked ``[L, ...]`` layout; the
reference's ``lax.scan`` over layers is a Python loop over ``[L, ...]``
views, and the per-layer window (gemma3's 5:1 local:global) a host int.
The VLM frontend stub injects precomputed patch embeddings over the first
``frontend_tokens`` positions.

Arithmetic follows the reference's dtype flow exactly.  Its ``embed``
scales by a numpy scalar, which promotes the ``cfg.dtype`` (bfloat16) table
to float32, so the residual stream is float32 from the first layer, and
``y @ w.astype(bfloat16)`` is a float32 product with bfloat16-rounded
weights.  The port therefore holds every matrix weight (and the embedding)
as the float32 value of its ``cfg.dtype`` rounding (``init_params``,
``interop.params_from_numpy``), so that a float32 ``torch.matmul`` computes
the reference's product.  TF32 would be a different result:
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default)
and the functions here refuse to run with it on.  The KV cache is stored in
its own dtype (bfloat16 by default) and read back as ``cfg.dtype``, so on
the cached path attention gets float32 q and bfloat16 k/v.

Training is the exception.  The reference keeps unrounded float32 master
weights and casts them inside its graph (``w.astype(bfloat16)``), and the
transpose of that cast rounds every weight gradient to bfloat16.
``forward_train`` does the same: it takes float32 master weights
(``init_params(..., master=True)``, ``interop.params_from_numpy(...,
master=True)``) and casts each matrix weight to ``cfg.dtype`` and back inside
the autograd graph (``w.to(bfloat16).float()``, whose gradient is rounded to
bfloat16 as the reference's is); the embedding rows are gathered from the
bfloat16 table, as the reference's ``take`` is.  With ``cfg.remat`` each
layer runs under ``torch.utils.checkpoint`` (its activations are recomputed
in the backward; the reference's ``jax.checkpoint`` saves its products,
which changes memory, not the result).  Serving keeps the pre-rounded
weights and pays no per-step cast.

Four entry points sharing weights:
- ``forward``       : full-sequence logits (pre-rounded weights)
- ``forward_train`` : full-sequence logits from master weights, differentiable
- ``prefill``       : forward + KV cache construction
- ``decode_step``   : one token with cache
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

# leaves used as matrix weights: held rounded to cfg.dtype (as float32) for
# serving, cast to it inside the graph by forward_train
MATRIX_LEAVES = ("wq", "wk", "wv", "wo_att", "wi", "wo", "embed", "lm_head")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check(cfg: ArchConfig, ctx, device: torch.device) -> None:
    if ctx is not None:
        raise NotImplementedError("DistContext (sharded execution) is not ported (ROADMAP A 5)")
    if cfg.family == "moe":
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP A 7)")
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: the reference's "
                           "float32 products would be computed in TF32")


def round_to_compute(cfg: ArchConfig, t: torch.Tensor) -> torch.Tensor:
    """The float32 value of ``t`` rounded to ``cfg.dtype``."""
    cd = _dtype(cfg.dtype)
    return t if cd == torch.float32 else t.to(cd).float()


def _layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer SWA window (0 = full attention), host ints."""
    win = []
    for kind in cfg.layer_kinds():
        if kind == "local":
            win.append(cfg.sliding_window or 1024)
        elif kind == "global":
            win.append(cfg.global_window)
        elif kind == "attn":
            win.append(cfg.sliding_window)
        else:
            raise ValueError(f"dense transformer got layer kind {kind!r}")
    return win


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device=None, *,
                master: bool = False) -> dict:
    """Stacked-parameter tree, float32: matrix weights rounded to cfg.dtype
    for serving, or kept unrounded (``master``) for ``forward_train``.

    Draws from ``gen`` in the reference's leaf order; ``jax.random`` streams
    cannot be reproduced, so parity tests load the reference's parameters
    through ``interop.params_from_numpy`` instead."""
    if cfg.family == "moe":
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP A 7)")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, lcount = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    dev = torch.device(device) if device is not None else gen.device

    def stack(shape):
        return L.init_linear(gen, (lcount,) + shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    block = {
        "ln1": zeros(lcount, d),
        "ln2": zeros(lcount, d),
        "wq": stack((d, h * hd)),
        "wk": stack((d, kv * hd)),
        "wv": stack((d, kv * hd)),
        "wo_att": stack((h * hd, d)),
    }
    if cfg.qk_norm:
        block["qnorm"] = zeros(lcount, hd)
        block["knorm"] = zeros(lcount, hd)
    block["wi"] = stack((d, 2 * cfg.d_ff))
    block["wo"] = stack((cfg.d_ff, d))
    params = {
        "embed": L.init_linear(gen, (cfg.vocab_size, d), scale=d ** -0.5, device=dev),
        "blocks": block,
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, (d, cfg.vocab_size), device=dev)
    if dev.type != "meta" and not master:
        round_matrix_leaves(cfg, params)
    return params


def round_matrix_leaves(cfg: ArchConfig, params: dict) -> None:
    """Round every matrix weight of ``params`` to cfg.dtype, in place."""
    if _dtype(cfg.dtype) == torch.float32:
        return
    for name in MATRIX_LEAVES:
        if name in params:
            params[name].copy_(round_to_compute(cfg, params[name]))
        if name in params["blocks"]:
            for w in params["blocks"][name]:  # a layer at a time: bounded scratch
                w.copy_(round_to_compute(cfg, w))


def _block_fn(cfg: ArchConfig, x, blk, window: int, pos, cache_l=None, kv_len: int = 0,
              master: bool = False):
    """One transformer layer. cache_l: [2, B, S, KV, hd] or None; with a
    cache, the layer's k/v are written into it in place.  ``master``: the
    matrix weights are float32 master weights, cast to cfg.dtype here."""
    b, t, _ = x.shape
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    if master:
        blk = {n: round_to_compute(cfg, w) if n in MATRIX_LEAVES else w for n, w in blk.items()}

    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    q = (y @ blk["wq"]).view(b, t, h, hd)
    k = (y @ blk["wk"]).view(b, t, kv, hd)
    v = (y @ blk["wv"]).view(b, t, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, blk["qnorm"], cfg.norm_eps)
        k = L.rms_norm(k, blk["knorm"], cfg.norm_eps)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)

    if cache_l is not None:
        start = kv_len if t == 1 else 0
        if start + t > cache_l.shape[2]:
            raise ValueError(f"KV cache of {cache_l.shape[2]} positions is full")
        cache_l[0, :, start:start + t] = k
        cache_l[1, :, start:start + t] = v
        cd = _dtype(cfg.dtype)
        k_att, v_att = cache_l[0], cache_l[1]
        if k_att.dtype != cd:
            k_att, v_att = k_att.to(cd), v_att.to(cd)
        att_kv_len, q_off = kv_len + t, start
    else:
        k_att, v_att, att_kv_len, q_off = k, v, None, 0

    att = L.attention(q, k_att, v_att, causal=True, window=window, softcap=cfg.attn_softcap,
                      q_offset=q_off, kv_len=att_kv_len)
    x = x + att.reshape(b, t, h * hd) @ blk["wo_att"]
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + L.gated_mlp(y2, blk["wi"], blk["wo"], cfg.act)


def _layer(params: dict, i: int) -> dict:
    """Layer i's weights: views of the stacked [L, ...] leaves, or entry i of
    a list of per-layer dicts (the train step's per-layer gradient leaves)."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        return blocks[i]
    return {name: w[i] for name, w in blocks.items()}


def _embed_input(cfg: ArchConfig, table, tokens, prefix_embeds) -> torch.Tensor:
    x = L.embed(tokens, table, scale=True)
    if prefix_embeds is not None:
        x[:, : prefix_embeds.shape[1]] = round_to_compute(cfg, prefix_embeds.float())
    return x


def _logits(cfg: ArchConfig, params: dict, x, master: bool = False) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    head = params["embed"].T if head is None else head
    return x @ (round_to_compute(cfg, head) if master else head)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None, ctx=None):
    """Full-sequence logits [B, T, V] float32 (+ the MoE aux loss scalar, 0)."""
    _check(cfg, ctx, tokens.device)
    x = _embed_input(cfg, params["embed"], tokens, prefix_embeds)
    pos = torch.arange(x.shape[1], device=x.device)
    for i, window in enumerate(_layer_windows(cfg)):
        x = _block_fn(cfg, x, _layer(params, i), window, pos)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def forward_train(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                  prefix_embeds: torch.Tensor | None = None, ctx=None):
    """Full-sequence logits [B, T, V] float32 (+ the aux loss, 0) from float32
    master weights, with the reference's in-graph casts (module doc).
    ``params["blocks"]`` is the stacked dict or a list of per-layer dicts."""
    _check(cfg, ctx, tokens.device)
    x = _embed_input(cfg, params["embed"].to(_dtype(cfg.dtype)), tokens, prefix_embeds)
    pos = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, window in enumerate(_layer_windows(cfg)):
        blk = _layer(params, i)
        names = tuple(blk)

        def layer(x, *ws, window=window, names=names):
            return _block_fn(cfg, x, dict(zip(names, ws)), window, pos, master=True)

        if remat:
            x = checkpoint(layer, x, *blk.values(), use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(x, *blk.values())
    return (_logits(cfg, params, x, master=True),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """KV cache [L, 2, B, S, KV, hd] + its length as a host int (no layer
    reads it back from the device).  ``prefill`` and ``decode_step`` write
    into ``kv`` in place."""
    return {
        "kv": torch.zeros((cfg.num_layers, 2, batch, max_len, cfg.num_kv_heads,
                           cfg.resolved_head_dim), dtype=dtype, device=device),
        "len": 0,
    }


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict, *,
            prefix_embeds: torch.Tensor | None = None, ctx=None):
    """Run the prompt, filling the cache in place; returns last-position logits."""
    _check(cfg, ctx, tokens.device)
    x = _embed_input(cfg, params["embed"], tokens, prefix_embeds)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    kv = cache["kv"]
    for i, window in enumerate(_layer_windows(cfg)):
        x = _block_fn(cfg, x, _layer(params, i), window, pos, cache_l=kv[i], kv_len=0)
    return _logits(cfg, params, x[:, -1:]), {"kv": kv, "len": t}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict, *, ctx=None):
    """One decode step: tokens [B, 1] -> logits [B, 1, V]; the cache is
    updated in place and returned with its length + 1."""
    _check(cfg, ctx, tokens.device)
    x = L.embed(tokens, params["embed"], scale=True)
    kv_len = int(cache["len"])
    pos = torch.arange(kv_len, kv_len + 1, device=x.device)
    kv = cache["kv"]
    for i, window in enumerate(_layer_windows(cfg)):
        x = _block_fn(cfg, x, _layer(params, i), window, pos, cache_l=kv[i], kv_len=kv_len)
    return _logits(cfg, params, x), {"kv": kv, "len": kv_len + 1}
