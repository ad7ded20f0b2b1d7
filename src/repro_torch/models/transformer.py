"""Decoder-only transformer — gemma3 / minicpm / starcoder2 / h2o-danube /
the internvl2 text backbone, and the MoE models (qwen3-moe, kimi-k2), whose
layers run ``moe.moe_block`` (plus kimi-k2's shared expert) in place of the
dense MLP: the port of ``repro.models.transformer``.

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
``interop.params_from_numpy``, ``hold_leaf``), so that a float32
``torch.matmul`` computes the reference's product.  TF32 would be a
different result: ``torch.backends.cuda.matmul.allow_tf32`` stays False
(PyTorch's default) and the functions here refuse to run with it on
(``layers.check_products``).  The KV cache is stored in
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
in the backward; ``layers.remat``).  Serving keeps the pre-rounded
weights and pays no per-step cast.

bfloat16 weight storage (``cfg.param_dtype == "bfloat16"``: qwen3-moe,
kimi-k2) holds every leaf in bfloat16, as the reference's
``astype(param_dtype)`` does; the products read each matrix leaf as its
float32 value (``w.float()``, the reference's ``astype(cfg.dtype)`` of a
bfloat16 leaf), one layer at a time.

Sharded execution (``ctx``, a :class:`DistContext`): every rank runs the
same program on its own shard, the dp shard of the batch, its activations
alike over the tensor-parallel axis.  Attention runs as
``layers.attention_sharded`` (islands over ``ctx.tp_axis``) and the MoE
layers as ``moe._moe_ep`` (an all-to-all over ``ctx.ep_axis``);
``api.loss_fn`` averages over the dp axes.  With spec trees on ``ctx``
(``param_specs``), the products of the leaves the rules put on the tp
axis run on the rank's block, as the reference's partitioner runs them
(``sharding.tp_role``): ``wq`` / ``wk`` / ``wv`` / ``wi`` / ``wi_sh``
column-parallel, ``wo_att`` / ``wo`` / ``wo_sh`` row-parallel, ``embed`` /
``lm_head`` vocab-parallel.  The q heads stay local where the "head" plan
takes whole heads (and k / v where their heads split evenly too); every
other step that needs whole heads (qk-norm and rope on split heads, the
"seq" plan, decode) all-gathers the columns, and the attention output
reaches ``wo_att`` as its row block (``attention_sharded(out_local=)``).
A decode step then attends on the rank's own ceil(H / tp) q heads and the
kv heads they read (``_decode_heads``), as the reference's partitioner
splits its attention by ``wq``'s heads; a cache whose kv heads the rules
put on the tp axis stays the rank's block.  The gated MLP exchanges its
gate and up halves once (``layers.gated_mlp_parallel``); the training
logits stay vocab-split (``sharding.vocab_split``), serving's are
all-gathered.  Leaves the rules keep whole (an odd vocabulary, the router,
a width tp does not divide) are used whole.

Four entry points sharing weights:
- ``forward``       : full-sequence logits (pre-rounded weights)
- ``forward_train`` : full-sequence logits from master weights, differentiable
- ``prefill``       : forward + KV cache construction
- ``decode_step``   : one token with cache
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.backends import direct
from repro_torch.dist import sharding
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import init_moe_block, moe_block

# leaves used as matrix weights: held rounded to cfg.dtype (as float32) for
# serving, cast to it inside the graph by forward_train (the MoE experts,
# under "moe", are cast by moe_block as it reads them)
MATRIX_LEAVES = ("wq", "wk", "wv", "wo_att", "wi", "wo", "wi_sh", "wo_sh", "embed", "lm_head")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The type of the activations the products read: float32 (module doc)."""
    return torch.float32


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Distribution context: the device mesh (a
    ``torch.distributed.device_mesh.DeviceMesh``) and the names of its
    expert-parallel, data-parallel and tensor-parallel axes.  ctx=None runs
    everything on one device."""

    mesh: Any = None
    ep_axis: str | tuple[str, ...] | None = None  # expert-parallel mesh axis ("model")
    dp_axes: tuple[str, ...] = ()
    tp_axis: str | None = None
    # the rank's PartitionSpec trees (``dist.sharding``): with them the rank
    # holds its parameters, optimizer state and decode state as their
    # ``local_shard`` and gathers each leaf at use (``sharding.use``)
    param_specs: Any = None
    opt_specs: Any = None
    state_specs: Any = None

    def shard(self, x, *spec):
        """The reference's sharding constraint, a no-op here: a rank already
        holds only its shard (the SPMD program is written per rank)."""
        return x


def _check(cfg: ArchConfig, device: torch.device) -> None:
    L.check_products(device, compute_dtype(cfg))


def _held_rounded(cfg: ArchConfig, path: tuple[str, ...], master: bool) -> bool:
    """Whether leaf ``path`` is held at its cfg.dtype rounding: a float32
    matrix weight outside the MoE experts, for serving."""
    return (not master and path[-1] in MATRIX_LEAVES and path[:-1] in ((), ("blocks",))
            and _dtype(cfg.param_dtype) == torch.float32
            and _dtype(cfg.dtype) != torch.float32)


def hold_leaf(cfg: ArchConfig, path: tuple[str, ...], t: torch.Tensor,
              master: bool = False) -> torch.Tensor:
    """Leaf ``path`` (``t``, in ``cfg.param_dtype``) as the port holds it."""
    return round_to_compute(cfg, t) if _held_rounded(cfg, path, master) else t


def round_to_compute(cfg: ArchConfig, t: torch.Tensor) -> torch.Tensor:
    """The float32 value of ``t`` rounded to ``cfg.dtype``."""
    return t.to(_dtype(cfg.dtype)).float()


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
    """Stacked-parameter tree in ``cfg.param_dtype``.  float32 storage:
    matrix weights rounded to cfg.dtype for serving, or kept unrounded
    (``master``) for ``forward_train``; bfloat16 storage: every leaf in
    bfloat16, as the reference's ``astype``.

    Draws from ``gen`` in the reference's leaf order; ``jax.random`` streams
    cannot be reproduced, so parity tests load the reference's parameters
    through ``interop.params_from_numpy`` instead."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, lcount = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    dev = torch.device(device) if device is not None else gen.device
    pd = _dtype(cfg.param_dtype)

    def stack(shape):
        return L.init_linear(gen, (lcount,) + shape, device=dev, dtype=pd)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev)

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
    if cfg.family == "moe":
        block["moe"] = init_moe_block(cfg, gen, lcount, dev, dtype=pd)
        if cfg.n_shared_experts:
            block["wi_sh"] = stack((d, 2 * cfg.moe_d_ff * cfg.n_shared_experts))
            block["wo_sh"] = stack((cfg.moe_d_ff * cfg.n_shared_experts, d))
    else:
        block["wi"] = stack((d, 2 * cfg.d_ff))
        block["wo"] = stack((cfg.d_ff, d))
    params = {
        "embed": L.init_linear(gen, (cfg.vocab_size, d), scale=d ** -0.5, device=dev, dtype=pd),
        "blocks": block,
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, (d, cfg.vocab_size), device=dev, dtype=pd)
    if dev.type != "meta" and not master:
        round_matrix_leaves(cfg, params)
    return params


def round_matrix_leaves(cfg: ArchConfig, params: dict) -> None:
    """Hold every leaf of ``params`` as ``hold_leaf`` does, in place."""
    for name in MATRIX_LEAVES:
        if name in params and _held_rounded(cfg, (name,), False):
            params[name].copy_(round_to_compute(cfg, params[name]))
        if name in params["blocks"] and _held_rounded(cfg, ("blocks", name), False):
            for w in params["blocks"][name]:  # a layer at a time: bounded scratch
                w.copy_(round_to_compute(cfg, w))


# the leaves whose products run on the rank's block where the rules split
# them over ctx.tp_axis (``sharding.tp_role``): column-parallel q / k / v and
# MLP inputs, row-parallel output projections
TP_LEAVES = ("wq", "wk", "wv", "wo_att", "wi", "wo", "wi_sh", "wo_sh")


def _roles(ctx: DistContext | None, blk: dict) -> dict:
    """Name -> tensor-parallel role (``sharding.tp_role``) of each leaf of
    ``TP_LEAVES`` in the layer ``blk`` that the rules split over tp; empty
    without specs or tp axis."""
    return {n: role for n in TP_LEAVES
            if n in blk and (role := sharding.tp_role(ctx, "blocks", n)) is not None}


def _heads(x, hd: int, role: str | None, ctx, whole: bool) -> torch.Tensor:
    """A q / k / v product's output [B, T, n hd] as [B, T, n, hd]: its
    rank's columns (``role`` "column") all-gathered over tp first where
    ``whole`` (the next step needs every head)."""
    if role == "column" and whole:
        x = direct.allgather_alike(x.contiguous(), ctx.tp_axis, dim=-1, mesh=ctx.mesh)
    return x.reshape(x.shape[0], x.shape[1], -1, hd)


def _mlp(y, wi, wo, act: str, wi_role: str | None, wo_role: str | None, ctx):
    """The gated MLP on ``wi`` / ``wo`` as the rank holds them: both split
    (``layers.gated_mlp_parallel``); ``wi``'s columns only, where tp does
    not divide ff and the rules keep ``wo`` whole: the rank's ``gate || up``
    columns all-gathered (tp times the exchange's bytes); neither: whole.
    The rules split ``wi``'s columns wherever they split ``wo``'s rows."""
    if wi_role != "column":
        return L.gated_mlp(y, wi, wo, act)
    tp, mesh = ctx.tp_axis, ctx.mesh
    if wo_role == "row":
        return L.gated_mlp_parallel(y, wi, wo, tp, mesh, act)
    return L.gated_down(direct.allgather_alike(L.column_parallel(y, wi, tp, mesh), tp, dim=-1,
                                               mesh=mesh), wo, act)


def _decode_heads(q, k, v, kv_local: bool, tp, mesh, **kw) -> torch.Tensor:
    """A decode step's attention on the tp rank's own q heads: its
    ``layers.head_block`` of ``q`` [B, 1, H, hd] (every rank holds q whole),
    over the kv heads they map to (``layers.attention_island``; ``k`` / ``v``
    every kv head, or with ``kv_local`` the rank's block of them).  Returns
    the rank's row block [B, 1, H hd / tp] of the flattened heads' output,
    what a row-parallel ``wo_att`` takes: the island's output as it is where
    tp divides H, else the ranks' (padded to ceil(H / tp) heads)
    all-gathered, trimmed to H heads and cut to the block."""
    h, hd = q.shape[2], q.shape[3]
    tps, r = direct.axis_size(tp, mesh), direct.axis_index(tp, mesh)
    h0, h1 = L.head_block(h, tps, r)
    out = L.attention_island(q[:, :, h0:h1], k, v, r, tps, plan="head", h=h, kv_local=kv_local,
                             **kw).flatten(2)
    if h % tps == 0:
        return out
    whole = direct.allgather_alike(out.contiguous(), tp, dim=-1, mesh=mesh)[..., :h * hd]
    return L.split_to_group(whole, tp, mesh)


def _block_fn(cfg: ArchConfig, x, blk, window: int, pos, cache_l=None, kv_len: int = 0,
              master: bool = False, ctx: DistContext | None = None):
    """One transformer layer -> (x, the MoE aux loss or None). cache_l:
    [2, B, S, KV, hd] or None; with a cache, the layer's k/v are written
    into it in place.  ``master``: the matrix weights are float32 master
    weights, cast to cfg.dtype here; else each is read as its float32 value
    (a no-op for float32 storage).  With spec trees on ``ctx``, ``blk`` and
    ``cache_l`` are the rank's blocks, gathered here (``sharding.use``),
    but the leaves the rules split over ``ctx.tp_axis``, whose products run
    on the rank's block (module doc)."""
    b, t, _ = x.shape
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    read = (lambda w: round_to_compute(cfg, w)) if master else (lambda w: w.float())
    roles = _roles(ctx, blk)
    blk = sharding.use(ctx, blk, "blocks", layer=True, keep_tp=roles)
    blk = {n: read(w) if n in MATRIX_LEAVES else w for n, w in blk.items()}
    tp, mesh = (ctx.tp_axis, ctx.mesh) if roles else (None, None)
    tps = direct.axis_size(tp, mesh) if roles else 1

    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    # column-parallel q / k / v: one copy of y for the products on blocks
    yc = L.copy_to_group(y, tp, mesh) if roles.keys() & {"wq", "wk", "wv"} else y
    q, k, v = ((yc if n in roles else y) @ blk[n] for n in ("wq", "wk", "wv"))
    # the "head" plan on whole heads takes the rank's q heads as they are, and
    # its k / v heads where those split evenly too (and no cache is written);
    # every other step gathers whole heads (qk-norm and rope act on a head)
    plan = L.shard_plan(h, kv, t, tps) if tps > 1 and t > 1 else None
    q_local = plan == "head" and roles.get("wq") == "column"
    kv_local = q_local and roles.get("wk") == "column" and kv % tps == 0 and cache_l is None
    q = _heads(q, hd, roles.get("wq"), ctx, not q_local)
    k, v = (_heads(a, hd, roles.get("wk"), ctx, not kv_local) for a in (k, v))
    if cfg.qk_norm:
        qn, kn = blk["qnorm"], blk["knorm"]
        if q_local:  # a replicated scale on the rank's heads: its gradient sums the ranks'
            qn = L.copy_to_group(qn, tp, mesh)
        if kv_local:
            kn = L.copy_to_group(kn, tp, mesh)
        q = L.rms_norm(q, qn, cfg.norm_eps)
        k = L.rms_norm(k, kn, cfg.norm_eps)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)

    rows = roles.get("wo_att") == "row"
    # a decode step attends on the rank's own q heads (``_decode_heads``) and
    # keeps a cache whose kv heads the specs split over tp as its block
    own_heads = rows and t == 1
    if cache_l is not None:
        start = kv_len if t == 1 else 0
        if start + t > cache_l.shape[2]:
            raise ValueError(f"KV cache of {cache_l.shape[2]} positions is full")
        local, cache_l = cache_l, sharding.use_state(ctx, cache_l, "kv", batch_dim=1,
                                                      layer=True, keep_tp=own_heads)
        if cache_l.shape[-2] != kv:  # the rank's block of the kv heads
            kv_local = True
            kv0 = direct.axis_index(tp, mesh) * cache_l.shape[-2]
            k, v = (a[:, :, kv0:kv0 + cache_l.shape[-2]] for a in (k, v))
        cache_l[0, :, start:start + t] = k
        cache_l[1, :, start:start + t] = v
        if cache_l is not local:  # write the rank's block of the new positions back
            local[:, :, start:start + t] = sharding.own_state(
                ctx, cache_l[:, :, start:start + t], local, "kv", batch_dim=1, layer=True,
                keep_tp=own_heads)
        cd = _dtype(cfg.dtype)
        k_att, v_att = cache_l[0], cache_l[1]
        if k_att.dtype != cd:
            k_att, v_att = k_att.to(cd), v_att.to(cd)
        att_kv_len, q_off = kv_len + t, start
    else:
        k_att, v_att, att_kv_len, q_off = k, v, None, 0

    att_kw = dict(causal=True, window=window, softcap=cfg.attn_softcap, q_offset=q_off,
                  kv_len=att_kv_len)
    if own_heads:
        att = _decode_heads(q, k_att, v_att, kv_local, tp, mesh, **att_kw)
    elif ctx is not None and ctx.mesh is not None and t > 1:
        att = L.attention_sharded(q, k_att, v_att, ctx, q_local=q_local, kv_local=kv_local,
                                  out_local=rows, **att_kw)
    else:
        att = L.attention(q, k_att, v_att, **att_kw)
    if rows:
        x = x + L.row_parallel(att, blk["wo_att"], tp, mesh)
    else:
        x = x + att.reshape(b, t, h * hd) @ blk["wo_att"]
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    if cfg.family != "moe":
        return x + _mlp(y2, blk["wi"], blk["wo"], cfg.act, roles.get("wi"), roles.get("wo"),
                        ctx), None
    # y2 is alike over tp (the row-parallel sums are), as _moe_ep's gradient
    # convention over its replicated axes needs
    ff, aux = moe_block(y2, blk["moe"], cfg, ctx)
    if cfg.n_shared_experts:
        ff = ff + _mlp(y2, blk["wi_sh"], blk["wo_sh"], cfg.act, roles.get("wi_sh"),
                       roles.get("wo_sh"), ctx)
    return x + ff, aux


def _index(tree, i: int):
    return {n: _index(w, i) for n, w in tree.items()} if isinstance(tree, dict) else tree[i]


def _layer(params: dict, i: int) -> dict:
    """Layer i's weights: entry i of each leaf of ``params["blocks"]``
    (nested for the MoE block): a view of a stacked [L, ...] leaf, or a
    per-layer leaf of the train step's lists."""
    return _index(params["blocks"], i)


def _embed_input(cfg: ArchConfig, table, split: bool, tokens, prefix_embeds,
                 ctx=None) -> torch.Tensor:
    if split:
        x = L.embed_parallel(tokens, table, ctx.tp_axis, ctx.mesh, scale=True)
    else:
        x = L.embed(tokens, table, scale=True)
    if prefix_embeds is not None:
        x[:, : prefix_embeds.shape[1]] = round_to_compute(cfg, prefix_embeds.float())
    return x


def _logits(cfg: ArchConfig, params: dict, x, master: bool = False, ctx=None,
            gather: bool = True) -> torch.Tensor:
    """The head's logits; where the rules split the vocab over tp, the
    rank's block of them, all-gathered over tp if ``gather``."""
    x = L.rms_norm(x, sharding.use(ctx, params["final_norm"], "final_norm"), cfg.norm_eps)
    if "lm_head" in params:
        head, split = sharding.use_vocab(ctx, params, "lm_head")
    else:
        head, split = sharding.use_vocab(ctx, params, "embed")
        head = head.T
    head = round_to_compute(cfg, head) if master else head.float()
    if not split:
        return x @ head
    return L.head_parallel(x, head, ctx.tp_axis, ctx.mesh, gather)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None, ctx=None):
    """Full-sequence logits [B, T, V] float32 and the MoE aux loss summed
    over the layers (0 for a dense model)."""
    _check(cfg, tokens.device)
    x = _embed_input(cfg, *sharding.use_vocab(ctx, params, "embed"), tokens, prefix_embeds, ctx)
    pos = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, window in enumerate(_layer_windows(cfg)):
        x, aux_l = _block_fn(cfg, x, _layer(params, i), window, pos, ctx=ctx)
        aux = aux if aux_l is None else aux + aux_l
    return _logits(cfg, params, x, ctx=ctx), aux


def forward_train(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                  prefix_embeds: torch.Tensor | None = None, ctx=None):
    """Full-sequence logits [B, T, V] float32 and the MoE aux loss from
    float32 master weights, with the reference's in-graph casts (module
    doc).  Each leaf of ``params["blocks"]`` is stacked [L, ...] or a list
    of per-layer leaves (the train step's); each layer runs under
    ``layers.remat``.  Where ``sharding.vocab_split``, the logits are the rank's
    [B, T, V / tp] block."""
    _check(cfg, tokens.device)
    table, split = sharding.use_vocab(ctx, params, "embed")
    x = _embed_input(cfg, table.to(_dtype(cfg.dtype)), split, tokens, prefix_embeds, ctx)
    del table
    pos = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, window in enumerate(_layer_windows(cfg)):
        x, aux_l = L.remat(cfg, lambda x, blk, window=window: _block_fn(
            cfg, x, blk, window, pos, master=True, ctx=ctx), x, _layer(params, i))
        aux = aux if aux_l is None else aux + aux_l
    return _logits(cfg, params, x, master=True, ctx=ctx, gather=False), aux


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
    _check(cfg, tokens.device)
    x = _embed_input(cfg, *sharding.use_vocab(ctx, params, "embed"), tokens, prefix_embeds, ctx)
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    kv = cache["kv"]
    for i, window in enumerate(_layer_windows(cfg)):
        x, _ = _block_fn(cfg, x, _layer(params, i), window, pos, cache_l=kv[i], kv_len=0, ctx=ctx)
    return _logits(cfg, params, x[:, -1:], ctx=ctx), {"kv": kv, "len": t}


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache: dict, *, ctx=None):
    """One decode step: tokens [B, 1] -> logits [B, 1, V]; the cache is
    updated in place and returned with its length + 1."""
    _check(cfg, tokens.device)
    x = _embed_input(cfg, *sharding.use_vocab(ctx, params, "embed"), tokens, None, ctx)
    kv_len = int(cache["len"])
    pos = torch.arange(kv_len, kv_len + 1, device=x.device)
    kv = cache["kv"]
    for i, window in enumerate(_layer_windows(cfg)):
        x, _ = _block_fn(cfg, x, _layer(params, i), window, pos, cache_l=kv[i], kv_len=kv_len,
                         ctx=ctx)
    return _logits(cfg, params, x, ctx=ctx), {"kv": kv, "len": kv_len + 1}
