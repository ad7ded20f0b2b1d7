"""RecurrentGemma / Griffin — the hybrid RG-LRU + local-attention (MQA)
family (recurrentgemma-9b): the port of ``repro.models.griffin``.

The block pattern ("rec", "rec", "attn") repeats; ``params["group"]`` holds
one stacked [G, ...] tree per pattern position (the reference's scan over
whole pattern groups, a Python loop here) and ``params["remainder"]`` the
layers past the last whole group.  The RG-LRU linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),   a_t = exp(log_a_t)

has no torch counterpart of the reference's ``associative_scan``: it runs
as a doubling scan over time (``_linear_scan``, log2(T) steps on [B, T, W]
tensors, each making new tensors, so that autograd follows it), float32
sums in another order than XLA's.  Decode carries (h, conv window, local
KV) state.

Arithmetic follows the reference per leaf.  Activations are ``cfg.dtype``
(bfloat16): ``w_gate``, ``w_in``, ``wq``, ``wk``, ``wv``, ``wo_a``, ``wi``,
``wo`` and ``lm_head`` are cast to it by their products (``CAST_LEAVES``);
the recurrent branch runs in float32 and reads ``wa``, ``wi_g``, ``w_out``,
``a_param`` and ``conv_w`` unrounded; ``embed`` is read in float32, scaled,
and only then cast.  The port holds each cast leaf in ``cfg.dtype`` (the
products' ``w.to(dt)`` is then a no-op) and the others in
``cfg.param_dtype``.  The attention layer reads its cache as ``q.dtype``
(``layers.kv_as``): a bfloat16 cache goes to the kernel as it is.

Training (the cache-free ``forward``, through ``api.loss_fn``) takes
float32 master weights
(``init_params(..., master=True)``): the products' ``w.to(dt)`` casts them
inside the autograd graph, so their gradients are rounded to bfloat16 as
the reference's are, and every layer runs under ``layers.remat`` (the
reference checkpoints each pattern group: the same result).  The local
attention's q, k, v are bfloat16, so its forward runs ``flash_wgmma`` with
the log-sum-exp and its backward ``bwd_wide`` (``kernels/flash_attention``).

Sharded execution (``ctx``, a ``transformer.DistContext``): a rank holds
its dp shard of the batch, its activations alike over the tensor-parallel
axis.  With spec trees on ``ctx`` each leaf is gathered at use
(``sharding.use``), but where the rules put a layer's product leaves on
``ctx.tp_axis`` (``TP_ROLES``, ``_tp``) its products run on the rank's
block.  The recurrent branch: ``w_gate`` and ``w_in`` column-parallel,
the causal conv on the rank's W / tp channels with its block of
``conv_w``, the gates' ``wa`` and ``wi_g`` column-parallel on the whole
branch input (one all-gather of it), the RG-LRU on the rank's channels
(``a_param`` cut so, ``layers.split_to_group``), ``gate * h`` row-parallel
into ``w_out``.  The attention layer: the rank's H / tp q heads stay
local; ``wk`` / ``wv`` make the rank's columns of the kv heads, which are
all-gathered before rope (the cache keeps whole kv heads, as its specs
do), and the rank's q heads attend over them; ``wo_a`` row-parallel.  The
MLPs are ``layers.gated_mlp_parallel``; the embedding and head split
their vocab (training keeps the rank's block of the logits,
``sharding.vocab_split``).  The recurrent state stays whole over 'model' (its
specs): cut to the rank's channels at use, the new values all-gathered
before ``sharding.own_state``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

_C = 8.0  # RG-LRU decay sharpness (Griffin paper)

# leaves whose products cast them to cfg.dtype
CAST_LEAVES = ("w_gate", "w_in", "wq", "wk", "wv", "wo_a", "wi", "wo", "lm_head")


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The type of the activations the products read: ``cfg.dtype``."""
    return getattr(torch, cfg.dtype)


def _leaf_dtype(cfg: ArchConfig, name: str, master: bool = False) -> torch.dtype:
    """The dtype the port holds leaf ``name`` in (module doc)."""
    if name in CAST_LEAVES and not master:
        return compute_dtype(cfg)
    return getattr(torch, cfg.param_dtype)


def hold_leaf(cfg: ArchConfig, path: tuple[str, ...], t: torch.Tensor,
              master: bool = False) -> torch.Tensor:
    """Leaf ``path`` (``t``, in ``cfg.param_dtype``) as the port holds it."""
    return t.to(_leaf_dtype(cfg, path[-1], master))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _init_rec(cfg: ArchConfig, lin, full) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "ln1": full("ln1", 0.0, d),
        "ln2": full("ln2", 0.0, d),
        "w_in": lin("w_in", (d, w)),
        "w_gate": lin("w_gate", (d, w)),
        "w_out": lin("w_out", (w, d)),
        "conv_w": lin("conv_w", (cfg.conv_width, w), 0.1),
        "wa": lin("wa", (w, w)),
        "wi_g": lin("wi_g", (w, w)),
        "a_param": full("a_param", 0.6, w),
        "wi": lin("wi", (d, 2 * cfg.d_ff)),
        "wo": lin("wo", (cfg.d_ff, d)),
    }


def _init_attn(cfg: ArchConfig, lin, full) -> dict:
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    return {
        "ln1": full("ln1", 0.0, d),
        "ln2": full("ln2", 0.0, d),
        "wq": lin("wq", (d, h * hd)),
        "wk": lin("wk", (d, kv * hd)),
        "wv": lin("wv", (d, kv * hd)),
        "wo_a": lin("wo_a", (h * hd, d)),
        "wi": lin("wi", (d, 2 * cfg.d_ff)),
        "wo": lin("wo", (cfg.d_ff, d)),
    }


def _grouping(cfg: ArchConfig) -> tuple[int, tuple[str, ...]]:
    glen = len(cfg.block_pattern)
    ngroups = cfg.num_layers // glen
    rem = cfg.layer_kinds()[ngroups * glen:]
    return ngroups, tuple(rem)


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device=None, *,
                master: bool = False) -> dict:
    """The reference's tree, each leaf held as ``hold_leaf`` does (``master``:
    every leaf in ``cfg.param_dtype``, unrounded)."""
    dev = torch.device(device) if device is not None else gen.device
    pd = getattr(torch, cfg.param_dtype)
    ngroups, rem = _grouping(cfg)

    def maker(lead: tuple[int, ...]):
        def lin(name, shape, scale=None):
            w = L.init_linear(gen, lead + shape, scale=scale, device=dev, dtype=pd)
            return hold_leaf(cfg, (name,), w, master)

        def full(name, value, *shape):
            return torch.full(lead + shape, value, dtype=_leaf_dtype(cfg, name, master), device=dev)

        return lin, full

    def init(kind, lead):
        return (_init_rec if kind == "rec" else _init_attn)(cfg, *maker(lead))

    lin, _ = maker(())
    return {
        "embed": lin("embed", (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5),
        "group": tuple(init(kind, (ngroups,)) for kind in cfg.block_pattern),
        "remainder": tuple(init(kind, ()) for kind in rem),
        "final_norm": torch.zeros((cfg.d_model,), dtype=pd, device=dev),
        "lm_head": lin("lm_head", (cfg.d_model, cfg.vocab_size)),
    }


# ---------------------------------------------------------------------------
# sublayers
# ---------------------------------------------------------------------------


def _causal_conv(x, conv_w, carry=None):
    """Width-cw causal conv over time. x: [B,T,W]; carry: [B,cw-1,W]|None."""
    cw = conv_w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], cw - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)
    out = sum(xp[:, j: j + x.shape[1]] * conv_w[cw - 1 - j] for j in range(cw))
    return out, xp[:, -(cw - 1):]


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over dim 1, as a doubling scan:
    after the step of span s, (a_t, b_t) compose the s steps ending at t,
    b_t + a_t b_{t-s} and a_t a_{t-s}, both from the previous step's values.
    log2(T) steps; every a <= 1, so no product overflows.  Each step makes
    new tensors (autograd saves the previous step's)."""
    t, span = a.shape[1], 1
    while span < t:
        b = torch.cat([b[:, :span], b[:, span:] + a[:, span:] * b[:, :-span]], dim=1)
        a = torch.cat([a[:, :span], a[:, span:] * a[:, :-span]], dim=1)
        span *= 2
    return b


def _rg_lru(x, blk, h0=None, tp: L.TP = L.TP()):
    """x: [B,T,W] float32 -> (h [B,T,W], h_last [B,W]).  Gates from the
    branch input; the recurrence by ``_linear_scan``.  On ``tp``'s axis x,
    h and h0 are the rank's W / tp channels, and the gates' column-parallel
    products read the whole branch input (one all-gather)."""
    xw = tp.copy(tp.gather(x))
    r = torch.sigmoid(L.mm(xw, blk["wa"]))
    i = torch.sigmoid(L.mm(xw, blk["wi_g"]))
    log_a = -_C * F.softplus(tp.split(blk["a_param"].float())) * r      # <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    b = x * i * mult
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h, h[:, -1]


def _mlp(cfg, y, blk, dt, tp: L.TP):
    """The gated MLP; on ``tp``'s axis ``layers.gated_mlp_parallel``."""
    wi, wo = blk["wi"].to(dt), blk["wo"].to(dt)
    if tp.axis is None:
        return L.gated_mlp(y, wi, wo, cfg.act)
    return L.gated_mlp_parallel(y, wi, wo, tp.axis, tp.mesh, cfg.act)


def _rec_layer(cfg, x, blk, state=None, tp: L.TP = L.TP()):
    """Recurrent temporal block + MLP. state: {'h': [B,W], 'conv': [B,cw-1,W]}
    (on ``tp``'s axis the rank's W / tp channels: module doc)."""
    dt = x.dtype
    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    yc = tp.copy(y)   # one copy for the two column-parallel products
    gate = L.gelu(yc @ blk["w_gate"].to(dt))
    # the recurrent branch in float32; its carried state is float32
    u = (yc @ blk["w_in"].to(dt)).float()
    u, conv_carry = _causal_conv(u, blk["conv_w"], state["conv"] if state else None)
    h, h_last = _rg_lru(u, blk, state["h"] if state else None, tp)
    x = x + tp.sum(L.mm(gate.float() * h, blk["w_out"])).to(dt)
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    x = x + _mlp(cfg, y2, blk, dt, tp)
    return x, {"h": h_last, "conv": conv_carry}


def _attn_layer(cfg, x, blk, pos, cache=None, kv_len: int = 0, tp: L.TP = L.TP()):
    """Local MQA temporal block + MLP. cache: [2,B,S,KV,hd] | None; with a
    cache, the layer's k/v are written into it in place.  On ``tp``'s axis
    q is the rank's H / tp heads and k / v the rank's columns of the kv
    heads, all-gathered (module doc)."""
    dt = x.dtype
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    yc = tp.copy(y)
    q = L.rope((yc @ blk["wq"].to(dt)).view(b, t, -1, hd), pos, cfg.rope_theta)
    # every rank's q heads read k / v: the copy sums the ranks' shares of
    # their gradient, the gather keeps the rank's columns of it
    k = L.rope(tp.copy(tp.gather(yc @ blk["wk"].to(dt))).view(b, t, -1, hd), pos, cfg.rope_theta)
    v = tp.copy(tp.gather(yc @ blk["wv"].to(dt))).view(b, t, -1, hd)
    q_off, att_kv_len = 0, None
    if cache is not None:
        start = kv_len if t == 1 else 0
        if start + t > cache.shape[2]:
            raise ValueError(f"KV cache of {cache.shape[2]} positions is full")
        cache[0, :, start:start + t] = k
        cache[1, :, start:start + t] = v
        k, v = L.kv_as(cache[0], q.dtype), L.kv_as(cache[1], q.dtype)
        q_off, att_kv_len = start, kv_len + t
    # the rank's q heads over the kv heads they map to (every kv head at tp 1)
    att = L.attention_island(q, k, v, tp.rank, tp.size, plan="head", causal=True,
                             window=cfg.sliding_window or 2048, q_offset=q_off,
                             kv_len=att_kv_len)
    x = x + tp.sum(att.reshape(b, t, -1) @ blk["wo_a"].to(dt))
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + _mlp(cfg, y2, blk, dt, tp)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def init_state(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """{"group": per pattern position, a stacked [G, ...] rec state {"h",
    "conv"} (float32) or KV cache [G, 2, B, S, KV, hd] (``dtype``);
    "remainder": the same unstacked; "len": host int}."""
    ngroups, rem = _grouping(cfg)
    w = cfg.lru_width or cfg.d_model
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def state(kind, lead):
        if kind == "rec":
            return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
                    "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                                        dtype=torch.float32, device=device)}
        return torch.zeros(lead + (2, batch, max_len, kv, hd), dtype=dtype, device=device)

    return {"group": tuple(state(kind, (ngroups,)) for kind in cfg.block_pattern),
            "remainder": tuple(state(kind, ()) for kind in rem),
            "len": 0}


def _layer_state(st, g: int | None):
    if st is None or g is None:
        return st
    return {n: s[g] for n, s in st.items()} if isinstance(st, dict) else st[g]


# the tensor-parallel role (``sharding.tp_role``) each product's leaf needs
# for a layer of each kind to run on the rank's channels or heads
TP_ROLES = {
    "rec": {**{n: "column" for n in ("w_in", "w_gate", "wa", "wi_g", "conv_w", "wi")},
            "w_out": "row", "wo": "row"},
    "attn": {**{n: "column" for n in ("wq", "wk", "wv", "wi")}, "wo_a": "row", "wo": "row"},
}


def _tp(cfg: ArchConfig, ctx, kind: str, where: tuple) -> tuple[dict, L.TP]:
    """(the roles, the axis) a layer of ``kind`` at ``where`` runs its
    products on: ``TP_ROLES[kind]`` and ``ctx.tp_axis`` where the rules
    give every such leaf its role (and the q heads divide over the axis),
    else none: the layer runs on whole leaves."""
    roles = sharding.tp_roles(ctx, TP_ROLES[kind], *where)
    if not roles:
        return {}, L.TP()
    tp = L.TP(ctx.tp_axis, ctx.mesh)
    return ({}, L.TP()) if kind == "attn" and cfg.num_heads % tp.size else (roles, tp)


def _run(cfg, x, kind, blk, st, pos, kv_len, ctx=None, where: tuple = (), layer: bool = False):
    """One layer; its state is updated in place.  With spec trees on
    ``ctx``, ``blk`` and ``st`` are the rank's blocks of the leaves at
    ``where`` (``layer``: one layer's view of the stacked group): gathered
    here, but the leaves whose products run on the rank's block (``_tp``),
    and the rank's block of the new state written back (the recurrent
    state's rank's channels all-gathered first)."""
    roles, tp = _tp(cfg, ctx, kind, where)
    blk = sharding.use(ctx, blk, *where, layer=layer, keep_tp=roles)
    if kind == "attn":
        full = None if st is None else sharding.use_state(ctx, st, *where, batch_dim=1,
                                                          layer=layer)
        x = _attn_layer(cfg, x, blk, pos, cache=full, kv_len=kv_len, tp=tp)
        if full is not st:
            st.copy_(sharding.own_state(ctx, full, st, *where, batch_dim=1, layer=layer))
        return x
    full = None if st is None else {
        n: tp.block(sharding.use_state(ctx, t, *where, n, batch_dim=0, layer=layer), -1)
        for n, t in st.items()}
    x, new = _rec_layer(cfg, x, blk, full, tp)
    if st is not None:
        for n in ("h", "conv"):
            st[n].copy_(sharding.own_state(ctx, tp.gather(new[n]), st[n], *where, n,
                                           batch_dim=0, layer=layer))
    return x


def _layers(cfg, params, state):
    """(kind, weights, state or None, the leaves' path, whether a layer's
    view of a stacked subtree) of every layer in order: the pattern groups
    (entry g of each leaf of ``params["group"][j]``, a view of a stacked
    [G, ...] leaf or a per-layer leaf of the train step's lists), then the
    remainder."""
    ngroups, rem = _grouping(cfg)
    for g in range(ngroups):
        for j, kind in enumerate(cfg.block_pattern):
            blk = {n: w[g] for n, w in params["group"][j].items()}
            st = _layer_state(state["group"][j], g) if state is not None else None
            yield kind, blk, st, ("group", j), True
    for j, kind in enumerate(rem):
        st = state["remainder"][j] if state is not None else None
        yield kind, params["remainder"][j], st, ("remainder", j), False


def _apply_pattern(cfg, x, params, state, pos, kv_len: int, ctx=None):
    """Every layer in order.  With a state, each layer's state is updated in
    place; without (training), each layer runs under ``layers.remat``."""
    for kind, blk, st, where, layer in _layers(cfg, params, state):
        if state is None:
            x = L.remat(cfg, lambda x, blk, kind=kind, where=where, layer=layer: _run(
                cfg, x, kind, blk, None, pos, kv_len, ctx, where, layer), x, blk)
        else:
            x = _run(cfg, x, kind, blk, st, pos, kv_len, ctx, where, layer)
    return x


def _logits(cfg, params, x, ctx=None, gather: bool = True):
    x = L.rms_norm(x, sharding.use(ctx, params["final_norm"], "final_norm"), cfg.norm_eps)
    head, split = sharding.use_vocab(ctx, params, "lm_head")
    head = head.to(x.dtype)
    return L.head_parallel(x, head, ctx.tp_axis, ctx.mesh, gather) if split else x @ head


def _embed(cfg, params, tokens, ctx=None):
    dt = getattr(torch, cfg.dtype)
    table, split = sharding.use_vocab(ctx, params, "embed")
    if split:
        return L.embed_parallel(tokens, table, ctx.tp_axis, ctx.mesh, scale=True).to(dt)
    return L.embed(tokens, table.float(), scale=True).to(dt)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *, state: dict | None = None,
            ctx=None, last_only: bool = False, gather: bool = True):
    """(logits, aux 0, state): the cache-free forward (``state`` None), or
    the prefill, which fills ``state`` in place and returns it with its
    length.  ``last_only``: the last position's logits only; ``gather=False``
    keeps the rank's vocab block of them where ``sharding.vocab_split``."""
    L.check_products(tokens.device, compute_dtype(cfg))
    b, t = tokens.shape
    x = _embed(cfg, params, tokens, ctx)
    pos = torch.arange(t, device=x.device)
    x = _apply_pattern(cfg, x, params, state, pos, 0, ctx)
    logits = _logits(cfg, params, x[:, -1:] if last_only else x, ctx, gather)
    if state is not None:
        state = {**state, "len": int(state["len"]) + t}
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), state


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, state: dict, *, ctx=None):
    """One token; carries the h / conv / local-KV state (updated in place)."""
    L.check_products(tokens.device, compute_dtype(cfg))
    x = _embed(cfg, params, tokens, ctx)
    kv_len = int(state["len"])
    pos = torch.arange(kv_len, kv_len + 1, device=x.device)
    x = _apply_pattern(cfg, x, params, state, pos, kv_len, ctx)
    return _logits(cfg, params, x, ctx), {**state, "len": kv_len + 1}
