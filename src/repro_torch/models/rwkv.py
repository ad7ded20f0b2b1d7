"""RWKV-6 "Finch" — the attention-free SSM family (rwkv6-7b): the port of
``repro.models.rwkv``.

Data-dependent per-channel decay with the time-mix / channel-mix block
structure.  The wkv recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (S: [dk, dv] per head)
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

runs in the reference's chunked form: within a chunk of C steps every decay
factor is exp(logA_i - logA_j) with i >= j (no exponent above 0), and the
state is carried from chunk to chunk (the reference's ``lax.scan``).  The
port computes the terms that do not read the state (the intra-chunk
scores, the bonus, each chunk's state increment) for ``_CHUNKS_AT_ONCE``
chunks at once, then carries the state through them one chunk at a time,
one fused multiply-add each, and reads every chunk's state contribution at
once: the same sums per chunk as the reference's, in far fewer device
calls.  Decode is the C = 1 case.  There is no KV cache: the state is O(1)
in the sequence length.

The model computes in float32 throughout, from float32 weights that no
product rounds (the reference casts no leaf), so the port holds the
reference's leaves as they are, and training's master weights are the
same leaves.  No kernel runs here: the family has no attention.

Training (``forward``, through ``api.loss_fn``) runs every layer under
``layers.remat``, as
the reference's ``cfg.remat`` checkpoints its scan body.  In a layer's
backward each span of ``_CHUNKS_AT_ONCE`` chunks keeps its intra-chunk
terms for autograd: about four [B, 32, 16, 16, H, 64] float32 tensors
(134 MB each at B 1 and rwkv6-7b's 64 heads of 64), so ~0.54 GB a span and
~4.3 GB for a 4096-token layer, alive for one layer at a time.

Sharded execution (``ctx``, a ``transformer.DistContext``): a rank holds
its dp shard of the batch, its activations alike over the tensor-parallel
axis.  With spec trees on ``ctx`` each leaf is gathered at use
(``sharding.use``), but where the rules put every leaf of ``TP_ROLES`` on
``ctx.tp_axis`` and the heads divide over it (``_tp``), the products run
on the rank's block, as the reference's partitioner runs them: r / k / v /
g column-parallel on the rank's H / tp heads (one copy of the layer's
input, before its shift, and of ``mu``), the decay LoRA column-parallel ``wA`` and
row-parallel ``wB`` (alike over tp), plus ``w0`` and cut to the rank's
channels, ``u`` cut so too (``layers.split_to_group``), the wkv recurrence
on the rank's heads unchanged, ``out * g`` row-parallel into ``wo``.  The
channel mix: ``ck`` column-parallel, ``cv`` row-parallel, and the gate
``sigmoid(xr @ cr)`` on the rank's columns of ``cr``, all-gathered: the
other choice, the rank's columns of ``cv``'s sum times its gate columns,
then gathered, moves as many bytes forward and adds a gather to the
backward (``split_to_group``'s).  The embedding and head split their
vocab (``layers.embed_parallel``; training keeps the rank's block of the
logits, ``sharding.vocab_split``).  The state keeps the reference's specs (``S``'s
dk on 'model'): it is gathered at use, cut to the rank's heads, and the
new ``S`` all-gathered over the heads before ``sharding.own_state``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

_LORA_RANK = 64
_CHUNKS_AT_ONCE = 32   # chunks whose [C, C, H, dk] intra-chunk terms exist at once


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The type of the activations the products read: float32 (module doc)."""
    return torch.float32


def hold_leaf(cfg: ArchConfig, path: tuple[str, ...], t: torch.Tensor,
              master: bool = False) -> torch.Tensor:
    """Leaf ``path`` (``t``, in ``cfg.param_dtype``) as the port holds it:
    as it is (module doc)."""
    return t


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device=None, *,
                master: bool = False) -> dict:
    """The reference's tree in ``cfg.param_dtype`` (``master`` changes
    nothing: no leaf is rounded for serving)."""
    d, lcount = cfg.d_model, cfg.num_layers
    dev = torch.device(device) if device is not None else gen.device
    pd = getattr(torch, cfg.param_dtype)

    def stack(shape, scale=None):
        return L.init_linear(gen, (lcount,) + shape, scale=scale, device=dev, dtype=pd)

    def full(value, *shape):
        return torch.full(shape, value, dtype=pd, device=dev)

    blocks = {
        "ln1": full(0.0, lcount, d),
        "ln2": full(0.0, lcount, d),
        # time-mix (token-shift) interpolation factors per r/k/v/w/g
        "mu": full(0.5, lcount, 5, d),
        "wr": stack((d, d)),
        "wk": stack((d, d)),
        "wv": stack((d, d)),
        "wg": stack((d, d)),
        "wo": stack((d, d)),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-6.0, lcount, d),
        "wA": stack((d, _LORA_RANK)),
        # the reference's init_linear(...) * 0.01: scale 0.01 / sqrt(fan_in)
        "wB": stack((_LORA_RANK, d), scale=0.01 / _LORA_RANK ** 0.5),
        "u": full(0.5, lcount, d),  # bonus for current token
        # channel-mix
        "mu_c": full(0.5, lcount, 2, d),
        "ck": stack((d, cfg.d_ff)),
        "cv": stack((cfg.d_ff, d)),
        "cr": stack((d, d)),
    }
    return {
        "embed": L.init_linear(gen, (cfg.vocab_size, d), scale=1.0, device=dev, dtype=pd),
        "blocks": blocks,
        "final_norm": full(0.0, d),
        "lm_head": L.init_linear(gen, (d, cfg.vocab_size), device=dev, dtype=pd),
    }


def _wkv_chunk(S, r, k, v, logw, u, chunk: int):
    """Process n consecutive chunks (n = 1: the reference's ``_wkv_chunk``).
    S: [B,H,dk,dv]; r,k,v,logw: [B,n*C,H,dk]; u: [H,dk] -> (S after the
    last chunk, out [B,n*C,H,dv])."""
    b, t, h, dk = r.shape
    n = t // chunk
    r, k, v, logw = (x.reshape(b, n, chunk, h, x.shape[-1]) for x in (r, k, v, logw))
    logA = torch.cumsum(logw, dim=2)                 # inclusive [B,n,C,H,dk]
    logA_excl = logA - logw                          # exclusive
    # intra-chunk: score[t,i] = sum_k r[t,k] k[i,k] exp(logA_excl[t]-logA[i]), i < t
    diff = logA_excl[:, :, :, None] - logA[:, :, None]   # [B,n,C,C,H,dk] (t,i)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    diff = torch.where(tri[:, :, None, None], diff, torch.full_like(diff, -torch.inf))
    att = (r[:, :, :, None] * k[:, :, None] * torch.exp(diff)).sum(-1)   # [B,n,t,i,H]
    del diff
    o_intra = torch.einsum("bntih,bnihv->bnthv", att, v)
    # current-token bonus: (r_t . (u * k_t)) v_t
    o_bonus = (r * u * k).sum(-1)[..., None] * v
    # state update: S' = diag(exp(logA_C)) S + sum_i exp(logA_C - logA_i) k_i v_i^T
    logA_C = logA[:, :, -1]                          # [B,n,H,dk]
    k_dec = k * torch.exp(logA_C[:, :, None] - logA)
    increment = torch.einsum("bnchk,bnchv->bnhkv", k_dec, v)
    decay = torch.exp(logA_C)[..., None]             # [B,n,H,dk,1]
    states = []
    for inc, dec in zip(increment.unbind(1), decay.unbind(1)):
        states.append(S)
        S = torch.addcmul(inc, S, dec)
    # state contribution: o_state[t] = (r_t * exp(logA_excl[t])) @ S of t's chunk
    o_state = torch.einsum("bnchk,bnhkv->bnchv", r * torch.exp(logA_excl), torch.stack(states, 1))
    return S, (o_state + o_intra + o_bonus).reshape(b, t, h, v.shape[-1])


def _shift(x, x_prev):
    """x shifted one step in time, ``x_prev`` entering at position 0."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _time_mix(cfg, x, x_prev, blk, S, chunk: int, tp: L.TP):
    """x: [B,T,d] (T multiple of chunk); returns (out, S', last x).  On
    ``tp``'s axis (module doc) r / k / v / g and the decay are the rank's
    heads' channels and ``S`` its heads [B, H / tp, hs, hs]."""
    b, t, d = x.shape
    hs = cfg.rwkv_head_size
    xc = tp.copy(x)   # the mixes feed column-parallel products only
    xx = _shift(xc, x_prev)
    mu = tp.copy(blk["mu"])
    xr, xk, xv, xw, xg = [xc + (xx - xc) * mu[i] for i in range(5)]
    r = L.mm(xr, blk["wr"]).view(b, t, -1, hs)
    k = L.mm(xk, blk["wk"]).view(b, t, -1, hs)
    v = L.mm(xv, blk["wv"]).view(b, t, -1, hs)
    g = F.silu(L.mm(xg, blk["wg"]))
    # the decay LoRA: column-parallel wA, row-parallel wB, alike over tp
    lora = tp.sum(L.mm(torch.tanh(L.mm(xw, blk["wA"])), blk["wB"]))
    logw = -torch.exp(tp.split(blk["w0"] + lora))
    logw = logw.view(b, t, -1, hs)                   # log decay, always < 0
    u = tp.split(blk["u"]).reshape(-1, hs)
    outs, span = [], chunk * _CHUNKS_AT_ONCE
    for c in range(0, t, span):
        S, o = _wkv_chunk(S, r[:, c:c + span], k[:, c:c + span], v[:, c:c + span],
                          logw[:, c:c + span], u, chunk)
        outs.append(o)
    out = torch.cat(outs, dim=1).reshape(b, t, -1)
    return tp.sum(L.mm(out * g, blk["wo"])), S, x[:, -1]


def _channel_mix(x, x_prev, blk, tp: L.TP):
    """On ``tp``'s axis: ``ck`` column-parallel, ``cv`` row-parallel, and
    the receptance gate the rank's columns of ``cr`` all-gathered (module
    doc)."""
    xc = tp.copy(x)
    xx = _shift(xc, x_prev)
    mu = tp.copy(blk["mu_c"])
    xk = xc + (xx - xc) * mu[0]
    xr = xc + (xx - xc) * mu[1]
    kk = torch.square(torch.relu(L.mm(xk, blk["ck"])))
    return tp.gather(torch.sigmoid(L.mm(xr, blk["cr"]))) * tp.sum(L.mm(kk, blk["cv"])), x[:, -1]


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    """{"S": [L, B, H, hs, hs], "x_tm" / "x_cm": [L, B, d] (the token
    shifts), "len": host int}."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    h = d // hs
    return {
        "S": torch.zeros((cfg.num_layers, batch, h, hs, hs), dtype=dtype, device=device),
        "x_tm": torch.zeros((cfg.num_layers, batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((cfg.num_layers, batch, d), dtype=dtype, device=device),
        "len": 0,
    }


def _block(params: dict, i: int) -> dict:
    """Layer i's weights: entry i of each leaf of ``params["blocks"]`` (a
    view of a stacked [L, ...] leaf, or a per-layer leaf of the train
    step's lists)."""
    return {n: w[i] for n, w in params["blocks"].items()}


# the tensor-parallel role (``sharding.tp_role``) each product's leaf needs
# for a layer to run on the rank's heads (module doc)
TP_ROLES = {**{n: "column" for n in ("wr", "wk", "wv", "wg", "wA", "ck", "cr")},
            **{n: "row" for n in ("wo", "wB", "cv")}}


def _tp(cfg: ArchConfig, ctx) -> L.TP:
    """The axis the layers' products split over: ``ctx.tp_axis`` where the
    rules give every leaf of ``TP_ROLES`` its role and the heads divide
    over it, else none."""
    if not sharding.tp_roles(ctx, TP_ROLES, "blocks"):
        return L.TP()
    tp = L.TP(ctx.tp_axis, ctx.mesh)
    return tp if (cfg.d_model // cfg.rwkv_head_size) % tp.size == 0 else L.TP()


def _layer(cfg, x, blk, S, x_tm, x_cm, chunk: int, ctx=None, tp: L.TP = L.TP()):
    """One layer: (x, S', last x of the time mix, of the channel mix); the
    rank's block of the weights is gathered here (``sharding.use``), but
    the leaves whose products run on ``tp``'s axis."""
    blk = sharding.use(ctx, blk, "blocks", layer=True,
                       keep_tp=TP_ROLES if tp.axis is not None else ())
    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    att, S, x_tm = _time_mix(cfg, y, x_tm, blk, S, chunk, tp)
    x = x + att
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    ff, x_cm = _channel_mix(y2, x_cm, blk, tp)
    return x + ff, S, x_tm, x_cm


def _logits(cfg, params, x, ctx=None, gather: bool = True):
    x = L.rms_norm(x, sharding.use(ctx, params["final_norm"], "final_norm"), cfg.norm_eps)
    head, split = sharding.use_vocab(ctx, params, "lm_head")
    return L.head_parallel(x, head, ctx.tp_axis, ctx.mesh, gather) if split else L.mm(x, head)


def _embed(params, tokens, ctx=None) -> torch.Tensor:
    """The token rows in float32; from the rank's vocab rows where the rules
    split them over tp (``layers.embed_parallel``; RWKV scales nothing)."""
    table, split = sharding.use_vocab(ctx, params, "embed")
    if split:
        return L.embed_parallel(tokens, table, ctx.tp_axis, ctx.mesh)
    return L.embed(tokens, table).float()


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *, state: dict | None = None,
            chunk: int = 16, ctx=None, last_only: bool = False, gather: bool = True):
    """(logits, aux 0, new state): full-sequence logits (``last_only``: the
    last position's), carrying ``state`` through the tokens; the new state
    is made afresh (``state`` is left as it was), and None without a
    ``state`` (zeros are carried).  The training forward too: each layer
    under ``layers.remat``; ``gather=False`` keeps the rank's vocab block
    of the logits where ``sharding.vocab_split``."""
    L.check_products(tokens.device, compute_dtype(cfg))
    b, t = tokens.shape
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"seq {t} not divisible by chunk {chunk}")
    x = _embed(params, tokens, ctx)
    tp = _tp(cfg, ctx)
    names = ("S", "x_tm", "x_cm")
    if state is None:  # zeros, of S the rank's heads
        hs, lc = cfg.rwkv_head_size, cfg.num_layers
        shift = torch.zeros((lc, b, cfg.d_model), dtype=torch.float32, device=x.device)
        full = {"S": torch.zeros((lc, b, cfg.d_model // hs // tp.size, hs, hs),
                                 dtype=torch.float32, device=x.device),
                "x_tm": shift, "x_cm": shift}
    else:
        st = state
        # the rank's rows of each state leaf, every layer (O(1) in the length),
        # and of S its heads
        full = {n: sharding.use_state(ctx, st[n], n, batch_dim=1) for n in names}
        full["S"] = tp.block(full["S"], 2)
    new = {n: [] for n in names}
    for i in range(cfg.num_layers):
        x, *s_i = L.remat(cfg, lambda x, blk, i=i: _layer(
            cfg, x, blk, *(full[n][i] for n in names), chunk, ctx, tp), x, _block(params, i))
        if state is not None:  # a token shift is a view of its layer's [B, T, d] input: copied
            for n, s_n in zip(names, s_i):
                new[n].append(s_n if n == "S" else s_n.clone())
    logits = _logits(cfg, params, x[:, -1:] if last_only else x, ctx, gather)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if state is None:
        return logits, aux, None
    new = {n: torch.stack(v).to(st[n].dtype) for n, v in new.items()}
    new["S"] = tp.gather(new["S"], dim=2)   # every head, then the rank's block of it
    new_state = {**{n: sharding.own_state(ctx, new[n], st[n], n, batch_dim=1) for n in names},
                 "len": int(st["len"]) + t}
    return logits, aux, new_state


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, state: dict, *, ctx=None):
    """One token through the recurrence (chunk = 1)."""
    logits, _, new_state = forward(cfg, params, tokens, state=state, chunk=1, ctx=ctx)
    return logits, new_state
