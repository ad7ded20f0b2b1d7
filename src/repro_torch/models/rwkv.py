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

A ``ctx`` (``transformer.DistContext``) passes through every entry point as
in the reference, where it only hints activation shardings: a rank already
holds only its shard, so it changes nothing here.
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
    for c in range(n):
        states.append(S)
        S = torch.addcmul(increment[:, c], S, decay[:, c])
    # state contribution: o_state[t] = (r_t * exp(logA_excl[t])) @ S of t's chunk
    o_state = torch.einsum("bnchk,bnhkv->bnchv", r * torch.exp(logA_excl), torch.stack(states, 1))
    return S, (o_state + o_intra + o_bonus).reshape(b, t, h, v.shape[-1])


def _shift(x, x_prev):
    """x shifted one step in time, ``x_prev`` entering at position 0."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _time_mix(cfg, x, x_prev, blk, S, chunk: int):
    """x: [B,T,d] (T multiple of chunk); returns (out, S', last x)."""
    b, t, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    xx = _shift(x, x_prev)
    mu = blk["mu"]
    xr, xk, xv, xw, xg = [x + (xx - x) * mu[i] for i in range(5)]
    r = L.mm(xr, blk["wr"]).view(b, t, h, hs)
    k = L.mm(xk, blk["wk"]).view(b, t, h, hs)
    v = L.mm(xv, blk["wv"]).view(b, t, h, hs)
    g = F.silu(L.mm(xg, blk["wg"]))
    logw = -torch.exp(blk["w0"] + L.mm(torch.tanh(L.mm(xw, blk["wA"])), blk["wB"]))
    logw = logw.view(b, t, h, hs)                    # log decay, always < 0
    u = blk["u"].reshape(h, hs)
    outs, span = [], chunk * _CHUNKS_AT_ONCE
    for c in range(0, t, span):
        S, o = _wkv_chunk(S, r[:, c:c + span], k[:, c:c + span], v[:, c:c + span],
                          logw[:, c:c + span], u, chunk)
        outs.append(o)
    out = torch.cat(outs, dim=1).reshape(b, t, d)
    return L.mm(out * g, blk["wo"]), S, x[:, -1]


def _channel_mix(x, x_prev, blk):
    xx = _shift(x, x_prev)
    mu = blk["mu_c"]
    xk = x + (xx - x) * mu[0]
    xr = x + (xx - x) * mu[1]
    kk = torch.square(torch.relu(L.mm(xk, blk["ck"])))
    return torch.sigmoid(L.mm(xr, blk["cr"])) * L.mm(kk, blk["cv"]), x[:, -1]


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


def _layer(cfg, x, blk, S, x_tm, x_cm, chunk: int, ctx=None):
    """One layer: (x, S', last x of the time mix, of the channel mix); the
    rank's block of the weights is gathered here (``sharding.use``)."""
    blk = sharding.use(ctx, blk, "blocks", layer=True)
    y = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    att, S, x_tm = _time_mix(cfg, y, x_tm, blk, S, chunk)
    x = x + att
    y2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    ff, x_cm = _channel_mix(y2, x_cm, blk)
    return x + ff, S, x_tm, x_cm


def _logits(cfg, params, x, ctx=None):
    x = L.rms_norm(x, sharding.use(ctx, params["final_norm"], "final_norm"), cfg.norm_eps)
    return L.mm(x, sharding.use(ctx, params["lm_head"], "lm_head"))


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *, state: dict | None = None,
            chunk: int = 16, ctx=None, last_only: bool = False):
    """(logits, aux 0, new state): full-sequence logits (``last_only``: the
    last position's), carrying ``state`` (zeros when None) through the
    tokens.  The new state is made afresh; ``state`` is left as it was.
    The training forward too: each layer under ``layers.remat``."""
    L.check_products(tokens.device, compute_dtype(cfg))
    b, t = tokens.shape
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"seq {t} not divisible by chunk {chunk}")
    x = L.embed(tokens, sharding.use(ctx, params["embed"], "embed")).float()
    st = state or init_state(cfg, b, device=x.device)
    names = ("S", "x_tm", "x_cm")
    # the rank's rows of each state leaf, every layer (O(1) in the length)
    full = {n: sharding.use_state(ctx, st[n], n, batch_dim=1) for n in names}
    new = {n: [] for n in names}
    for i in range(cfg.num_layers):
        x, *s_i = L.remat(cfg, lambda x, blk, i=i: _layer(
            cfg, x, blk, *(full[n][i] for n in names), chunk, ctx), x, _block(params, i))
        for n, s_n in zip(names, s_i):
            new[n].append(s_n)
    logits = _logits(cfg, params, x[:, -1:] if last_only else x, ctx)
    new_state = {**{n: sharding.own_state(ctx, torch.stack(new[n]).to(st[n].dtype), st[n], n,
                                          batch_dim=1) for n in names},
                 "len": int(st["len"]) + t}
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), new_state


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, state: dict, *, ctx=None):
    """One token through the recurrence (chunk = 1)."""
    logits, _, new_state = forward(cfg, params, tokens, state=state, chunk=1, ctx=ctx)
    return logits, new_state
