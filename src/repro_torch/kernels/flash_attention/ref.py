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

:func:`attention_split_ref` emulates the numerics of the kernel's
tensor-core design (bf16 products of three-part splits, float32 sums); the
tests hold it against :func:`attention_ref` and the reference.  The model
path never calls it.

:func:`attention_lse_ref` and :func:`attention_bwd_ref` are the plain
versions of the training path's forward (with each row's log-sum-exp) and
of the backward kernel (``csrc/flash_attention_bwd.cu``);
:func:`attention_fwd_split_ref` and :func:`attention_bwd_split_ref` emulate
the numerics of the float32-k/v forward's and the backward's tensor-core
designs (every product of float32 operands as a sum of products of their
bf16 parts; the backward's also with k and v as one part, its bf16-k/v
instances, and with the dK/dV pass's head split), for the tests only.
:func:`attention_fwd_chunked_ref` and
:func:`attention_bwd_ds_ref` emulate the key split of ``flash_tiled`` and
``bwd_wide`` (``csrc/attn_plan.h``: per-chunk partials merged in chunk
order; dQ from a stored dS), for the tests only.
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


def _heads(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, T, H, hd] -> [B, KV, G, T, hd] float32 (query head h = kv head
    h // G, group h % G)."""
    b, t, h, hd = x.shape
    return x.float().reshape(b, t, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4)


def _scores(q, k, *, causal, window, softcap, q_offset, kv_len):
    """(scaled q [B, KV, G, Tq, hd], capped scores s' [B, KV, G, Tq, Tk],
    the visible mask [Tq, Tk])."""
    qf = _heads(q, k.shape[2]) / math.sqrt(q.shape[3])
    s = torch.einsum("bkgqh,bskh->bkgqs", qf, k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = key_mask(q.shape[1], k.shape[1], causal=causal, window=int(window),
                    q_offset=int(q_offset), kv_len=None if kv_len is None else int(kv_len),
                    device=q.device)
    return qf, s, mask


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[B, KV, G, T, hd] -> [B, T, KV * G, hd]."""
    b, kvh, g, t, hd = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, t, kvh * g, hd)


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
    _, logits, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset, kv_len=kv_len)
    probs = torch.softmax(logits.masked_fill(~mask, MASK_VALUE), dim=-1)
    return _unheads(torch.einsum("bkgqs,bskh->bkgqh", probs, v.float())).to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (``attention_ref``'s output, each row's
    log-sum-exp [B, H, Tq] float32), kv_len Tk."""
    _, logits, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset, kv_len=None)
    logits = logits.masked_fill(~mask, MASK_VALUE)
    lse = torch.logsumexp(logits, dim=-1)                       # [B, KV, G, T]
    out = torch.einsum("bkgqs,bskh->bkgqh", torch.exp(logits - lse[..., None]), v.float())
    b, tq, h, _ = q.shape
    return _unheads(out).to(q.dtype), lse.reshape(b, h, tq)


def attention_bwd_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd]
    v: torch.Tensor,
    o: torch.Tensor,       # [B, Tq, H, hd]: the forward's output
    lse: torch.Tensor,     # [B, H, Tq]: the forward's log-sum-exp
    do: torch.Tensor,      # [B, Tq, H, hd]: the gradient of o
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` at ``q_offset`` with kv_len Tk
    (every row sees at least one key: ``kernel.check_grad_shape``), written
    as the formulas the backward kernel computes, not as autograd of the
    forward:

        s = (q / sqrt(hd)) . k,  s' = c tanh(s / c) (softcap c > 0, else s),
        p = exp(s' - lse) where visible, else 0,  D = rowsum(dO * O),
        dv = p^T dO,  ds = p * (dO . v - D) * (1 - (s' / c)^2),
        dq = ds . k / sqrt(hd),  dk = ds^T . (q / sqrt(hd)),

    dk and dv summed over the query heads of each kv head.  float32."""
    kvh = k.shape[2]
    qf, s, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                          q_offset=q_offset, kv_len=None)
    of, dof = _heads(o, kvh), _heads(do, kvh)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(qf.shape[:4])[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqh->bskh", p, dof)
    ds = p * (torch.einsum("bkgqh,bskh->bkgqs", dof, v.float()) - delta)
    if softcap > 0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = torch.einsum("bkgqs,bskh->bkgqh", ds, k.float()) / math.sqrt(q.shape[3])
    dk = torch.einsum("bkgqs,bkgqh->bskh", ds, qf)
    return _unheads(dq), dk, dv


def split_bf16(x: torch.Tensor, parts: int = 3) -> list[torch.Tensor]:
    """x as ``parts`` bfloat16 tensors: part i = bf16(x - the parts before
    it), rounded to nearest even.  Three parts keep all 24 bits of a float32
    mantissa, so their float32 sum is x to within float32 rounding."""
    out, rest = [], x.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16)
        out.append(part)
        rest = rest - part.float()
    return out


def attention_split_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd] bfloat16 (others are rounded to it)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
    parts: int = 3,
) -> torch.Tensor:
    """The tensor-core design's arithmetic: S = sum_i Qi . K^T with Qi the
    ``parts`` bf16 parts of q / sqrt(hd), p = exp(S - max) un-normalised,
    O = sum_i Pi . V / sum(p); every product of bf16 operands, every sum in
    float32.  [B, Tq, H, hd] float32."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    kf = k.to(torch.bfloat16).float()
    vf = v.to(torch.bfloat16).float()
    qf = (q.float() / math.sqrt(hd)).reshape(b, tq, kvh, groups, hd).permute(0, 2, 3, 1, 4)
    logits = sum(torch.einsum("bkgqh,bskh->bkgqs", part.float(), kf)
                 for part in split_bf16(qf, parts))
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = key_mask(tq, tk, causal=causal, window=int(window), q_offset=int(q_offset),
                    kv_len=None if kv_len is None else int(kv_len), device=q.device)
    logits = logits.masked_fill(~mask, MASK_VALUE)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = sum(torch.einsum("bkgqs,bskh->bkgqh", part.float(), vf)
              for part in split_bf16(p, parts))
    out = out / p.sum(-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, hd)


# The cross products of bf16 parts (i of the first operand, j of the second)
# that a float32 product is made of, largest first: the first ``pairs``
# make the product.  The backward kernel takes all six (BWD_SPLIT), the
# pairs with i + j <= 2; it sums them smallest first.
BWD_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor, parts: int,
                   pairs: int, b_parts: int | None = None) -> torch.Tensor:
    """``einsum(eq, a, b)`` of float32 ``a`` and ``b`` as the float32 sum of
    the products of their bf16 parts that the first ``pairs`` of
    ``BWD_PAIRS`` name, smallest first.  ``b_parts``: ``b`` held as that
    many parts (k or v as one, where they are bf16 values: the pairs with a
    later part of ``b``, zeros then, are left out)."""
    use = BWD_PAIRS[:pairs]
    if not 1 <= pairs <= len(BWD_PAIRS) or max(max(p) for p in use) >= parts:
        raise ValueError(f"pairs {pairs} need more than {parts} parts (or are out of range)")
    pa, pb = split_bf16(a, parts), split_bf16(b, parts if b_parts is None else b_parts)
    out = None
    for i, j in reversed(use):
        if j >= len(pb):
            continue
        term = torch.einsum(eq, pa[i].float(), pb[j].float())
        out = term if out is None else out + term
    return out


def attention_fwd_split_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd] float32
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
    parts: int = 3,
    pairs: int = 6,
    block: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32-k/v forward's tensor-core arithmetic (``flash_wgmma_split``):
    S = the float32 sum of the products of the bf16 parts of q / sqrt(hd) and
    of k (``pairs`` of ``BWD_PAIRS``, smallest first), masked to -1e30; then
    an online softmax over tiles of ``block`` keys: m' = max(m, the tile's
    max), p = exp(s - m'), l = l exp(m - m') + sum(p), and O = O exp(m - m')
    + the tile's P . V, itself a fresh float32 sum of the products of p's and
    v's parts; o = O / l, lse = m + log l.  (o [B, Tq, H, hd], lse [B, H, Tq])
    float32.  Tests only."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    qf = _heads(q, kvh) / math.sqrt(hd)
    s = _split_product("bkgqh,bskh->bkgqs", qf, k.float(), parts, pairs)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = key_mask(tq, tk, causal=causal, window=int(window), q_offset=int(q_offset),
                    kv_len=None if kv_len is None else int(kv_len), device=q.device)
    s = s.masked_fill(~mask, MASK_VALUE)
    m = torch.full(s.shape[:4], MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(*s.shape[:4], hd, dtype=torch.float32, device=q.device)
    vf = v.float()
    for n0 in range(0, tk, block):
        tile = s[..., n0:n0 + block]
        m_new = torch.maximum(m, tile.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(tile - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + _split_product("bkgqs,bskh->bkgqh", p, vf[:, n0:n0 + block],
                                                 parts, pairs)
        m = m_new
    den = l.clamp_min(1e-30)
    return _unheads(o / den[..., None]), (m + torch.log(den)).reshape(b, h, tq)


def attention_bwd_split_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd]
    v: torch.Tensor,
    o: torch.Tensor,       # [B, Tq, H, hd]: the forward's output
    lse: torch.Tensor,     # [B, H, Tq]: the forward's log-sum-exp
    do: torch.Tensor,      # [B, Tq, H, hd]: the gradient of o
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    parts: int = 3,
    pairs: int = 6,
    kv_parts: int | None = None,
    head_splits: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's tensor-core arithmetic: :func:`attention_bwd_ref`
    with each of its five products (S = Qs K^T, dP = dO V^T, dV = P^T dO,
    dK = dS^T Qs, dQ = dS K; Qs = q / sqrt(hd)) a sum of products of the
    operands' ``parts`` bf16 parts (``pairs`` of ``BWD_PAIRS``, the first
    operand's part first), every sum in float32.  ``kv_parts``: k and v held
    as that many parts (1: ``bwd_wide``'s bf16-k/v instances, exact for bf16
    values).  ``head_splits``: the dK/dV pass's head split, each of the n
    contiguous subsets of a group's query heads summed on its own, the
    subsets then added in order.  Tests only."""
    kvh = k.shape[2]
    qf = _heads(q, kvh) / math.sqrt(q.shape[3])
    mask = key_mask(q.shape[1], k.shape[1], causal=causal, window=int(window),
                    q_offset=int(q_offset), kv_len=None, device=q.device)
    kf, vf = k.float(), v.float()
    of, dof = _heads(o, kvh), _heads(do, kvh)
    s = _split_product("bkgqh,bskh->bkgqs", qf, kf, parts, pairs, kv_parts)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(qf.shape[:4])[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (_split_product("bkgqh,bskh->bkgqs", dof, vf, parts, pairs, kv_parts) - delta)
    if softcap > 0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = _split_product("bkgqs,bskh->bkgqh", ds, kf, parts, pairs, kv_parts) / math.sqrt(q.shape[3])
    groups = qf.shape[2]
    bounds = [i * groups // head_splits for i in range(head_splits + 1)]
    dk = dv = None
    for h0, h1 in zip(bounds, bounds[1:]):
        dv_s = _split_product("bkgqs,bkgqh->bskh", p[:, :, h0:h1], dof[:, :, h0:h1], parts, pairs)
        dk_s = _split_product("bkgqs,bkgqh->bskh", ds[:, :, h0:h1], qf[:, :, h0:h1], parts, pairs)
        dv = dv_s if dv is None else dv + dv_s
        dk = dk_s if dk is None else dk + dk_s
    return _unheads(dq), dk, dv


def attention_fwd_chunked_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd]
    v: torch.Tensor,
    bounds,                # chunk c holds keys bounds[c] .. bounds[c + 1] - 1
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_tiled``'s key split: each chunk's unnormalised partial (m, l,
    acc) over its keys, logits masked to -1e30 as in ``attention_ref``; a
    row that sees no key of a chunk (but some key of the call) gives m =
    -inf, l = 0, acc = 0; then the merge in chunk order: w_c = exp(m_c -
    max), l = sum_c l_c w_c, o = sum_c acc_c w_c / l, lse = max + log l.  A
    row that sees no key at all keeps its -1e30 logits in every chunk: the
    mean of v over the chunks' keys (all Tk, as the plan gives such a call).
    (o [B, Tq, H, hd], lse [B, H, Tq]) float32.  Tests only."""
    b, tq, h, _ = q.shape
    vf = v.float()
    _, s, mask = _scores(q, k, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                         kv_len=kv_len)
    s = s.masked_fill(~mask, MASK_VALUE)
    sees_any = mask.any(-1)                                     # [Tq]
    parts = []
    for c in range(len(bounds) - 1):
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        sc = s[..., lo:hi]
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        l, acc = p.sum(-1), torch.einsum("bkgqs,bskh->bkgqh", p, vf[:, lo:hi])
        none = sees_any & ~mask[:, lo:hi].any(-1)               # rows with no key here
        m = torch.where(none, float("-inf"), m)
        l = torch.where(none, 0.0, l)
        acc = torch.where(none[:, None], 0.0, acc)
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l_sum, o = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(m == float("-inf"), 0.0, torch.exp(m - mx))
        l_sum = l_sum + l * w
        o = o + acc * w[..., None]
    den = l_sum.clamp_min(1e-30)
    return _unheads(o / den[..., None]), (mx + torch.log(den)).reshape(b, h, tq)


def attention_bwd_ds_ref(
    q: torch.Tensor,       # [B, Tq, H, hd]
    k: torch.Tensor,       # [B, Tk, KV, hd]
    v: torch.Tensor,
    o: torch.Tensor,       # [B, Tq, H, hd]: the forward's output
    lse: torch.Tensor,     # [B, H, Tq]: the forward's log-sum-exp
    do: torch.Tensor,      # [B, Tq, H, hd]: the gradient of o
    bounds,                # dQ's key chunks, as ``attention_fwd_chunked_ref``'s
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bwd_wide``'s dS path: :func:`attention_bwd_ref`'s formulas, with dS
    stored as the dK/dV pass stores it ([B, H, Tq, Tk]; here NaN wherever a
    row cannot see the key, which the dQ kernel must never read) and dQ =
    the chunks' dS K (each row's visible keys only) summed in chunk order,
    then / sqrt(hd).  float32.  Tests only."""
    kvh = k.shape[2]
    qf, s, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                          q_offset=q_offset, kv_len=None)
    of, dof = _heads(o, kvh), _heads(do, kvh)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(qf.shape[:4])[..., None]), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqh->bskh", p, dof)
    ds = p * (torch.einsum("bkgqh,bskh->bkgqs", dof, v.float()) - delta)
    if softcap > 0:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dk = torch.einsum("bkgqs,bkgqh->bskh", ds, qf)
    stored = torch.where(mask, ds, float("nan"))
    kf = k.float()
    dq = None
    for c in range(len(bounds) - 1):
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        read = torch.where(mask[:, lo:hi], stored[..., lo:hi], 0.0)
        part = torch.einsum("bkgqs,bskh->bkgqh", read, kf[:, lo:hi])
        dq = part if dq is None else dq + part
    return _unheads(dq / math.sqrt(q.shape[3])), dk, dv


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
