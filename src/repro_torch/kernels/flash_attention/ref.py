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
tensor-core design (q scaled by log2(e) / sqrt(hd), bf16 products of
three-part splits, float32 sums, an exp2 softmax over key tiles in two
turns whose states are merged: ``_turns``); the tests hold it against
:func:`attention_ref` and the reference.  The model path never calls it.

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
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (``attention_ref``'s output, each row's
    log-sum-exp [B, H, Tq] float32)."""
    _, logits, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset, kv_len=kv_len)
    logits = logits.masked_fill(~mask, MASK_VALUE)
    lse = torch.logsumexp(logits, dim=-1)                       # [B, KV, G, T]
    # a row that sees no key weighs every key 1 / Tk: its lse, -1e30 +
    # log(Tk), rounds to -1e30 in float32, so exp(logits - lse) would be 1
    p = torch.where(mask.any(-1)[:, None], torch.exp(logits - lse[..., None]), 1.0 / k.shape[1])
    out = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
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
    kv_len: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` at ``q_offset`` over the rows that
    see a key (a row that sees none adds nothing here: the autograd wrapper,
    ``ops.FlashAttention``, adds its term), written as the formulas the
    backward kernel computes, not as autograd of the forward:

        s = (q / sqrt(hd)) . k,  s' = c tanh(s / c) (softcap c > 0, else s),
        p = exp(s' - lse) where visible, else 0,  D = rowsum(dO * O),
        dv = p^T dO,  ds = p * (dO . v - D) * (1 - (s' / c)^2),
        dq = ds . k / sqrt(hd),  dk = ds^T . (q / sqrt(hd)),

    dk and dv summed over the query heads of each kv head (0 past kv_len).
    float32."""
    kvh = k.shape[2]
    qf, s, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                          q_offset=q_offset, kv_len=kv_len)
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


LOG2E = 1.4426950408889634


def _q_log2(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """q [B, Tq, H, hd] as ``_heads`` gives it, times float32(log2(e) /
    sqrt(hd)): the kernel's scale before its split, so that the scores come
    out in log2 units."""
    return _heads(q, kvh) * torch.tensor(LOG2E / math.sqrt(q.shape[3]), dtype=torch.float32)


WG_ROWS = 64  # rows (position, query head of a kv head) of a flash_wgmma block


def _first_tiles(tq: int, groups: int, tk: int, *, causal: bool, window: int, q_offset: int,
                 kv_len: int | None, block: int) -> torch.Tensor:
    """Each row's first key tile in ``flash_wgmma`` ([groups, Tq]): its block
    of ``WG_ROWS`` rows (m = position * groups + head) starts at the first
    key its first row sees, at key 0 where a row of its first or last
    position sees none (the kernel's ``block_keys``)."""
    m = torch.arange(tq * groups)
    m0 = m // WG_ROWS * WG_ROWS
    m_last = torch.clamp(m0 + WG_ROWS - 1, max=tq * groups - 1)
    end = tk if kv_len is None else min(int(kv_len), tk)

    def lo(pos):
        return (pos - window + 1).clamp_min(0) if window > 0 else torch.zeros_like(pos)

    def hi(pos):
        return torch.clamp(pos, max=end - 1) if causal else torch.full_like(pos, end - 1)

    first, last = q_offset + m0 // groups, q_offset + m_last // groups
    empty = (lo(first) > hi(first)) | (lo(last) > hi(last))
    k_lo = torch.where(empty, 0, lo(first))
    return (k_lo // block).reshape(tq, groups).T


def _turns(s2: torch.Tensor, pv, block: int,
           first: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_wgmma``'s softmax: the masked scores ``s2`` [..., G, Tq, Tk]
    (log2 units, -1e30 where masked) in tiles of ``block`` keys taken in two
    turns, tile j by turn (j - ``first``) mod 2 (``first`` [G, Tq]: each
    row's first tile, ``_first_tiles``), each an online softmax in exp2:
    m' = max(m, the tile's max), p = 2^(s - m'), l = l 2^(m - m') + sum(p),
    O = O 2^(m - m') + ``pv(p, n0)`` (the tile's fresh P . V); then the
    turns merged (weights 2^(m_i - max)).  A tile outside a row block's keys,
    which the kernel skips, holds masked keys only and weighs nothing.  (O /
    l [..., Tq, hd], lse in natural units [..., Tq]; a row that sees no key
    keeps -1e30.)"""
    tk = s2.shape[-1]
    m = [torch.full(s2.shape[:-1], MASK_VALUE, dtype=torch.float32, device=s2.device)] * 2
    l, o = [torch.zeros_like(m[0])] * 2, None
    for j, n0 in enumerate(range(0, tk, block)):
        even = ((j - first) % 2 == 0).expand(m[0].shape)  # the row's turn 0 takes tile j
        m_cur, l_cur = torch.where(even, m[0], m[1]), torch.where(even, l[0], l[1])
        tile = s2[..., n0:n0 + block]
        m_new = torch.maximum(m_cur, tile.amax(-1))
        corr = torch.exp2(m_cur - m_new)
        p = torch.exp2(tile - m_new[..., None])
        part = pv(p, n0)
        if o is None:
            o = [torch.zeros_like(part)] * 2
        o_new = torch.where(even[..., None], o[0], o[1]) * corr[..., None] + part
        l_new = l_cur * corr + p.sum(-1)
        m = [torch.where(even, m_new, m[0]), torch.where(even, m[1], m_new)]
        l = [torch.where(even, l_new, l[0]), torch.where(even, l[1], l_new)]
        o = [torch.where(even[..., None], o_new, o[0]), torch.where(even[..., None], o[1], o_new)]
    mx = torch.maximum(m[0], m[1])
    w0, w1 = torch.exp2(m[0] - mx), torch.exp2(m[1] - mx)
    den = (l[0] * w0 + l[1] * w1).clamp_min(1e-30)
    out = o[0] * w0[..., None] + o[1] * w1[..., None]
    lse = torch.where(mx == MASK_VALUE, MASK_VALUE, mx * math.log(2.0)) + torch.log(den)
    return out / den[..., None], lse


def _masked_log2(s2, q, k, *, causal, window, softcap, q_offset, kv_len):
    """Scores in log2 units capped (the cap in log2 units too) and masked to
    -1e30, as the kernel forms them."""
    if softcap > 0:
        cap = softcap * LOG2E
        s2 = cap * torch.tanh(s2 / cap)
    mask = key_mask(q.shape[1], k.shape[1], causal=causal, window=int(window),
                    q_offset=int(q_offset), kv_len=None if kv_len is None else int(kv_len),
                    device=q.device)
    return s2.masked_fill(~mask, MASK_VALUE)


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
    block: int = 64,
) -> torch.Tensor:
    """``flash_wgmma``'s arithmetic on bf16 k/v: S = sum_i Qi . K^T with Qi
    the ``parts`` bf16 parts of q log2(e) / sqrt(hd), then ``_turns`` over
    tiles of ``block`` keys, each tile's P . V = sum_i Pi . V (the parts of
    the un-normalised p); every product of bf16 operands, every sum in
    float32.  [B, Tq, H, hd] float32."""
    kvh = k.shape[2]
    kf = k.to(torch.bfloat16).float()
    vf = v.to(torch.bfloat16).float()
    qf = _q_log2(q, kvh)
    s2 = sum(torch.einsum("bkgqh,bskh->bkgqs", part.float(), kf) for part in split_bf16(qf, parts))
    s2 = _masked_log2(s2, q, k, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                      kv_len=kv_len)

    def pv(p, n0):
        return sum(torch.einsum("bkgqs,bskh->bkgqh", part.float(), vf[:, n0:n0 + block])
                   for part in split_bf16(p, parts))

    first = _first_tiles(q.shape[1], q.shape[2] // kvh, k.shape[1], causal=causal,
                         window=int(window), q_offset=int(q_offset), kv_len=kv_len, block=block)
    out, _ = _turns(s2, pv, block, first)
    return _unheads(out)


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
    block: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32-k/v forward's tensor-core arithmetic (``flash_wgmma_split``):
    S = the float32 sum of the products of the bf16 parts of q log2(e) /
    sqrt(hd) and of k (``pairs`` of ``BWD_PAIRS``, smallest first), in log2
    units, masked to -1e30; then ``_turns`` over tiles of ``block`` keys,
    each tile's P . V a fresh float32 sum of the products of p's and v's
    parts.  (o [B, Tq, H, hd], lse [B, H, Tq]) float32.  Tests only."""
    b, tq, h, hd = q.shape
    s2 = _split_product("bkgqh,bskh->bkgqs", _q_log2(q, k.shape[2]), k.float(), parts, pairs)
    s2 = _masked_log2(s2, q, k, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                      kv_len=kv_len)
    vf = v.float()

    def pv(p, n0):
        return _split_product("bkgqs,bskh->bkgqh", p, vf[:, n0:n0 + block], parts, pairs)

    first = _first_tiles(tq, h // k.shape[2], k.shape[1], causal=causal, window=int(window),
                         q_offset=int(q_offset), kv_len=kv_len, block=block)
    out, lse = _turns(s2, pv, block, first)
    return _unheads(out), lse.reshape(b, h, tq)


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
