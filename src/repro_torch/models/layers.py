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

Tensor-parallel products (the reference's column / row / vocab rules, run
on the rank's block of each weight): ``column_parallel`` (input through
``copy_to_group``, Megatron's *f*), ``row_parallel`` (partial sums through
``direct.allreduce_alike``, *g*), ``split_to_group``, the gated MLP's
``gate_up_exchange``, ``embed_parallel`` and
``vocab_parallel_cross_entropy_terms``; :class:`TP` binds them to one
axis (or none) for the families that split per head or channel.  Their convention: an activation
is alike on every rank of the axis, and so is its cotangent, which is the
whole one; a rank-local block's cotangent is the whole one of that block.
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


class _SplitToGroup(torch.autograd.Function):
    """The rank's block of the last dim of a tensor every rank of ``axis``
    holds alike; the backward all-gathers the ranks' cotangent blocks (each
    rank's is the whole one of its block), so every rank gets the whole
    cotangent."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        p, r = direct.axis_size(axis, mesh), direct.axis_index(axis, mesh)
        n = x.shape[-1] // p
        ctx.args = (axis, mesh)
        return x[..., r * n:(r + 1) * n]

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.args
        return direct.allgather_alike(g, axis, dim=-1, mesh=mesh), None, None


def split_to_group(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """``x``, held alike by every rank of ``axis``, narrowed to the rank's
    block of its last dim (Megatron's *scatter*), for a computation each
    rank runs on its own block."""
    return _SplitToGroup.apply(x, axis, mesh)


def column_parallel(y: torch.Tensor, w_local: torch.Tensor, axis, mesh) -> torch.Tensor:
    """The rank's output columns of ``y @ w`` from its column block
    ``w_local`` of ``w`` (the reference's column-parallel product); ``y``,
    alike on every rank of ``axis``, goes through :func:`copy_to_group`.
    Callers that run several such products on one ``y`` copy it once."""
    return copy_to_group(y, axis, mesh) @ w_local


def row_parallel(x_local: torch.Tensor, w_local: torch.Tensor, axis, mesh) -> torch.Tensor:
    """``x @ w`` from the rank's row block ``w_local`` of ``w`` and its
    matching columns ``x_local`` of ``x``: the ranks' partial products
    summed over ``axis`` (``direct.allreduce_alike``), alike on every rank."""
    return direct.allreduce_alike(x_local @ w_local, axis, mesh)


class TP:
    """The pieces above bound to one tensor-parallel axis ``axis`` of
    ``mesh``, or to none (``TP()``): then every method is the whole
    computation's identity (and ``size`` 1, ``rank`` 0), so that one code
    path runs a layer split over the axis or whole.  The families whose
    products split per head or channel (RWKV-6, Griffin, Whisper) use it."""

    def __init__(self, axis=None, mesh=None):
        self.axis, self.mesh = axis, mesh
        self.size = 1 if axis is None else direct.axis_size(axis, mesh)
        self.rank = 0 if axis is None else direct.axis_index(axis, mesh)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`copy_to_group`."""
        return x if self.axis is None else copy_to_group(x, self.axis, self.mesh)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`split_to_group`: the rank's block of the last dim."""
        return x if self.axis is None else split_to_group(x, self.axis, self.mesh)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums, summed (*g*)."""
        return x if self.axis is None else direct.allreduce_alike(x, self.axis, self.mesh)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' blocks along ``dim``, all-gathered into a tensor every
        rank then computes alike from (``direct.allgather_alike``)."""
        if self.axis is None:
            return x
        return direct.allgather_alike(x.contiguous(), self.axis, dim=dim, mesh=self.mesh)

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's block of ``dim`` (a view; a state leaf, not a graph
        input)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


def gate_up_exchange(gu_local: torch.Tensor, axis, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(gate, up), each the rank's ff / P columns, from its block of a fused
    ``gate || up`` product ([.., 2 ff] split into P contiguous column blocks
    of 2 ff / P over ``axis``).  Block s is two ff / P halves: half j holds
    columns [(2s + j) ff / P, ...) of ``gate || up``, so it is rank (2s + j)'s
    gate where 2s + j < P and rank (2s + j - P)'s up else.  Four partial
    ``ppermute``s (each rank receives at most once in each) move each half
    to its rank; a rank's gate (its up) is the sum of what it received in
    the two gate (up) rounds, the other being zeros.  The backward sends the
    cotangents back along the same pairs."""
    p = direct.axis_size(axis, mesh)
    w = gu_local.shape[-1] // 2
    halves = gu_local[..., :w].contiguous(), gu_local[..., w:].contiguous()

    def gather(up: bool) -> torch.Tensor:
        return sum(direct.ppermute(halves[j], axis, [(s, 2 * s + j - p * up) for s in range(p)
                                                     if (2 * s + j >= p) == up], mesh)
                   for j in (0, 1))

    return gather(False), gather(True)


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """The gated MLP's activation: SiLU or :func:`gelu`."""
    return F.silu(x) if name == "silu" else gelu(x)


def gated_mlp_parallel(y: torch.Tensor, wi_local: torch.Tensor, wo_local: torch.Tensor, axis,
                       mesh, act: str = "silu") -> torch.Tensor:
    """:func:`gated_mlp` with ``wi``'s columns and ``wo``'s rows split over
    ``axis`` (P ranks, P dividing ff): the column-parallel ``gate || up``
    block, :func:`gate_up_exchange` to the rank's own gate and up columns,
    and the row-parallel ``wo``."""
    gate, up = gate_up_exchange(column_parallel(y, wi_local, axis, mesh), axis, mesh)
    return row_parallel(activation(gate, act) * up, wo_local, axis, mesh)


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


def head_block(h: int, tps: int, rank: int) -> tuple[int, int]:
    """Tp rank ``rank``'s q heads [first, end) where ``h`` heads split over
    ``tps`` ranks: a contiguous block of ceil(h / tps) whole heads from head
    rank x ceil(h / tps), cut at the last head, so that a rank past it has
    none (where tps divides h, the heads of a column-parallel ``wq``)."""
    c = -(-h // tps)
    return min(rank * c, h), min((rank + 1) * c, h)


def attention_island(q_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rank: int, tps: int,
                     *, plan: str, h: int | None = None, causal: bool = True, window: int = 0,
                     softcap: float = 0.0, q_offset: int = 0, kv_len: int | None = None,
                     kv_local: bool = False) -> torch.Tensor:
    """Tp rank ``rank``'s island of :func:`attention_sharded`: a plain local
    attention call, no collective.  ``q_l`` is the rank's piece of q (plan
    ``"head"``: its :func:`head_block` of the ``h`` heads, by default
    ``q_l``'s heads x tp; ``"seq"``: its T / tp rows), k and v the whole
    (replicated) tensors, or with ``kv_local`` (plan ``"head"``) the rank's
    equal share of the kv heads.  A head split reads the kv heads its q
    heads map to by the reference's island rule (q head i reads kv head
    i // (h / kv heads); a contiguous slice, no copy), and raises where they
    are not among those held or the kernel's grouping of the island would
    pair them otherwise; its output has ceil(h / tp) heads, zero past the
    rank's own (no call on a rank past the last head).  A sequence split
    offsets the positions by the piece's first row, so it attends at
    ``q_offset + rank x T / tp`` over every key (the backward at a query
    offset, Tq < Tk)."""
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len)
    if plan == "seq":
        return attention(q_l, k, v, q_offset=q_offset + rank * q_l.shape[1], **kw)
    h = h or q_l.shape[2] * tps
    h0, h1 = head_block(h, tps, rank)
    if q_l.shape[2] != h1 - h0:
        raise ValueError(f"attention_island: {q_l.shape[2]} q heads, not heads {h0}..{h1 - 1}")
    kv0 = rank * k.shape[2] if kv_local else 0
    g = h // (k.shape[2] * (tps if kv_local else 1))
    idx = [i // g - kv0 for i in range(h0, h1)]   # the kv heads read, as held
    c = -(-h // tps)
    if not idx:
        return q_l.new_zeros(q_l.shape[0], q_l.shape[1], c, q_l.shape[3])
    n = idx[-1] - idx[0] + 1
    if idx[0] < 0 or idx[-1] >= k.shape[2] or any(idx[0] + j // (len(idx) // n) != i
                                                    for j, i in enumerate(idx)):
        raise ValueError(f"attention_island: q heads {h0}..{h1 - 1} read kv heads "
                         f"{[i + kv0 for i in idx]}: not a grouping of the {k.shape[2]} held "
                         f"from kv head {kv0}")
    out = attention(q_l, k[:, :, idx[0]:idx[0] + n], v[:, :, idx[0]:idx[0] + n],
                    q_offset=q_offset, **kw)
    return F.pad(out, (0, 0, 0, c - len(idx))) if len(idx) < c else out


def attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ctx, *,
                      causal: bool = True, window: int = 0, softcap: float = 0.0,
                      q_offset: int = 0, kv_len: int | None = None, q_local: bool = False,
                      kv_local: bool = False, out_local: bool = False) -> torch.Tensor:
    """Attention split over the tensor-parallel axis ``ctx.tp_axis``: each tp
    rank runs a fully local flash island on its heads (``"head"``) or its
    rows (``"seq"``, context-parallel: k/v whole, positions offset), then
    the islands' outputs are all-gathered (``shard_plan`` chooses, as the
    reference does).  Every rank of the tp axis holds the same q, k, v (the
    activations are replicated over it); the gradients reach every rank
    whole (the copy's backward sums the islands' pieces).  The reference's
    ``b % dp`` condition has no counterpart: a rank already holds only its
    dp shard of the batch.  Without a tp axis of size > 1 in the mesh, or
    with no admissible split, this is :func:`attention`.

    Tensor-parallel callers: ``q_local``, q is already the rank's H / tp
    heads (plan ``"head"``, a column-parallel product's whole heads), taken
    as the island's piece with no copy and no narrow; ``kv_local``, so are
    k and v (the kv heads those map to).  ``out_local``: the result is the
    rank's block of the output's flattened heads, [B, T, H hd / tp], the
    rows a row-parallel output projection takes, in place of the whole
    output: the head island's output as it is, the sequence islands' by an
    all-to-all, a whole output by :func:`split_to_group`."""
    mesh, tp = ctx.mesh, ctx.tp_axis
    tps = direct.axis_size(tp, mesh) if mesh is not None and tp in mesh.mesh_dim_names else 1
    h = q.shape[2] * (tps if q_local else 1)
    kvh = k.shape[2] * (tps if kv_local else 1)
    plan = shard_plan(h, kvh, q.shape[1], tps) if tps > 1 else None
    if (q_local or kv_local) and plan != "head":
        raise ValueError(f"attention_sharded: local heads need the head split, not {plan}")
    if kv_local and not q_local:
        raise ValueError("attention_sharded: local k/v heads need local q heads")
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    if plan is None:
        out = attention(q, k, v, **kw)
        return split_to_group(out.flatten(2), tp, mesh) if out_local and tps > 1 else out
    rank = direct.axis_index(tp, mesh)
    dim = 2 if plan == "head" else 1
    if not kv_local:
        k, v = copy_to_group(k, tp, mesh), copy_to_group(v, tp, mesh)
    if not q_local:
        n = q.shape[dim] // tps
        q = copy_to_group(q, tp, mesh).narrow(dim, rank * n, n)
    out = attention_island(q, k, v, rank, tps, plan=plan, kv_local=kv_local, **kw)
    if not out_local:
        return direct.allgather_alike(out.contiguous(), tp, dim=dim, mesh=mesh)
    if plan == "head":
        return out.flatten(2)
    return direct.alltoall(out.flatten(2), tp, split_dim=2, concat_dim=1, mesh=mesh)


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
    return gated_down(x @ wi, wo, act)


def gated_down(gu: torch.Tensor, wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP after its fused product: act(gate) * up of ``gu`` =
    gate || up [..., 2*ff], times wo [ff, d]."""
    ff = wo.shape[0]
    return (activation(gu[..., :ff], act) * gu[..., ff:]) @ wo


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False) -> torch.Tensor:
    """Rows of ``table``; ``scale`` multiplies by sqrt(d) in float32 (the
    reference's numpy scalar promotes a bfloat16 table to float32)."""
    x = table[tokens]
    if scale:
        x = x.float() * np.float32(np.sqrt(table.shape[-1])).item()
    return x


def head_parallel(x: torch.Tensor, head_local: torch.Tensor, axis, mesh,
                  gather: bool = True) -> torch.Tensor:
    """The rank's vocab block of the logits from its column block
    ``head_local`` of the head (:func:`column_parallel`), all-gathered over
    ``axis`` into the whole logits where ``gather`` (serving)."""
    logits = column_parallel(x, head_local, axis, mesh)
    return direct.allgather_alike(logits, axis, dim=-1, mesh=mesh) if gather else logits


def _vocab_block(ids: torch.Tensor, n: int, axis, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(each id's row in the rank's block of ``n`` vocab rows over ``axis``,
    0 where the block does not hold it; whether it does)."""
    local = ids.long() - direct.axis_index(axis, mesh) * n
    inside = (local >= 0) & (local < n)
    return torch.where(inside, local, 0), inside


def embed_parallel(tokens: torch.Tensor, table_local: torch.Tensor, axis, mesh,
                   scale: bool = False) -> torch.Tensor:
    """:func:`embed` from the rank's block of a table whose vocab rows split
    over ``axis`` (rank r holds rows [r V / P, (r + 1) V / P)): each rank
    takes the rows its block holds and zeros for the other tokens, in
    float32 (a bfloat16 row's value is exact there), and the ranks' rows
    are summed (``direct.allreduce_alike``: one term of each sum is not
    zero, so the sum is that row)."""
    local, inside = _vocab_block(tokens, table_local.shape[0], axis, mesh)
    rows = table_local[local].float()
    x = direct.allreduce_alike(torch.where(inside[..., None], rows, 0.0), axis, mesh)
    if scale:
        x = x * np.float32(np.sqrt(table_local.shape[-1])).item()
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


def vocab_parallel_cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                                       mask: torch.Tensor | None, axis, mesh,
                                       z_coef: float = 1e-4) -> tuple[torch.Tensor,
                                                                      torch.Tensor | int]:
    """:func:`cross_entropy_terms` from the rank's block of the logits, whose
    vocab columns split over ``axis`` (rank r holds [r V / P, (r + 1) V /
    P)), in float32: the max over the ranks (``direct.allreduce_max``, held
    constant: the log-sum-exp's value and gradient do not depend on it), the
    sum of the exponentials and the label's logit (the rank that holds it;
    zeros elsewhere) summed over them with ``direct.allreduce_alike``.  The
    terms are alike on every rank; the gradient of the rank's logits is its
    columns of the whole one (softmax minus one-hot, the z-loss's factor)."""
    lf = logits.float()
    m = direct.allreduce_max(lf.detach().amax(-1), axis, mesh)
    se = direct.allreduce_alike(torch.exp(lf - m[..., None]).sum(-1), axis, mesh)
    lse = m + torch.log(se)
    local, inside = _vocab_block(labels, lf.shape[-1], axis, mesh)
    ll = torch.take_along_dim(lf, local[..., None], dim=-1)[..., 0]
    ll = direct.allreduce_alike(torch.where(inside, ll, 0.0), axis, mesh)
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
