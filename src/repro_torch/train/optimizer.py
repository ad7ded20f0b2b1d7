"""AdamW with WSD/cosine schedules and optional int8-quantized state — the
port of ``repro.train.optimizer``.

- cosine, WSD (warmup-stable-decay, the MiniCPM schedule) and constant
  learning rates, computed in float32 as the reference's jnp code does
  (each Python constant meets a float32 tensor, as a weakly typed scalar
  meets a float32 array in JAX);
- decoupled weight decay, global-norm clipping;
- int8 block-quantized first/second moments (block 256 along the last
  dimension, per-block float32 scales; round half to even in both packages).

Trees are nested dicts of tensors, walked in ``jax.tree_util``'s order
(``dist.treepath``), so the global norm sums its leaves in the reference's
order.  A rank whose ``DistContext`` carries spec trees holds the
``local_shard`` of every leaf and updates its own blocks
(``apply_updates(..., ctx=)``): AdamW is elementwise, except that an int8
moment's scale is the largest magnitude of its 256-wide block, and a shard
boundary may cut a block, or the scales be sharded otherwise than the
moment (``_ShardedBlocks``); the blocks' maxima are then combined over the
ranks, so every local block comes out as the whole update's.
``apply_updates`` updates the parameters and float32 moments **in
place** (the full-width state does not fit twice on the card) and returns
them; stacked leaves of at least 2^28 elements are updated one layer at a
time, as the reference's ``lax.scan`` does, to bound the float32 scratch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

import torch.nn.functional as F

from repro_torch.core.backends import direct
from repro_torch.dist import sharding, treepath
from repro_torch.dist.checkpoint import _axis_sizes, _shard_bounds


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"       # "cosine" | "wsd" | "constant"
    wsd_decay_frac: float = 0.1    # MiniCPM: last ~10% of steps decay
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"   # "float32" | "int8"


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor), a float32 0-d tensor."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        shape_fn = torch.ones_like(s)
    elif cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        shape_fn = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        t = torch.clamp((s - decay_start) / max(cfg.total_steps - decay_start, 1), 0, 1)
        shape_fn = torch.where(s < decay_start, 1.0,
                               cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1.0 - t))
    else:
        raise ValueError(f"unknown schedule {cfg.schedule}")
    return cfg.lr * warm * shape_fn


# ---------------------------------------------------------------------------
# int8 block quantization (for m/v moments)
# ---------------------------------------------------------------------------

_BLOCK = 256
_MIN_QUANT_SIZE = 4096  # small leaves (norms, scalars) stay f32
_CHUNK_THRESHOLD = 1 << 28  # elements: stacked leaves this large update per layer


def _quantizable(shape: tuple) -> bool:
    return math.prod(shape) >= _MIN_QUANT_SIZE and len(shape) >= 1 and shape[-1] % _BLOCK == 0


def _quantize(x: torch.Tensor) -> dict:
    """Parameter-shaped int8 blocks along the last dim + float32 scales
    [..., last / 256]."""
    blocks = x.reshape(x.shape[:-1] + (x.shape[-1] // _BLOCK, _BLOCK))
    scale = blocks.abs().amax(-1) / 127.0
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-12)).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale.float()}


def _dequantize(qs: dict, shape: tuple, dtype=torch.float32) -> torch.Tensor:
    q = qs["q"].reshape(shape[:-1] + (shape[-1] // _BLOCK, _BLOCK))
    return (q.float() * qs["scale"][..., None]).reshape(shape).to(dtype)


def _is_qdict(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


class _ShardedBlocks:
    """The int8 blocks of one moment leaf held as a rank's shards: ``q``
    under ``q_entries`` (the parameter's spec), ``scale`` under
    ``s_entries``, for a local block of ``local`` (its shape).  Exact: the
    scales of the blocks the rank's q touches come from the whole scale
    (gathered), and the new scales from the blocks' maxima combined over
    the ranks."""

    def __init__(self, ctx, local: tuple, q_entries: tuple, s_entries: tuple):
        self.ctx, self.q_entries, self.s_entries = ctx, q_entries, s_entries
        mesh = ctx.mesh
        sizes = _axis_sizes(mesh)
        coords = {a: direct.axis_index(a, mesh) for a in sizes}
        n = [math.prod(sizes[a] for a in sharding.axes_of(e)) for e in q_entries]
        self.shape = tuple(d * k for d, k in zip(local, n))  # the whole leaf
        self.bounds = _shard_bounds(self.shape, q_entries, sizes, coords)
        s_shape = self.shape[:-1] + (self.shape[-1] // _BLOCK,)
        self.s_bounds = _shard_bounds(s_shape, s_entries, sizes, coords)

    @staticmethod
    def aligned(local: tuple, q_entries: tuple, s_entries: tuple) -> bool:
        """Whether the rank's scale block is exactly that of its q block."""
        return q_entries == s_entries and (q_entries[-1] is None or local[-1] % _BLOCK == 0)

    def _gather(self, x: torch.Tensor, entries: tuple) -> torch.Tensor:
        for dim, entry in enumerate(entries):
            axes = sharding.axes_of(entry)
            if axes:
                x = direct.allgather(x, axes, dim=dim, mesh=self.ctx.mesh)
        return x

    def _scales_of_q(self, s_whole: torch.Tensor) -> torch.Tensor:
        """Each element of the rank's q block's scale, from the whole scale."""
        for dim, (lo, hi) in enumerate(self.bounds[:-1]):
            s_whole = s_whole.narrow(dim, lo, hi - lo)
        c0, c1 = self.bounds[-1]
        s = s_whole[..., c0 // _BLOCK: -(-c1 // _BLOCK)].repeat_interleave(_BLOCK, -1)
        return s[..., c0 % _BLOCK: c0 % _BLOCK + (c1 - c0)]

    def dequantize(self, md: dict) -> torch.Tensor:
        s_whole = self._gather(md["scale"], self.s_entries)
        return md["q"].float() * self._scales_of_q(s_whole)

    def quantize(self, m: torch.Tensor) -> dict:
        c0, c1 = self.bounds[-1]
        off, w = c0 % _BLOCK, c1 - c0
        nbl = -(-(off + w) // _BLOCK)
        part = F.pad(m.abs(), (off, nbl * _BLOCK - off - w))
        part = part.reshape(part.shape[:-1] + (nbl, _BLOCK)).amax(-1)  # blocks c0 // 256 ...
        for dim, entry in enumerate(self.q_entries[:-1]):
            axes = sharding.axes_of(entry)
            if axes:
                part = direct.allgather(part, axes, dim=dim, mesh=self.ctx.mesh)
        axes = sharding.axes_of(self.q_entries[-1])
        if axes:  # rank j's partial maxima start at block j w // 256; shared blocks take the max
            part = direct.allgather(part, axes, dim=-1 % part.dim(), mesh=self.ctx.mesh)
            ranks = part.shape[-1] // nbl
            first = torch.tensor([j * w // _BLOCK for j in range(ranks)], device=m.device)
            idx = (first[:, None] + torch.arange(nbl, device=m.device)).reshape(-1)
            whole = torch.zeros(part.shape[:-1] + (self.shape[-1] // _BLOCK,), dtype=part.dtype,
                                device=m.device)
            part = whole.scatter_reduce(-1, idx.expand(part.shape), part, "amax")
        s_whole = part / 127.0
        q = torch.round(m / torch.clamp(self._scales_of_q(s_whole), min=1e-12)).to(torch.int8)
        for dim, (lo, hi) in enumerate(self.s_bounds):
            s_whole = s_whole.narrow(dim, lo, hi - lo)
        return {"q": q, "scale": s_whole.float()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def init_state(params: Any, cfg: OptConfig) -> dict:
    def zeros_like_moment(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if cfg.state_dtype == "int8" and _quantizable(tuple(p.shape)) else z

    dev = treepath.leaves(params)[0].device
    return {
        "m": treepath.tree_map(zeros_like_moment, params),
        "v": treepath.tree_map(zeros_like_moment, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for g in treepath.leaves(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def _node(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _codec(ctx, path: tuple, moment: Any, local: tuple, layer: bool):
    """(dequantize, quantize) of an int8 moment leaf at ``path``: the plain
    block functions, or ``_ShardedBlocks``' where the rank's shards do not
    hold whole blocks of their own scales."""
    plain = (lambda md: _dequantize(md, local)), _quantize
    specs = getattr(ctx, "opt_specs", None) if ctx is not None else None
    if specs is None:
        return plain
    node = specs["m"]
    for k in path:
        node = node[k]
    q_e, s_e = (sharding._entries(node[k], len(local), layer) for k in ("q", "scale"))
    if _ShardedBlocks.aligned(local, q_e, s_e):
        return plain
    blocks = _ShardedBlocks(ctx, local, q_e, s_e)
    return blocks.dequantize, blocks.quantize


def apply_updates(params: Any, grads: Any, state: dict, cfg: OptConfig,
                  gnorm: torch.Tensor | None = None, ctx=None) -> tuple[Any, dict]:
    """One AdamW step; updates ``params`` and ``state`` in place and returns
    them (int8 moments are requantized in place).  ``gnorm``, the norm the
    clip reads, defaults to ``global_norm(grads)``; a rank holding a slice
    of a leaf passes the whole tree's.  ``ctx``: a ``DistContext`` whose
    spec trees say how the leaves are sharded (module doc)."""
    step = state["step"] + 1
    lr = lr_at(step, cfg)
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.beta1, sf)
    bc2 = 1.0 - torch.pow(cfg.beta2, sf)

    def upd(p, g, m, v, codec):
        """p and float32 m, v in place; returns the new (m, v)."""
        g = g.float() * clip
        m_f = codec[0](m) if _is_qdict(m) else m
        v_f = codec[0](v) if _is_qdict(v) else v
        m_f.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        v_f.mul_(cfg.beta2).add_((1 - cfg.beta2) * g.square())
        del g
        delta = m_f / bc1
        delta.div_(torch.sqrt(v_f / bc2).add_(cfg.eps)).add_(cfg.weight_decay * p.float())
        p.sub_(lr * delta)  # in float32, rounded to p's dtype
        return (codec[1](m_f) if _is_qdict(m) else m_f,
                codec[1](v_f) if _is_qdict(v) else v_f)

    def layer(x, i):
        return {k: t[i] for k, t in x.items()} if _is_qdict(x) else x[i]

    with torch.no_grad():
        for path, p in treepath.flatten_with_path(params):
            g, m, v = (_node(t, path) for t in (grads, state["m"], state["v"]))
            if p.dim() >= 3 and p.numel() >= _CHUNK_THRESHOLD:
                codec = _codec(ctx, path, m, tuple(p.shape[1:]), True) if _is_qdict(m) else None
                for i in range(p.shape[0]):  # one layer's float32 scratch at a time
                    for dst, new in zip((m, v), upd(p[i], g[i], layer(m, i), layer(v, i), codec)):
                        if _is_qdict(dst):  # float32 moments were updated in place
                            for k in dst:
                                dst[k][i] = new[k]
            else:
                codec = _codec(ctx, path, m, tuple(p.shape), False) if _is_qdict(m) else None
                for dst, new in zip((m, v), upd(p, g, m, v, codec)):
                    if _is_qdict(dst):  # float32 moments were updated in place
                        for k in dst:
                            dst[k].copy_(new[k])
    state["step"] = step
    return params, state


def state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in treepath.leaves(state))
