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
order.  ``apply_updates`` updates the parameters and float32 moments **in
place** (the full-width state does not fit twice on the card) and returns
them; stacked leaves of at least 2^28 elements are updated one layer at a
time, as the reference's ``lax.scan`` does, to bound the float32 scratch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.dist import treepath


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


def apply_updates(params: Any, grads: Any, state: dict, cfg: OptConfig,
                  gnorm: torch.Tensor | None = None) -> tuple[Any, dict]:
    """One AdamW step; updates ``params`` and ``state`` in place and returns
    them (int8 moments are requantized in place).  ``gnorm``, the norm the
    clip reads, defaults to ``global_norm(grads)``; a rank holding a slice
    of a leaf passes the whole tree's."""
    step = state["step"] + 1
    lr = lr_at(step, cfg)
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.beta1, sf)
    bc2 = 1.0 - torch.pow(cfg.beta2, sf)

    def upd(p, g, m, v):
        """p and float32 m, v in place; returns the new (m, v)."""
        g = g.float() * clip
        m_f = _dequantize(m, tuple(p.shape)) if _is_qdict(m) else m
        v_f = _dequantize(v, tuple(p.shape)) if _is_qdict(v) else v
        m_f.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        v_f.mul_(cfg.beta2).add_((1 - cfg.beta2) * g.square())
        del g
        delta = m_f / bc1
        delta.div_(torch.sqrt(v_f / bc2).add_(cfg.eps)).add_(cfg.weight_decay * p.float())
        p.sub_(lr * delta)  # in float32, rounded to p's dtype
        return (_quantize(m_f) if _is_qdict(m) else m_f,
                _quantize(v_f) if _is_qdict(v) else v_f)

    def layer(x, i):
        return {k: t[i] for k, t in x.items()} if _is_qdict(x) else x[i]

    with torch.no_grad():
        for path, p in treepath.flatten_with_path(params):
            g, m, v = (_node(t, path) for t in (grads, state["m"], state["v"]))
            if p.dim() >= 3 and p.numel() >= _CHUNK_THRESHOLD:
                for i in range(p.shape[0]):  # one layer's float32 scratch at a time
                    for dst, new in zip((m, v), upd(p[i], g[i], layer(m, i), layer(v, i))):
                        if _is_qdict(dst):  # float32 moments were updated in place
                            for k in dst:
                                dst[k][i] = new[k]
            else:
                for dst, new in zip((m, v), upd(p, g, m, v)):
                    if _is_qdict(dst):  # float32 moments were updated in place
                        for k in dst:
                            dst[k].copy_(new[k])
    state["step"] = step
    return params, state


def state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in treepath.leaves(state))
