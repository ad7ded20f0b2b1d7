"""Unified model API — the port of ``repro.models.api`` for the families
ported so far (``dense`` and ``vlm``; the others raise
``NotImplementedError`` naming their ROADMAP item):

- ``init_params(cfg, gen, device=None, master=False)``
- ``logits_fn(cfg, params, batch, ctx)``   -> (logits, aux)
- ``loss_fn(cfg, params, batch, ctx)``     -> (loss, {"ce", "aux"}), from
  float32 master weights (``transformer.forward_train``)
- ``init_decode_state(cfg, batch, max_len, dtype, device=None)``
- ``prefill_fn(cfg, params, batch, state, ctx)``
- ``decode_fn(cfg, params, tokens, state, ctx)``

``batch`` dicts hold ``tokens`` (int32 [B, T]), for ``loss_fn`` a ``mask``
([B, T] float32) and, for vlm, ``patches``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig

_TRANSFORMER_FAMILIES = ("dense", "vlm")
_NOT_PORTED = {
    "moe": "ROADMAP A 7 (models/moe.py)",
    "ssm": "ROADMAP A 7 (models/rwkv.py)",
    "hybrid": "ROADMAP A 7 (models/griffin.py)",
    "audio": "ROADMAP A 7 (models/encdec.py)",
}


def _family(cfg: ArchConfig) -> None:
    if cfg.family in _TRANSFORMER_FAMILIES:
        return
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: {_NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device=None, *,
                master: bool = False) -> dict:
    """Parameters on ``device`` (default: the card; raises without one) drawn
    from ``gen``, which must live on that device.  ``device="meta"`` makes
    shapes only (``gen`` may be None).  ``master``: unrounded float32 master
    weights for training; the default rounds matrix weights for serving."""
    _family(cfg)
    if cfg.param_dtype != "float32":
        raise NotImplementedError("bfloat16 weight storage is not ported (ROADMAP A 6)")
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    return transformer.init_params(cfg, gen, device=dev, master=master)


def logits_fn(cfg: ArchConfig, params: dict, batch: dict, ctx=None):
    """Full-sequence logits + aux loss, family-dispatched."""
    _family(cfg)
    return transformer.forward(cfg, params, batch["tokens"], prefix_embeds=batch.get("patches"),
                               ctx=ctx)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, ctx=None):
    """CE of ``logits[:, :-1]`` against ``tokens[:, 1:]`` under ``mask[:, 1:]``
    plus the aux loss: (total, {"ce", "aux"})."""
    _family(cfg)
    logits, aux = transformer.forward_train(cfg, params, batch["tokens"],
                                            prefix_embeds=batch.get("patches"), ctx=ctx)
    loss = L.cross_entropy(logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])
    return loss + aux, {"ce": loss, "aux": aux}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> Any:
    _family(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device=resolve_device(device))


def prefill_fn(cfg: ArchConfig, params: dict, batch: dict, state: Any, ctx=None):
    _family(cfg)
    return transformer.prefill(cfg, params, batch["tokens"], state,
                               prefix_embeds=batch.get("patches"), ctx=ctx)


def decode_fn(cfg: ArchConfig, params: dict, tokens: torch.Tensor, state: Any, ctx=None):
    _family(cfg)
    return transformer.decode_step(cfg, params, tokens, state, ctx=ctx)
