"""Unified model API — the port of ``repro.models.api``, keyed off
``ArchConfig.family``: the transformer families (``dense``, ``vlm``,
``moe``), ``ssm`` (RWKV-6), ``hybrid`` (Griffin) and ``audio`` (Whisper):

- ``init_params(cfg, gen, device=None, master=False)``
- ``logits_fn(cfg, params, batch, ctx)``   -> (logits, aux)
- ``loss_fn(cfg, params, batch, ctx)``     -> (loss, {"ce", "aux"}) from
  float32 master weights (bfloat16 where ``cfg.param_dtype`` stores them):
  ``transformer.forward_train``, and for the other families their
  cache-free forwards, which cast in the graph and recompute per layer
- ``init_decode_state(cfg, batch, max_len, dtype, device=None)``
- ``prefill_fn(cfg, params, batch, state, ctx)``
- ``decode_fn(cfg, params, tokens, state, ctx)``

``batch`` dicts hold ``tokens`` (int32 [B, T]), for ``loss_fn`` a ``mask``
([B, T] float32), for vlm ``patches`` and for audio ``frames`` ([B, S_src,
d] float32).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed.nn.functional as dist_nn

from repro_torch.core.backends import direct
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.kernels.flash_attention import kernel as fa_k
from repro_torch.models import encdec, griffin, rwkv, transformer
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
_MODULES = {"ssm": rwkv, "hybrid": griffin, "audio": encdec}


def _module(cfg: ArchConfig):
    if cfg.family in _TRANSFORMER_FAMILIES:
        return transformer
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    raise ValueError(f"unknown family {cfg.family}")


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The narrowest type of the activations ``cfg``'s products read: float32
    for the transformer families and RWKV, ``cfg.dtype`` for Griffin and
    Whisper (on the card, bfloat16 needs ``layers.check_products``'s flag)."""
    return _module(cfg).compute_dtype(cfg)


def hold_leaf(cfg: ArchConfig, path: tuple[str, ...], t: torch.Tensor,
              master: bool = False) -> torch.Tensor:
    """Parameter leaf ``path`` (its keys; ``t`` in ``cfg.param_dtype``) in
    the type and rounding ``cfg``'s family holds it in (each module's
    ``hold_leaf``); ``master``: unrounded, as training's master weights."""
    return _module(cfg).hold_leaf(cfg, path, t, master)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict / tuple tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def check_card_head_dim(cfg: ArchConfig) -> None:
    """Raise before anything is allocated where the card has no attention
    kernel for ``cfg``'s head width (every config of the catalog has one)."""
    if cfg.family == "ssm":
        return
    hd = cfg.resolved_head_dim
    try:
        fa_k.kernel_head_dim(hd)
    except ValueError:
        raise NotImplementedError(f"{cfg.name}: head width {hd} has no flash-attention kernel on "
                                  f"the card") from None


def init_params(cfg: ArchConfig, gen: torch.Generator | None, device=None, *,
                master: bool = False) -> dict:
    """Parameters on ``device`` (default: the card; raises without one) drawn
    from ``gen``, which must live on that device.  ``device="meta"`` makes
    shapes only (``gen`` may be None).  Leaves are held as the family's
    products read them (``cfg.param_dtype`` storage; see each module);
    ``master``: unrounded master weights for training."""
    module = _module(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type == "cuda":
        check_card_head_dim(cfg)
    return module.init_params(cfg, gen, device=dev, master=master)


def logits_fn(cfg: ArchConfig, params: dict, batch: dict, ctx=None):
    """Full-sequence logits + aux loss (the MoE balance loss), family-dispatched."""
    tokens = batch["tokens"]
    module = _module(cfg)
    if module is transformer:
        return transformer.forward(cfg, params, tokens, prefix_embeds=batch.get("patches"),
                                   ctx=ctx)
    if module is encdec:
        return encdec.forward(cfg, params, tokens, batch["frames"], ctx=ctx)
    logits, aux, _ = module.forward(cfg, params, tokens, ctx=ctx)
    return logits, aux


def stacked_subtrees(cfg: ArchConfig) -> tuple[str, ...]:
    """The top-level keys of ``cfg``'s parameter tree whose leaves are
    stacked per layer along dim 0, [L, ...] (Griffin's ``group``: [G, ...]
    per pattern position)."""
    module = _module(cfg)
    if module is encdec:
        return ("encoder", "decoder")
    return ("group",) if module is griffin else ("blocks",)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, ctx=None):
    """CE of ``logits[:, :-1]`` against ``tokens[:, 1:]`` under ``mask[:, 1:]``
    plus the aux loss: (total, {"ce", "aux"}).

    With a ``ctx`` whose ``dp_axes`` name mesh axes, ``batch`` is this
    rank's shard and the loss is the reference's over the global batch:
    the masked-loss sum and the mask count are summed over the dp axes
    separately (a mean of the shards' means differs where their masks
    do), and the aux loss is the shards' mean.  The sums carry autograd
    (``torch.distributed.nn``: the backward sums the ranks' gradients too),
    so each rank's parameter gradients are dp times its share, and their
    mean over the dp axes (``train_step``) is the global gradient.  Where
    the logits are the rank's vocab block (``sharding.vocab_split``: the
    heads but Whisper's, where the rules split them), the terms are the
    vocabulary-parallel ones
    (``layers.vocab_parallel_cross_entropy_terms``), alike over tp."""
    module = _module(cfg)
    if module is transformer:
        logits, aux = transformer.forward_train(cfg, params, batch["tokens"],
                                                prefix_embeds=batch.get("patches"), ctx=ctx)
    elif module is encdec:  # the other families' forwards take master weights as they are
        logits, aux = encdec.forward(cfg, params, batch["tokens"], batch["frames"], ctx=ctx)
    else:
        logits, aux, _ = module.forward(cfg, params, batch["tokens"], ctx=ctx, gather=False)
    args = (logits[:, :-1], batch["tokens"][:, 1:], batch["mask"][:, 1:])
    # the rank's vocab block of the logits; Whisper's tied head is used whole
    if module is not encdec and sharding.vocab_split(ctx, params):
        total, count = L.vocab_parallel_cross_entropy_terms(*args, ctx.tp_axis, ctx.mesh)
    else:
        total, count = L.cross_entropy_terms(*args)
    if ctx is None or ctx.mesh is None or not ctx.dp_axes:
        loss = total / torch.clamp(count, min=1)
        return loss + aux, {"ce": loss, "aux": aux}
    group = direct.group(ctx.dp_axes, ctx.mesh)
    total = dist_nn.all_reduce(total, group=group)
    count = direct.allreduce(count.detach(), ctx.dp_axes, ctx.mesh)
    loss = total / torch.clamp(count, min=1)
    aux = dist_nn.all_reduce(aux, group=group) / direct.axis_size(ctx.dp_axes, ctx.mesh)
    return loss + aux, {"ce": loss, "aux": aux}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> Any:
    """The KV cache (transformer, audio), the recurrent state (ssm: float32,
    O(1) in ``max_len``) or both (hybrid), on ``device`` (default: the card)."""
    dev = resolve_device(device)
    module = _module(cfg)
    if module is rwkv:
        return rwkv.init_state(cfg, batch, device=dev)
    if module is griffin:
        return griffin.init_state(cfg, batch, max_len, dtype, device=dev)
    return module.init_cache(cfg, batch, max_len, dtype, device=dev)


def prefill_fn(cfg: ArchConfig, params: dict, batch: dict, state: Any, ctx=None):
    """Run the prompt into ``state``: (last-position logits [B, 1, V], state)."""
    tokens = batch["tokens"]
    module = _module(cfg)
    if module is transformer:
        return transformer.prefill(cfg, params, tokens, state,
                                   prefix_embeds=batch.get("patches"), ctx=ctx)
    if module is encdec:
        return encdec.prefill(cfg, params, tokens, batch["frames"], state, ctx=ctx)
    logits, _, st = module.forward(cfg, params, tokens, state=state, ctx=ctx, last_only=True)
    return logits, st


def decode_fn(cfg: ArchConfig, params: dict, tokens: torch.Tensor, state: Any, ctx=None):
    """One token per sequence: (logits [B, 1, V], state)."""
    return _module(cfg).decode_step(cfg, params, tokens, state, ctx=ctx)
