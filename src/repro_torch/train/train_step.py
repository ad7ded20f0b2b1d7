"""Training step: loss -> grads (microbatched) -> AdamW update — the port of
``repro.train.train_step``.

The step runs eagerly.  Gradients land in stacked float32 buffers shaped
like the parameters: each layer's weights enter the graph as leaves that
are views of the stacked tensors, and each leaf's ``.grad`` is preset to the
matching view of the buffer, so autograd accumulates each layer's gradient
straight into it (a stacked leaf indexed per layer would add a full-size
gradient per layer instead).  Microbatch gradients accumulate in the same
buffers, in the reference's order (0 + g1 + g2 ...), and are divided by the
count, as its ``lax.scan`` does.  The optimizer then updates the parameters
in place.
"""

from __future__ import annotations

import torch

from repro_torch.dist import treepath
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as opt


def _leaf(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A graph leaf viewing ``w`` whose gradient accumulates into ``g``."""
    leaf = w.detach().requires_grad_()
    leaf.grad = g
    return leaf


def _graph_params(params: dict, grads: dict) -> dict:
    """``params`` as the forward's leaves: top-level leaves as they are (on
    the same storage), blocks as a list of per-layer dicts of views."""
    out = {k: _leaf(w, grads[k]) for k, w in params.items() if k != "blocks"}
    blocks = params["blocks"]
    n = next(iter(blocks.values())).shape[0]
    out["blocks"] = [{name: _leaf(w[i], grads["blocks"][name][i]) for name, w in blocks.items()}
                     for i in range(n)]
    return out


def _make_grads_of(cfg: ArchConfig, ctx, microbatches: int, grad_dtype):
    """grads_of(params, batch) -> (loss, metrics, grads)."""

    def grads_of(params, batch):
        grads = treepath.tree_map(lambda p: torch.zeros_like(p, dtype=grad_dtype), params)
        leaves = _graph_params(params, grads)
        loss_sum, metrics = None, None
        for i in range(microbatches):
            mb = {k: x.reshape((microbatches, x.shape[0] // microbatches) + x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, metrics = api.loss_fn(cfg, leaves, mb, ctx=ctx)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        if microbatches == 1:
            return loss_sum, metrics, grads
        for g in treepath.leaves(grads):
            g.div_(microbatches)
        return loss_sum / microbatches, metrics, grads

    return grads_of


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: opt.OptConfig,
    ctx=None,
    microbatches: int = 1,
    grad_dtype=torch.float32,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and opt_state are updated in place."""
    if ctx is not None:
        raise NotImplementedError("DistContext (sharded execution) is not ported (ROADMAP A 5)")
    grads_of = _make_grads_of(cfg, ctx, microbatches, grad_dtype)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        params, opt_state = opt.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = opt.global_norm(grads)
        return params, opt_state, metrics

    return train_step


def make_compressed_dp_train_step(*args, **kwargs):
    """The explicit compressed data-parallel step of the reference (int8 +
    error feedback on the dp all-reduce) needs the SPMD surface."""
    raise NotImplementedError("make_compressed_dp_train_step is not ported yet (ROADMAP "
                              "A 6, after the SPMD surface A 5)")


def make_eval_step(cfg: ArchConfig, ctx=None):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = api.loss_fn(cfg, params, batch, ctx=ctx)
        return {**metrics, "loss": loss}

    return eval_step
