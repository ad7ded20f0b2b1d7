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

Data parallelism is explicit, on the mesh axes of
``core.backends.direct``: every rank runs the step on its own shard of the
batch, with the same parameters and optimizer state.
``make_train_step(ctx=...)`` averages the ranks' gradients over
``ctx.dp_axes`` (``allreduce_mean``; ``api.loss_fn`` makes each rank's the
dp-fold share of the global loss's gradient).
``make_compressed_dp_train_step`` is the reference's explicit int8
reduction (``cfg.grad_compression``): each rank's gradient of its own
shard's loss crosses the wire as int8 + per-block scales
(``compression.compressed_pmean``) with its error-feedback residual kept
locally.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends import direct
from repro_torch.dist import compression, treepath
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
    metrics); params and opt_state are updated in place.  With a ``ctx``
    whose ``dp_axes`` name mesh axes, ``batch`` is this rank's shard; the
    loss and metrics are the global batch's and the gradients are averaged
    over the dp axes before the update, so every rank updates alike."""
    grads_of = _make_grads_of(cfg, ctx, microbatches, grad_dtype)
    dp = ctx.dp_axes if ctx is not None and ctx.mesh is not None else ()

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        for g in treepath.leaves(grads) if dp else ():
            g.copy_(direct.allreduce_mean(g, dp, ctx.mesh))
        params, opt_state = opt.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = opt.global_norm(grads)
        return params, opt_state, metrics

    return train_step


def make_compressed_dp_train_step(
    cfg: ArchConfig,
    opt_cfg: opt.OptConfig,
    mesh,
    dp_axis: str = "data",
    microbatches: int = 1,
    grad_dtype=torch.float32,
):
    """Explicit compressed dp-reduction step (``cfg.grad_compression``).

    Every rank of ``dp_axis`` takes the global batch, keeps its slice of the
    leading dim (which must divide the axis size), computes its own loss and
    gradients, and reduces each gradient leaf with
    :func:`compression.compressed_pmean` (int8 + per-block scales on the
    wire, the error feedback local); the mean, the same on every rank, feeds
    the same optimizer update everywhere.  Metrics are the ranks' mean.

    Returns ``(step_fn, init_err)``, as the reference does:

    - ``step_fn(params, opt_state, err, batch) -> (params, opt_state, err,
      metrics)``: params, opt_state and ``err`` updated in place; ``err`` is
      this rank's residual tree (the reference stacks every rank's,
      ``[world, ...]``; here each rank holds its own);
    - ``init_err(params)``: float32 zeros shaped like ``params``.
    """
    if cfg.grad_compression is False:
        raise ValueError("make_compressed_dp_train_step requires cfg.grad_compression")
    world = direct.axis_size(dp_axis, mesh)
    rank = direct.axis_index(dp_axis, mesh)
    grads_of = _make_grads_of(cfg, None, microbatches, grad_dtype)

    def local(batch):
        def piece(x):
            if x.shape[0] % world:
                raise ValueError(f"global batch {x.shape[0]} not divisible by dp={world}")
            n = x.shape[0] // world
            return x[rank * n:(rank + 1) * n]
        return {k: piece(x) for k, x in batch.items()}

    def step_fn(params, opt_state, err, batch):
        loss, metrics, grads = grads_of(params, local(batch))
        for g, e in zip(treepath.leaves(grads), treepath.leaves(err)):
            mean, new_e = compression.compressed_pmean(g, dp_axis, e, mesh=mesh)
            g.copy_(mean)
            e.copy_(new_e)
        params, opt_state = opt.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = {**metrics, "loss": loss}
        metrics = {k: direct.allreduce_mean(m, dp_axis, mesh) for k, m in metrics.items()}
        metrics["grad_norm"] = opt.global_norm(grads)
        return params, opt_state, err, metrics

    def init_err(params):
        return treepath.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    return step_fn, init_err


def make_eval_step(cfg: ArchConfig, ctx=None):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = api.loss_fn(cfg, params, batch, ctx=ctx)
        return {**metrics, "loss": loss}

    return eval_step
