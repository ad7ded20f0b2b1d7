"""Training step: loss -> grads (microbatched) -> AdamW update — the port of
``repro.train.train_step``.

The step runs eagerly.  Gradients land in stacked float32 buffers shaped
like the parameters: each layer's weights enter the graph as leaves that
are views of the stacked tensors (the subtrees ``api.stacked_subtrees``
names: each leaf a list of per-layer leaves), and each leaf's ``.grad`` is
preset to the matching view of the buffer, so autograd accumulates each
layer's gradient straight into it (a stacked leaf indexed per layer would
add a full-size gradient per layer instead).  A bfloat16 leaf (bf16 weight
storage) gets its gradient in bfloat16, as the reference's ``jax.grad``
does; it is added to the float32 buffer after each backward
(``g.astype(grad_dtype)``).  Microbatch gradients accumulate in the same
buffers, in the reference's order (0 + g1 + g2 ...), and are divided by the
count, as its ``lax.scan`` does.  The optimizer then updates the parameters
in place.

Data parallelism is explicit, on the mesh axes of
``core.backends.direct``: every rank runs the step on its own shard of the
batch.  ``make_train_step(ctx=...)`` reduces the ranks' gradients over
``ctx.dp_axes`` (``_reduce``; ``api.loss_fn`` makes each rank's the
dp-fold share of the global loss's gradient): a leaf every rank holds
whole is averaged, and a leaf a rank holds a shard of (MoE expert stacks
that hold only its slice of the experts, ``interop.expert_slice``; or,
with spec trees on the context, every leaf as its ``local_shard``,
gathered at use) is reduced by the rule in ``_reduce``, and its squares
summed over its shard axes for the clip's norm.  The optimizer then updates
the rank's blocks (``optimizer.apply_updates(..., ctx=)``).
``make_compressed_dp_train_step`` is the reference's explicit int8
reduction (``cfg.grad_compression``): each rank's gradient of its own
shard's loss crosses the wire as int8 + per-block scales
(``compression.compressed_pmean``) with its error-feedback residual kept
locally.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends import direct
from repro_torch.dist import compression, sharding, treepath
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as opt


def _graph_params(cfg: ArchConfig, params: dict, grads: dict) -> tuple[dict, list]:
    """``params`` as the forward's leaves, and the (leaf, buffer) pairs whose
    gradients are added to their buffers after a backward: top-level leaves
    as they are (on the same storage), the stacked subtrees' leaves as lists
    of per-layer views.  A leaf of the buffer's dtype has the buffer as its
    ``.grad``, so autograd accumulates into it."""
    pending = []

    def leaf(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        out = w.detach().requires_grad_()
        if w.dtype == g.dtype:
            out.grad = g
        else:
            pending.append((out, g))
        return out

    stacked = api.stacked_subtrees(cfg)
    out = {}
    for k, w in params.items():
        if k in stacked:
            out[k] = _zip_map(lambda w_, g_: [leaf(w_[i], g_[i]) for i in range(w_.shape[0])],
                              w, grads[k])
        else:
            out[k] = _zip_map(leaf, w, grads[k])
    return out, pending


def _zip_map(fn, tree, other):
    """``tree`` with ``fn(leaf, the same leaf of other)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _make_grads_of(cfg: ArchConfig, ctx, microbatches: int, grad_dtype):
    """grads_of(params, batch) -> (loss, metrics, grads)."""

    def grads_of(params, batch):
        grads = treepath.tree_map(lambda p: torch.zeros_like(p, dtype=grad_dtype), params)
        leaves, pending = _graph_params(cfg, params, grads)
        loss_sum, metrics = None, None
        for i in range(microbatches):
            mb = {k: x.reshape((microbatches, x.shape[0] // microbatches) + x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, metrics = api.loss_fn(cfg, leaves, mb, ctx=ctx)
            loss.backward()
            for leaf, g in pending:
                if leaf.grad is not None:
                    g.add_(leaf.grad)
                    leaf.grad = None
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        if microbatches == 1:
            return loss_sum, metrics, grads
        for g in treepath.leaves(grads):
            g.div_(microbatches)
        return loss_sum / microbatches, metrics, grads

    return grads_of


def _expert_slice_axes(cfg: ArchConfig, ctx, params: dict) -> tuple:
    """The ep axes when this rank's expert stacks (``blocks.moe.wi`` /
    ``wo``, [L, E, ...]) hold only its slice of the padded experts, else
    ()."""
    ep = ctx.ep_axis if ctx is not None and ctx.mesh is not None else None
    if ep is None or cfg.family != "moe":
        return ()
    if params["blocks"]["moe"]["wi"].shape[1] == cfg.num_experts_padded:
        return ()
    return tuple(ep) if isinstance(ep, (tuple, list)) else (ep,)


def _shard_axes(cfg: ArchConfig, ctx, params: dict) -> list[tuple[str, ...]]:
    """For each leaf of ``params`` (``treepath`` order), the mesh axes its
    rank's block is a shard over: every axis of its spec (in the mesh's
    order) where the context carries spec trees; else the ep axes for an
    expert slice (``interop.expert_slice``) and none for the rest."""
    specs = getattr(ctx, "param_specs", None) if ctx is not None else None
    if specs is not None:
        order = list(ctx.mesh.mesh_dim_names)
        return [tuple(sorted(sharding.spec_axes(sp), key=order.index))
                for sp in treepath.leaves(specs)]
    ep = _expert_slice_axes(cfg, ctx, params)
    return [ep if "moe" in path and path[-1] in ("wi", "wo") else ()
            for path, _ in treepath.flatten_with_path(params)]


def _reduce(grads: dict, axes: list, dp: tuple, mesh) -> torch.Tensor:
    """Reduce each rank's gradients over the dp axes; returns the global
    norm of the whole gradient.

    ``api.loss_fn`` makes each rank's gradient the dp-fold share of its
    shard's (``axes``: each leaf's shard axes, ``_shard_axes``).  A leaf
    held whole is averaged over the dp axes.  A shard over some dp axes G
    already holds the sum over G of the ranks' shares: the backward of its
    gather is a ``reduce_scatter`` over G (``sharding.use``), and an expert
    slice's owner received the rows of every rank of the ep axes
    (``moe._moe_ep``); so it is averaged over the other dp axes and divided
    by G's size.  A shard over other axes (tp) holds its piece of a
    gradient every rank of them computes alike.  The norm sums each block
    once: the squares of each leaf's block, summed over its shard axes."""
    sums: dict[tuple, torch.Tensor] = {}
    for g, own in zip(treepath.leaves(grads), axes):
        rest = tuple(a for a in dp if a not in own)
        if rest:
            g.copy_(direct.allreduce_mean(g, rest, mesh))
        over = tuple(a for a in own if a in dp)
        if over:
            g.div_(direct.axis_size(over, mesh))
        sums[own] = sums.get(own, 0) + g.float().square().sum()
    return torch.sqrt(sum(direct.allreduce(t, own, mesh) if own else t
                          for own, t in sums.items()))


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
        gnorm = _reduce(grads, _shard_axes(cfg, ctx, params), dp,
                        ctx.mesh if ctx is not None else None)
        params, opt_state = opt.apply_updates(params, grads, opt_state, opt_cfg, gnorm=gnorm,
                                              ctx=ctx)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
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
