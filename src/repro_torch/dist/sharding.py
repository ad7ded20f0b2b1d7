"""Sharding rules: config + shapes -> PartitionSpec trees — the port of
``repro.dist.sharding``.

One rule engine covers all ten architectures and the optimizer state that
mirrors them.  Placement is name-driven (Megatron conventions) and every
proposed axis is divisibility-checked against the actual dim, so a rule
that doesn't apply to a given family/config silently degrades to
replication instead of producing an invalid spec:

- column-parallel (``wq``/``wk``/``wi``/...): last dim over 'model'
- row-parallel (``wo``/``cv``/``xo``/...):    second-to-last dim over 'model'
- MoE expert tensors: expert dim over the *joint* ('data','model') EP axis
  (experts are padded so E divides the joint axis)
- embeddings: vocab over 'model' when divisible, else replicated
- norms / gates / scalars: replicated
- ZeRO (``cfg.zero_partition``): the largest still-unsharded non-layer dim
  of every large tensor additionally shards over the dp axes, which is what
  lets the int8 optimizer state of a 1T-param tree fit 16 GB chips.

Optimizer-state trees reuse these rules verbatim: ``m``/``v`` mirror the
parameter shapes (int8 moments keep the param shape for ``q`` and get the
trailing dim divided by the block for ``scale`` — the divisibility check
re-derives the right spec), so ZeRO partitioning falls out here rather than
being special-cased in the optimizer.

A mesh is any of: an :class:`AbstractMesh` (names and sizes, no devices —
``launch.mesh.make_production_mesh``), a
``torch.distributed.device_mesh.DeviceMesh``, or a plain ``{name: size}``
mapping.  Trees are nested dicts / lists / tuples walked in
``jax.tree_util``'s order (``dist.treepath``); a :class:`PartitionSpec` is a
leaf of such a tree.  :func:`shardings_for` turns specs into DTensor
placements and :func:`local_shard` cuts the block a rank holds, the block
``dist.checkpoint.restore_sharded`` restores.

Gather at use (:func:`use`, :func:`use_state`, :func:`own_state`) is the
per-rank program's counterpart of the reference's ``jit(in_shardings=...)``:
a rank whose ``DistContext`` carries spec trees holds each leaf of its
parameters, optimizer state and decode state as its ``local_shard`` and
all-gathers a leaf's sharded dims just before the leaf is used, over each
dim's axes in ``_shard_bounds``' row-major order.  Three kinds of sharded
dim stay local, because the rank's own computation splits them along the
same axes: the batch dim of a decode state over the dp axes, the expert dim
of the MoE stacks over ``ctx.ep_axis`` (what ``moe._moe_ep`` consumes), and
the tp dim of the leaves a caller runs tensor-parallel products on
(``use(..., keep_tp=)``, each leaf's role from its spec: :func:`tp_role`;
a layer's whole set of them: :func:`tp_roles`), and of a decode state's
head dim that such products make and read as the rank's heads
(``use_state(..., keep_tp=True)``, Whisper's caches).  A
gather over dp axes (ZeRO) has the ``reduce_scatter`` of the ranks'
cotangents as its backward (``direct.allgather``); one over other axes,
whose activations are replicated, keeps the rank's own piece
(``direct.allgather_alike``).  Without specs on the context every helper
hands its argument back as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch.core.backends import direct
from repro_torch.dist import treepath
from repro_torch.dist.checkpoint import _axis_sizes, _shard_bounds

if TYPE_CHECKING:  # the rules read a config; importing the model zoo is not needed
    from repro_torch.models.config import ArchConfig

# parameter-name placement tables (shared across families; names that only
# exist in some families are simply never looked up for the others)
_COL_PARALLEL = {
    # transformer / encdec / griffin attention + MLPs
    "wq", "wk", "wv", "wi", "wi_sh", "xq", "xk", "xv",
    # rwkv time-mix / channel-mix
    "wr", "wg", "wA", "ck", "cr",
    # griffin recurrent branch
    "w_in", "w_gate", "wa", "wi_g", "conv_w",
    # routers / heads
    "router", "lm_head",
}
_ROW_PARALLEL = {
    "wo", "wo_att", "wo_a", "wo_m", "wo_sh", "wo_x", "xo", "cv", "wB", "w_out",
}
_EXPERT = {"wi", "wo"}  # under a "moe" path component
# optimizer-state / quantization wrappers whose name is not the rule key
_WRAPPERS = {"m", "v", "q", "scale"}

_ZERO_MIN_SIZE = 1 << 16  # don't bother dp-sharding small tensors


class PartitionSpec:
    """One entry per leading dim: ``None`` (whole), a mesh axis name, or a
    tuple of names (a joint axis, the first slowest); dims past the last
    entry are whole.  ``tuple(spec)`` is the reference's ``tuple(P(...))``.
    Not a tuple itself, so a spec tree walks as a tree of leaves."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes with no devices behind it (the
    reference's ``jax.sharding.AbstractMesh(sizes, names)``)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axes(mesh) -> tuple[tuple[str, ...], str]:
    """(dp_axes, tp_axis) for a production mesh.

    'model' is tensor-parallel; every other axis (incl. 'pod') is data
    parallel. Falls back to last-axis-is-tp for unnamed conventions.
    """
    names = tuple(_axis_sizes(mesh))
    tp = "model" if "model" in names else names[-1]
    dp = tuple(n for n in names if n != tp)
    return dp, tp


def ep_axes(cfg: ArchConfig, mesh) -> tuple[str, ...]:
    """Joint expert-parallel axes: dp (minus 'pod') + tp."""
    dp, tp = mesh_axes(mesh)
    return tuple(a for a in dp if a != "pod") + (tp,)


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape; a host scalar (a decode state's ``len``) is 0-d."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _rule_name(names: list[str]) -> str:
    """Innermost path component that names a parameter (skips m/v/q/scale
    optimizer wrappers and tuple indices)."""
    for n in reversed(names):
        if n in _WRAPPERS or n.isdigit():
            continue
        return n
    return names[-1] if names else ""


def _joint(axes: tuple[str, ...]):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _divides(dim: int, axes, sizes: dict[str, int]) -> bool:
    names = axes if isinstance(axes, tuple) else (axes,)
    return dim % math.prod(sizes[a] for a in names) == 0


def _leaf_spec(
    names: list[str],
    shape: tuple[int, ...],
    sizes: dict[str, int],
    dp: tuple[str, ...],
    tp: str,
    ep: tuple[str, ...],
    cfg: ArchConfig,
) -> PartitionSpec:
    ndim = len(shape)
    if ndim == 0:
        return PartitionSpec()
    dims: list[Any] = [None] * ndim
    name = _rule_name(names)
    in_moe = "moe" in names
    size = math.prod(shape)

    if in_moe and name in _EXPERT and ndim >= 3:
        # stacked expert tensor [L, E, ...]: expert dim on the joint EP axis
        e_dim = 1
        joint_ep = _joint(ep)
        if joint_ep is not None and _divides(shape[e_dim], joint_ep, sizes):
            dims[e_dim] = joint_ep
        elif _divides(shape[e_dim], tp, sizes):
            dims[e_dim] = tp
    elif name == "embed" and ndim == 2:
        # vocab dim only: a d-sharded table breaks the SPMD partitioning of
        # the token gather (dynamic-slice over a split d); odd vocabs that
        # divide neither axis stay replicated (ZeRO below may still take
        # the vocab dim — never d).
        if _divides(shape[0], tp, sizes):
            dims[0] = tp
        dims[1] = "-"  # poison: excluded from ZeRO, cleared below
    elif name in _ROW_PARALLEL and ndim >= 2:
        if _divides(shape[-2], tp, sizes):
            dims[-2] = tp
    elif name in _COL_PARALLEL and ndim >= 2:
        if _divides(shape[-1], tp, sizes):
            dims[-1] = tp
    # everything else (norms, gates, mu/u/w0/a_param, scalars): replicated

    used = {
        a
        for d in dims
        if d is not None and d != "-"
        for a in (d if isinstance(d, tuple) else (d,))
    }
    dp_free = tuple(a for a in dp if a not in used)
    if cfg.zero_partition and dp_free and size >= _ZERO_MIN_SIZE:
        # ZeRO: free dp axes on the largest unassigned dim.  Dim 0 of stacked
        # (>=3-d) tensors is the scanned layer dim — leave it whole.
        joint_dp = _joint(dp_free)
        candidates = sorted(
            (i for i in range(ndim) if dims[i] is None and not (ndim >= 3 and i == 0)),
            key=lambda i: -shape[i],
        )
        for i in candidates:
            if _divides(shape[i], joint_dp, sizes):
                dims[i] = joint_dp
                break

    return PartitionSpec(*(None if d == "-" else d for d in dims))


def param_specs(cfg: ArchConfig, tree: Any, mesh) -> Any:
    """PartitionSpec tree mirroring ``tree`` (params or optimizer state)."""
    sizes = _axis_sizes(mesh)
    dp, tp = mesh_axes(mesh)
    ep = ep_axes(cfg, mesh)
    specs = [
        _leaf_spec(treepath.path_parts(path), _shape(leaf), sizes, dp, tp, ep, cfg)
        for path, leaf in treepath.flatten_with_path(tree)
    ]
    return treepath.unflatten_like(tree, specs)


def batch_specs(cfg: ArchConfig, tree: Any, mesh) -> Any:
    """Model inputs: batch dim over all dp axes, rest replicated."""
    sizes = _axis_sizes(mesh)
    dp, _ = mesh_axes(mesh)
    joint_dp = _joint(dp)

    def spec_of(leaf):
        shape = _shape(leaf)
        if not shape:
            return PartitionSpec()
        dims: list[Any] = [None] * len(shape)
        if joint_dp is not None and _divides(shape[0], joint_dp, sizes):
            dims[0] = joint_dp
        return PartitionSpec(*dims)

    return treepath.unflatten_like(tree, [spec_of(leaf) for leaf in treepath.leaves(tree)])


def cache_specs(cfg: ArchConfig, tree: Any, mesh, global_batch: int) -> Any:
    """Decode state (KV caches / recurrent state): batch dim over dp, the
    kv-heads dim of attention caches over 'model'."""
    sizes = _axis_sizes(mesh)
    dp, tp = mesh_axes(mesh)
    joint_dp = _joint(dp)
    kv = cfg.num_kv_heads

    def spec_of(leaf):
        shape = _shape(leaf)
        if not shape:
            return PartitionSpec()
        dims: list[Any] = [None] * len(shape)
        b_dim = next((i for i, s in enumerate(shape) if s == global_batch), None)
        if (
            b_dim is not None
            and joint_dp is not None
            and _divides(global_batch, joint_dp, sizes)
        ):
            dims[b_dim] = joint_dp
        if len(shape) >= 5:  # [..., B, S, KV, hd] attention cache layout
            kv_dim = next(
                (
                    i
                    for i in range(len(shape) - 2, max(len(shape) - 3, 0) - 1, -1)
                    if shape[i] == kv and i != b_dim
                ),
                None,
            )
            if kv_dim is not None and _divides(kv, tp, sizes):
                dims[kv_dim] = tp
        return PartitionSpec(*dims)

    return treepath.unflatten_like(tree, [spec_of(leaf) for leaf in treepath.leaves(tree)])


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis in the
    mesh's order: ``Shard(dim)`` on each axis a dim's entry names (a joint
    entry on each of its axes, which must come in the mesh's order: DTensor
    then splits row-major with the first axis slowest, as
    ``restore_sharded`` does), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(_axis_sizes(mesh))
    out: list[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"joint entry {axes} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def shardings_for(mesh, specs: Any) -> Any:
    """PartitionSpec tree -> a tree of DTensor placement tuples on ``mesh``
    (the reference's ``NamedSharding`` tree)."""
    return treepath.unflatten_like(
        specs, [placements(mesh, s) for s in treepath.leaves(specs)]
    )


def local_shard(tree: Any, specs: Any, mesh_or_sizes: Any, coords) -> Any:
    """Each leaf of ``tree`` cut to the block the shard at ``coords`` (mesh
    axis name -> index) owns under ``specs``: what one rank of a per-rank
    SPMD program holds, and what ``restore_sharded`` restores there.  A
    0-d leaf (or a host scalar) is whole on every shard."""
    sizes = _axis_sizes(mesh_or_sizes)
    leaves = treepath.leaves(tree)
    spec_leaves = treepath.leaves(specs)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"specs tree has {len(spec_leaves)} leaves, tree has {len(leaves)}")
    out = []
    for leaf, spec in zip(leaves, spec_leaves):
        shape = _shape(leaf)
        if not shape:
            out.append(leaf)
            continue
        bounds = _shard_bounds(shape, spec, sizes, coords)
        out.append(leaf[tuple(slice(s, e) for s, e in bounds)])
    return treepath.unflatten_like(tree, out)


# ---------------------------------------------------------------------------
# gather at use
# ---------------------------------------------------------------------------


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None: none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: PartitionSpec) -> tuple[str, ...]:
    """Every mesh axis a leaf of ``spec`` is sharded over."""
    return tuple(a for entry in spec for a in axes_of(entry))


def _ep_axes(ctx) -> tuple[str, ...]:
    return axes_of(tuple(ctx.ep_axis) if isinstance(ctx.ep_axis, list) else ctx.ep_axis)


def _specs_at(specs: Any, path: tuple) -> Any:
    for k in path:
        specs = specs[k]
    return specs


def _walk(tree: Any, specs: Any, fn, names: tuple[str, ...]) -> Any:
    """``fn(leaf, spec, names)`` at every leaf of ``tree``, whose spec tree
    ``specs`` mirrors it (``names``: the path's keys)."""
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], fn, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, s, fn, names + (str(i),))
                          for i, (v, s) in enumerate(zip(tree, specs)))
    return fn(tree, specs, names)


def _entries(spec: PartitionSpec, ndim: int, layer: bool) -> tuple:
    """``spec``'s entries for a leaf of ``ndim`` dims; ``layer``: for one
    layer's view of a stacked [L, ...] leaf (whose layer dim no rule
    shards)."""
    e = tuple(spec)
    if layer:
        if e and e[0] is not None:
            raise ValueError(f"a stacked leaf's layer dim is sharded: {spec}")
        e = e[1:]
    return e + (None,) * (ndim - len(e))


def _gather(x: torch.Tensor, entries: tuple, ctx, keep=()) -> torch.Tensor:
    """``x`` all-gathered along every dim with an entry but those in
    ``keep``: the entry's axes in runs of dp and of other axes, the
    innermost run first (so that the blocks land in row-major order)."""
    dp = set(ctx.dp_axes)
    for dim, entry in enumerate(entries):
        axes = axes_of(entry)
        if not axes or dim in keep:
            continue
        runs: list[list[str]] = []
        for a in axes:
            if runs and (a in dp) == (runs[-1][0] in dp):
                runs[-1].append(a)
            else:
                runs.append([a])
        for run in reversed(runs):
            fn = direct.allgather if run[0] in dp else direct.allgather_alike
            x = fn(x, tuple(run), dim=dim, mesh=ctx.mesh)
    return x


def _block(x: torch.Tensor, dim: int, axes: tuple[str, ...], ctx) -> torch.Tensor:
    """``x`` narrowed along ``dim`` to this rank's block over ``axes``
    (row-major, the first axis slowest: ``_shard_bounds``)."""
    index = 0
    for a in axes:
        index = index * direct.axis_size(a, ctx.mesh) + direct.axis_index(a, ctx.mesh)
    n = x.shape[dim] // math.prod(direct.axis_size(a, ctx.mesh) for a in axes)
    return x.narrow(dim, index * n, n)


def use(ctx, tree: Any, *path, layer: bool = False, keep_tp=()) -> Any:
    """``tree``, the subtree of a rank's parameters at ``path`` (``layer``:
    one layer's view of a stacked subtree), with every leaf gathered as
    ``ctx.param_specs`` says, but an MoE expert stack's expert dim over
    ``ctx.ep_axis``, and the dim over ``ctx.tp_axis`` alone of a leaf named
    in ``keep_tp``, which the caller's tensor-parallel product takes as the
    rank's block (:func:`tp_role`; its dp entries are gathered all the
    same).  Unchanged without specs."""
    specs = getattr(ctx, "param_specs", None) if ctx is not None else None
    if specs is None:
        return tree
    ep = _ep_axes(ctx)
    tp = (ctx.tp_axis,)

    def leaf(x, spec, names):
        entries = _entries(spec, x.dim(), layer)
        expert = "moe" in names and names[-1] in _EXPERT
        local = ep if expert else tp if names[-1] in keep_tp else None
        keep = {d for d, e in enumerate(entries) if axes_of(e) == local}
        return _gather(x, entries, ctx, keep)

    return _walk(tree, _specs_at(specs, path), leaf, tuple(str(k) for k in path))


def tp_role(ctx, *path) -> str | None:
    """The tensor-parallel role ``ctx.param_specs`` gives the parameter leaf
    at ``path`` (its keys): ``"vocab"`` for an ``embed`` table whose vocab
    dim is on ``ctx.tp_axis``, ``"column"`` for a leaf whose last dim is on
    it (a product's output columns), ``"row"`` for one whose second-to-last
    dim is (its input rows); None where no dim is on the tp axis alone (the
    leaf is used whole), and for every leaf without specs or with a tp axis
    of one rank."""
    specs = getattr(ctx, "param_specs", None) if ctx is not None else None
    if specs is None or ctx.tp_axis is None or ctx.mesh is None:
        return None
    if direct.axis_size(ctx.tp_axis, ctx.mesh) == 1:
        return None
    entries = tuple(_specs_at(specs, path))
    on_tp = [axes_of(e) == (ctx.tp_axis,) for e in entries]
    if path[-1] == "embed":
        return "vocab" if on_tp and on_tp[0] else None
    if len(on_tp) >= 1 and on_tp[-1]:
        return "column"
    if len(on_tp) >= 2 and on_tp[-2]:
        return "row"
    return None


def vocab_split(ctx, params: dict) -> bool:
    """Whether the rules split the output head's vocab columns over
    ``ctx.tp_axis`` (``lm_head``'s columns, or a tied ``embed``'s rows): the
    rank's head product then makes its [.., V / tp] block of the logits,
    which a training forward returns as it is (the reference's
    vocab-sharded logits; ``api.loss_fn`` takes them so) and serving
    all-gathers."""
    if "lm_head" in params:
        return tp_role(ctx, "lm_head") == "column"
    return tp_role(ctx, "embed") == "vocab"


def use_vocab(ctx, params: dict, name: str) -> tuple[torch.Tensor, bool]:
    """(leaf ``name`` (``embed`` / ``lm_head``) as the rank uses it, whether
    that is its vocab block): gathered at use, but the vocab dim where the
    rules split it over tp."""
    split = tp_role(ctx, name) in ("vocab", "column")
    return use(ctx, params[name], name, keep_tp=(name,) if split else ()), split


def tp_roles(ctx, expect: dict, *path) -> dict:
    """``expect`` (leaf name -> the :func:`tp_role` a layer's
    tensor-parallel products need it to have) where ``ctx.param_specs``
    gives every leaf named there under ``path`` that role, else {}: the
    layer then runs on every leaf whole, as it does without specs."""
    got = {n: tp_role(ctx, *path, n) for n in expect}
    return dict(expect) if got == expect else {}


def _state_entries(ctx, x: torch.Tensor, path: tuple, layer: bool):
    specs = getattr(ctx, "state_specs", None) if ctx is not None else None
    return None if specs is None else _entries(_specs_at(specs, path), x.dim(), layer)


def _tp_dims(ctx, entries: tuple, keep_tp: bool) -> set:
    """The dims whose entry is ``ctx.tp_axis`` alone, where ``keep_tp``."""
    return {d for d, e in enumerate(entries) if axes_of(e) == (ctx.tp_axis,)} if keep_tp else set()


def use_state(ctx, local: torch.Tensor, *path, batch_dim: int, layer: bool = False,
              keep_tp: bool = False) -> torch.Tensor:
    """A rank's block ``local`` of the decode-state leaf at ``path`` (one
    layer's view with ``layer``), as the rank computes on it: the rank's
    rows along ``batch_dim`` (its dp shard where the batch divides the dp
    axes, as ``batch_specs`` shards the inputs; else every row), every
    other dim whole.  A batch dim sharded over the dp axes stays local,
    every other sharded dim is gathered, and where the rules put the dp
    axes on another dim (a layer dim of the global batch's size) the
    gathered leaf is cut to the rank's rows.  ``keep_tp``: a dim over
    ``ctx.tp_axis`` alone stays local too (a cache's heads, which the
    caller's tensor-parallel products make and read as the rank's block).
    ``local`` itself where nothing is sharded."""
    entries = _state_entries(ctx, local, path, layer)
    if entries is None:
        return local
    dp = tuple(ctx.dp_axes)
    batch_local = axes_of(entries[batch_dim]) == dp
    keep = _tp_dims(ctx, entries, keep_tp) | ({batch_dim} if batch_local else set())
    x = _gather(local, entries, ctx, keep)
    if batch_local or not dp or local.shape[batch_dim] % direct.axis_size(dp, ctx.mesh):
        return x
    return _block(x, batch_dim, dp, ctx)


def own_state(ctx, full: torch.Tensor, like: torch.Tensor, *path, batch_dim: int,
              layer: bool = False, keep_tp: bool = False) -> torch.Tensor:
    """``use_state``'s inverse: the block of ``full`` (the rank's rows,
    every other dim whole, but a dim over ``ctx.tp_axis`` alone already the
    rank's block with ``keep_tp``) that replaces ``like``, the rank's block
    of the leaf at ``path``, as ``local_shard`` cuts it."""
    entries = _state_entries(ctx, full, path, layer)
    if entries is None:
        return full
    dp = tuple(ctx.dp_axes)
    batch_local = axes_of(entries[batch_dim]) == dp
    if not batch_local and full.shape[batch_dim] != like.shape[batch_dim]:
        full = direct.allgather(full, dp, dim=batch_dim, mesh=ctx.mesh)  # every rank's rows
    kept = _tp_dims(ctx, entries, keep_tp)
    for dim, entry in enumerate(entries):
        if axes_of(entry) and not (batch_local and dim == batch_dim) and dim not in kept:
            full = _block(full, dim, axes_of(entry), ctx)
    return full


def repartition_states(states: list, new_world: int) -> list:
    """Repartition per-rank BSP state over a different world size.

    The mid-run shrink path (``BSPRuntime.run(recovery_policy="shrink")``)
    rolls back to the last checkpoint — a list of ``old_world`` per-rank
    states — and redistributes it over the survivors.  Supported shapes:

    - every state a tensor: concatenate on dim 0 (0-d tensors as one row)
      and split into ``new_world`` contiguous chunks on the states' device
      (``torch.tensor_split``: ``np.array_split``'s sizes, the larger chunks
      first, so the global concatenation is preserved exactly and chunk
      sizes differ by at most one row);
    - every state a list/tuple: flatten and re-chunk the same way;
    - anything else raises ``TypeError`` — pass an explicit
      ``repartition=`` callable to the runtime for richer state.
    """
    new_world = int(new_world)
    if new_world < 1:
        raise ValueError("new_world must be >= 1")
    states = list(states)
    if states and all(isinstance(s, torch.Tensor) for s in states):
        flat = torch.cat([s.reshape(1) if s.dim() == 0 else s for s in states], dim=0)
        return list(torch.tensor_split(flat, new_world, dim=0))
    if all(isinstance(s, list | tuple) for s in states):
        flat = [x for s in states for x in s]
        bounds = np.linspace(0, len(flat), new_world + 1).astype(int)
        return [flat[bounds[i]:bounds[i + 1]] for i in range(new_world)]
    raise TypeError(
        "repartition_states handles per-rank tensors or lists/tuples; "
        f"got {sorted({type(s).__name__ for s in states})} — pass an "
        "explicit repartition= callable for richer state"
    )
