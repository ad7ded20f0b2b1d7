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
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

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
