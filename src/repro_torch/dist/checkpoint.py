"""Store-backed checkpointing for elastic (kill/resume) training — the port
of ``repro.dist.checkpoint``.

The layout is the reference's, one store group per step:

    step_00000420/
        manifest.json   step, user extra, per-leaf {obj, shape, dtype, nbytes}
        a0.bin ...      one raw little-endian C-order object per tree leaf

Leaves are numbered in ``jax.tree_util`` order and keyed by the same
``path_str`` (``dist.treepath``), and dtypes are written under numpy's names
(``float32``, ``bfloat16``, ``int8``, ...), so a checkpoint written by either
package restores in the other.  Atomicity is the store's contract
(``object_store``).  ``restore`` is shape-strict: a leaf present in
``like_tree`` but absent in the checkpoint raises ``KeyError``; a shape
mismatch raises ``ValueError``.  The restored tensors land on the device of
the matching ``like_tree`` leaf.

``restore_sharded`` is the elastic-resharding path: given the PartitionSpec
tree of a *new* mesh (``dist.sharding.param_specs``), each rank reads only
the byte ranges of each leaf its shard owns (ranged GETs, coalesced runs of
the C-order layout), so restoring onto a different topology moves a
fraction of the checkpoint instead of the whole thing.  Its GET plan is the
reference's, so the two packages log the same store ops for the same
restore.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.dist.object_store import Store, as_store
from repro_torch.dist.treepath import flatten_with_path, leaves, path_str, unflatten_like

_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"

# ranged restore issues at most this many GETs per leaf: when a shard's
# C-order runs are more fragmented than this (inner-dim sharding), runs are
# merged across the narrowest gaps — a few over-read bytes instead of one
# priced round trip per run.  Sized against the pooled client
# (Store.get_ranges): ~1.5 connection pools per leaf keeps a fragmented
# leaf's request count in the same league as its pooled latency while the
# over-read stays well under the restore's bytes budget.
_MAX_RANGED_GETS = 192

# manifest dtype name -> torch dtype (numpy's names, as the reference writes)
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint32": torch.uint32, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _step_name(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


@dataclasses.dataclass(frozen=True)
class CheckpointRef:
    """Handle to one committed checkpoint inside a store."""

    store: Store
    name: str

    @property
    def step(self) -> int:
        return int(self.name[len(_STEP_PREFIX):])


def _resolve(ref: str | Path | CheckpointRef) -> tuple[Store, str]:
    """(store, group) for a checkpoint path or ref."""
    if isinstance(ref, CheckpointRef):
        return ref.store, ref.name
    path = Path(ref)
    return as_store(path.parent), path.name


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def save(
    target: str | Path | Store, step: int, tree: Any, extra: dict | None = None
) -> Path | CheckpointRef:
    """Write ``tree`` (nested dicts of tensors) as checkpoint ``step`` into
    ``target`` atomically: a checkpoint directory (returns the checkpoint's
    ``Path``) or a ``Store`` (returns a :class:`CheckpointRef`)."""
    store = as_store(target)
    objects: dict[str, bytes] = {}
    meta: dict[str, dict] = {}
    for i, (path, leaf) in enumerate(flatten_with_path(tree)):
        t = _as_tensor(leaf)
        if t.dtype not in _NAMES:
            raise TypeError(f"checkpoint: leaf {path_str(path)!r} has unsupported dtype {t.dtype}")
        obj = f"a{i}.bin"
        objects[obj] = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        meta[path_str(path)] = {
            "obj": obj,
            "shape": list(t.shape),
            "dtype": _NAMES[t.dtype],
            "nbytes": t.numel() * t.element_size(),
        }
    manifest = {"format": 2, "step": int(step), "extra": extra or {}, "leaves": meta}
    # the manifest is ordered last: on a put-then-marker store it is the
    # commit marker, so leaf objects are always visible before it is
    objects[_MANIFEST] = json.dumps(manifest, indent=1).encode()
    name = _step_name(step)
    store.put_objects_atomic(name, objects)
    if isinstance(target, Store):
        return CheckpointRef(store, name)
    return Path(target) / name


def read_manifest(ref: str | Path | CheckpointRef) -> dict:
    store, group = _resolve(ref)
    return json.loads(store.get_object(group, _MANIFEST))


def _dtype(m: dict, group: str, path) -> torch.dtype:
    if m["dtype"] not in _DTYPES:
        raise TypeError(f"checkpoint {group}: leaf {path_str(path)!r} has dtype {m['dtype']}")
    return _DTYPES[m["dtype"]]


def _as_leaf(data: bytes | bytearray, dtype: torch.dtype, shape: tuple[int, ...]) -> torch.Tensor:
    """A CPU tensor over a writable copy of ``data`` (raw C-order bytes)."""
    raw = data if isinstance(data, bytearray) else bytearray(data)
    return torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(shape)


def _device_of(like) -> torch.device:
    return like.device if isinstance(like, torch.Tensor) else torch.device("cpu")


def _leaf_meta(leaves_meta: dict, key: str, like, group: str) -> dict:
    if key not in leaves_meta:
        raise KeyError(
            f"checkpoint {group} has no leaf {key!r} (has: {sorted(leaves_meta)[:8]}...)"
        )
    m = leaves_meta[key]
    if tuple(m["shape"]) != tuple(like.shape):
        raise ValueError(
            f"shape mismatch for {key!r}: checkpoint {tuple(m['shape'])} vs expected "
            f"{tuple(like.shape)}"
        )
    return m


def restore(ref: str | Path | CheckpointRef, like_tree: Any) -> Any:
    """Load a checkpoint into the structure of ``like_tree``; each tensor on
    the device of its ``like_tree`` leaf (the CPU for a non-tensor leaf).

    Raises ``KeyError`` for leaves missing from the checkpoint and
    ``ValueError`` for shape mismatches (elastic restarts must never
    silently reinterpret state)."""
    store, group = _resolve(ref)
    leaves_meta = read_manifest(ref)["leaves"]
    out = []
    for path, like in flatten_with_path(like_tree):
        m = _leaf_meta(leaves_meta, path_str(path), like, group)
        t = _as_leaf(store.get_object(group, m["obj"]), _dtype(m, group, path),
                     tuple(m["shape"]))
        out.append(t.to(_device_of(like)))
    return unflatten_like(like_tree, out)


def latest(target: str | Path | Store) -> Path | CheckpointRef | None:
    """Newest complete checkpoint in ``target`` (None when empty).  Only
    committed groups count, so the answer never goes backwards."""
    store = as_store(target)
    steps = [g for g in store.list_groups() if g.startswith(_STEP_PREFIX)]
    if not steps:
        return None
    name = max(steps)
    if isinstance(target, Store):
        return CheckpointRef(store, name)
    return Path(target) / name


# -- resharded partial restore ----------------------------------------------


def _axis_sizes(mesh_or_sizes) -> dict[str, int]:
    """Mesh axis name -> size, in the mesh's order, from a ``{name: size}``
    mapping, a ``DeviceMesh`` or an abstract mesh (``axis_names`` and a
    ``shape`` mapping)."""
    if isinstance(mesh_or_sizes, Mapping):
        return {str(k): int(v) for k, v in mesh_or_sizes.items()}
    names = getattr(mesh_or_sizes, "mesh_dim_names", None)
    if names is not None:  # torch.distributed DeviceMesh
        return {str(n): int(mesh_or_sizes.size(i)) for i, n in enumerate(names)}
    shape = mesh_or_sizes.shape
    return {name: int(shape[name]) for name in mesh_or_sizes.axis_names}


def _shard_bounds(
    shape: tuple[int, ...],
    spec,
    sizes: dict[str, int],
    coords: Mapping[str, int],
) -> list[tuple[int, int]]:
    """Per-dim [start, stop) owned by the shard at ``coords`` under ``spec``."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    bounds = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            bounds.append((0, dim))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} not divisible by axes {axes} (x{n})")
        index = 0
        for a in axes:  # row-major over the joint axes, first axis slowest
            index = index * sizes[a] + int(coords[a])
        block = dim // n
        bounds.append((index * block, (index + 1) * block))
    return bounds


def _element_runs(
    shape: tuple[int, ...], bounds: list[tuple[int, int]]
) -> list[tuple[int, int]]:
    """Coalesced (offset, length) element runs of the C-order block at
    ``bounds``, ascending — concatenating them yields the block in C order."""
    nd = len(shape)
    run_dim = -1
    for d in range(nd - 1, -1, -1):
        if bounds[d] != (0, shape[d]):
            run_dim = d
            break
    if run_dim < 0:
        return [(0, math.prod(shape) if shape else 1)]
    strides = [math.prod(shape[d + 1:]) for d in range(nd)]  # elements
    run_len = (bounds[run_dim][1] - bounds[run_dim][0]) * strides[run_dim]
    runs: list[tuple[int, int]] = []
    for outer in itertools.product(*(range(s, e) for s, e in bounds[:run_dim])):
        off = sum(i * strides[d] for d, i in enumerate(outer))
        off += bounds[run_dim][0] * strides[run_dim]
        if runs and runs[-1][0] + runs[-1][1] == off:  # adjacent: coalesce
            runs[-1] = (runs[-1][0], runs[-1][1] + run_len)
        else:
            runs.append((off, run_len))
    return runs


def _covering_ranges(
    runs: list[tuple[int, int]], budget: int
) -> list[tuple[int, int]]:
    """Byte-minimal covering of ``runs`` by at most ``budget`` ranges.

    Keeps the ``budget - 1`` widest inter-run gaps as split points and merges
    across the rest — the smallest possible over-read for a fixed request
    count (each range is one priced GET round trip).
    """
    if len(runs) <= budget:
        return list(runs)
    gaps = sorted(
        (runs[i + 1][0] - (runs[i][0] + runs[i][1]), i)
        for i in range(len(runs) - 1)
    )
    splits = sorted(i for _, i in gaps[-(budget - 1):])
    ranges: list[tuple[int, int]] = []
    start = runs[0][0]
    for i in splits:
        end = runs[i][0] + runs[i][1]
        ranges.append((start, end - start))
        start = runs[i + 1][0]
    ranges.append((start, runs[-1][0] + runs[-1][1] - start))
    return ranges


def _ranged_plan(
    shape: tuple[int, ...], runs: list[tuple[int, int]], max_gets: int
) -> list[tuple[int, int]] | None:
    """The (offset, length) element ranges a shard's ranged GETs read, or
    None for one full GET: a replicated leaf, or a shard whose covering
    ranges would read the whole leaf anyway."""
    nelems = max(math.prod(shape), 1)
    if not shape or runs == [(0, nelems)]:
        return None
    ranges = _covering_ranges(runs, max_gets)
    return None if sum(length for _, length in ranges) >= nelems else ranges


def restore_sharded(
    ref: str | Path | CheckpointRef,
    like_tree: Any,
    specs: Any,
    mesh_or_sizes: Any,
    coords: Mapping[str, int],
    max_gets: int | None = None,
) -> Any:
    """Restore only this shard's slice of every leaf (elastic resharding).

    ``like_tree`` carries the *global* shapes (validated against the
    manifest exactly like :func:`restore`); ``specs`` is the matching
    PartitionSpec tree from ``dist.sharding.param_specs`` for the *new*
    mesh (a mesh, a ``DeviceMesh`` or a ``{name: size}`` mapping);
    ``coords`` maps each mesh axis name to this shard's index.  Returns the
    tree of local shard tensors, each on the device of its ``like_tree``
    leaf.

    Sharded leaves are fetched as ranged GETs of their C-order byte runs;
    fragmented shards (inner-dim sharding) are merged across the narrowest
    gaps down to ``max_gets`` requests per leaf, trading a few over-read
    bytes for round trips.  Replicated leaves — and shards whose covering
    plan would read nearly the whole object anyway — use one full GET.

    The plan minimizes *bytes moved*, not single-reader latency: when every
    shard of a new mesh restores concurrently, the store NIC is the shared
    bottleneck, so bytes are the contended resource even though one reader
    in isolation would often be faster issuing a single full GET on a
    high-``alpha`` channel like S3.  Tune ``max_gets`` down (toward full
    GETs) when per-request latency dominates, e.g. restoring one shard alone.
    """
    if max_gets is None:
        max_gets = _MAX_RANGED_GETS
    store, group = _resolve(ref)
    sizes = _axis_sizes(mesh_or_sizes)
    leaves_meta = read_manifest(ref)["leaves"]
    like_leaves = flatten_with_path(like_tree)
    spec_leaves = leaves(specs)
    if len(spec_leaves) != len(like_leaves):
        raise ValueError(
            f"specs tree has {len(spec_leaves)} leaves, like_tree has {len(like_leaves)}"
        )
    out = []
    for (path, like), spec in zip(like_leaves, spec_leaves):
        m = _leaf_meta(leaves_meta, path_str(path), like, group)
        shape = tuple(m["shape"])
        dtype = _dtype(m, group, path)
        dev = _device_of(like)
        bounds = _shard_bounds(shape, spec, sizes, coords)
        runs = _element_runs(shape, bounds)
        ranges = _ranged_plan(shape, runs, max_gets)
        if ranges is None:
            # one full GET, still issued through the pooled client so whole
            # leaves share connection slots with the ranged ones; sliced here
            data = store.get_ranges(group, m["obj"], [(0, int(m["nbytes"]))])[0]
            whole = _as_leaf(data, dtype, shape)
            out.append(whole[tuple(slice(s, e) for s, e in bounds)].contiguous().to(dev))
            continue
        itemsize = dtype.itemsize
        buffers = store.get_ranges(
            group, m["obj"],
            [(off * itemsize, (off + length) * itemsize) for off, length in ranges],
        )
        parts: list[bytes] = []
        ci = 0
        for off, length in runs:  # each run lies inside one covering range
            while off + length > ranges[ci][0] + ranges[ci][1]:
                ci += 1
            lo = (off - ranges[ci][0]) * itemsize
            parts.append(buffers[ci][lo: lo + length * itemsize])
        shard_shape = tuple(e - s for s, e in bounds)
        out.append(_as_leaf(bytearray().join(parts), dtype, shard_shape).to(dev))
    return unflatten_like(like_tree, out)
