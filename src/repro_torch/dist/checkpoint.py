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

Not ported yet: ``restore_sharded`` (the resharded ranged restore), which
waits for the sharding rules (ROADMAP A 8).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.dist.object_store import Store, as_store
from repro_torch.dist.treepath import flatten_with_path, path_str, unflatten_like

_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"

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
        if m["dtype"] not in _DTYPES:
            raise TypeError(f"checkpoint {group}: leaf {path_str(path)!r} has dtype {m['dtype']}")
        raw = torch.frombuffer(bytearray(store.get_object(group, m["obj"])), dtype=torch.uint8)
        t = raw.view(_DTYPES[m["dtype"]]).reshape(tuple(m["shape"]))
        dev = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
        out.append(t.to(dev))
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


def restore_sharded(*args, **kwargs):
    """The reference's resharded ranged restore needs the sharding rules."""
    raise NotImplementedError("restore_sharded waits for dist/sharding.py (ROADMAP A 8)")
