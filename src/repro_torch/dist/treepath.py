"""Pytree key paths — the port of ``repro.dist.treepath``, plus the
flattening the port needs in place of ``jax.tree_util``.

Checkpoint manifests key leaves by path, so both packages must render a
path identically.  ``flatten_with_path`` walks a nested dict / list / tuple
in ``jax.tree_util``'s order (dict keys sorted, sequences by index; ``None``
holds no leaf), so a tree of the port and the same tree of the reference
list their leaves, and number their checkpoint objects, alike.
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import Any


def path_parts(path) -> list[str]:
    """One string per key-path component: a ``jax.tree_util`` key (DictKey /
    SequenceKey / attr) or a plain dict key or index, as the port's paths hold."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return parts


def path_str(path) -> str:
    parts = path_parts(path)
    return "/".join(parts) if parts else "."


def flatten_with_path(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in flatten_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree: Any) -> list[Any]:
    """The leaves in ``jax.tree_util`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn, tree: Any) -> Any:
    """``tree`` (nested dicts, lists and tuples) with ``fn`` applied to every
    leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten_like(tree: Any, new_leaves: Iterator[Any] | list) -> Any:
    """``tree``'s structure with its leaves replaced, in ``flatten_with_path``
    order, by ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)
