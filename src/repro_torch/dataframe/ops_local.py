"""Local (single-partition) relational operators — port of
``repro.dataframe.ops_local``.

These are the "local join on the received tables" / local aggregation halves
of the paper's distributed operators, over fixed-capacity tables with the
reference's row orders.  For CUDA tensors the probe of :func:`join_unique`
runs the hand-written sorted-probe kernel and the sum/count aggregates of
:func:`groupby_agg` run the segment-sum kernel; CPU tensors take their plain
versions.  Sorts are ``torch.argsort(stable=True)`` where the reference uses
``jnp.argsort(stable=True)``.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.dataframe.table import Table
from repro_torch.kernels.join_probe import ops as probe_ops
from repro_torch.kernels.segment_reduce import ops as seg_ops


def _key_sentinel(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def _lowest(dtype: torch.dtype):
    return torch.iinfo(dtype).min if not dtype.is_floating_point else float("-inf")


def _highest(dtype: torch.dtype):
    return torch.iinfo(dtype).max if not dtype.is_floating_point else float("inf")


def sort_by_key(table: Table, key: str) -> Table:
    """Sort valid rows ascending by integer key; padding stays at the back."""
    keys = table.columns[key]
    masked = torch.where(table.valid_mask(), keys, _key_sentinel(keys.dtype))
    order = torch.argsort(masked, stable=True)
    return table.gather(order, table.count)


# ---------------------------------------------------------------------------
# GroupBy (paper §IV-C) — sort + segment reduce, with combiner support
# ---------------------------------------------------------------------------


def _segment_extreme(vals: torch.Tensor, seg: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """``jax.ops.segment_max``/``segment_min``: empty segments hold the
    dtype's lowest/highest value."""
    init = _lowest(vals.dtype) if reduce == "amax" else _highest(vals.dtype)
    out = torch.full((n,) + tuple(vals.shape[1:]), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals, reduce, include_self=True)


AGGS: dict[str, Callable] = {
    "sum": lambda vals, seg, n: seg_ops.segment_sum(seg, vals, n),
    "max": lambda vals, seg, n: _segment_extreme(vals, seg, n, "amax"),
    "min": lambda vals, seg, n: _segment_extreme(vals, seg, n, "amin"),
    "count": lambda vals, seg, n: seg_ops.segment_sum(seg, torch.ones_like(vals), n),
}


def groupby_agg(table: Table, key: str, aggs: dict[str, str]) -> Table:
    """Group by integer ``key``; aggregate value columns with AGGS ops.

    Output: one row per distinct key (packed), capacity preserved.
    ``aggs`` maps value-column name -> op name.  On the card, ``sum`` and
    ``count`` run the segment-sum kernel, which takes int32 and float32
    value columns (the dtypes ``Table.from_dict`` canonicalizes to).
    """
    t = sort_by_key(table, key)
    keys = t.columns[key]
    valid = t.valid_mask()
    keys_m = torch.where(valid, keys, _key_sentinel(keys.dtype))
    cap = table.capacity
    dev = table.device

    # Segment ids: 0-based rank of each distinct key in sorted order; invalid
    # rows are parked in an overflow segment `cap` that is sliced away.
    new_seg = torch.cat(
        [torch.ones(1, dtype=torch.int32, device=dev), (keys_m[1:] != keys_m[:-1]).to(torch.int32)]
    )
    new_seg = torch.where(valid, new_seg, 0)
    seg = torch.where(valid, torch.cumsum(new_seg, 0, dtype=torch.int32) - 1, cap)
    n_groups = new_seg.sum(dtype=torch.int32)

    out_cols: dict[str, torch.Tensor] = {}
    # representative key per group (all rows in a segment share the key)
    kmin = torch.iinfo(keys.dtype).min
    out_cols[key] = _segment_extreme(torch.where(valid, keys, kmin), seg, cap + 1, "amax")[:cap]
    for col, op in aggs.items():
        vals = t.columns[col]
        if op not in AGGS:
            raise ValueError(f"unsupported agg {op!r}; have {sorted(AGGS)}")
        res = AGGS[op](vals, seg, cap + 1)[:cap]
        out_cols[f"{col}_{op}"] = res.to(torch.int32 if op == "count" else table.columns[col].dtype)

    out = Table(out_cols, n_groups)
    # zero padding rows for determinism (segment max yields dtype-min there)
    return _zero_padding(out, out.valid_mask())


def _zero_padding(t: Table, mask: torch.Tensor) -> Table:
    cols = {
        k: torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)), v, 0)
        for k, v in t.columns.items()
    }
    return Table(cols, t.count)


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------


def join_unique(left: Table, right: Table, key: str, how: str = "inner") -> Table:
    """Equi-join where ``right`` has at most one valid row per key.

    Sort-probe: sort right by key, binary-search each left key (the probe
    kernel on the card, which takes int32 keys).  Inner join only;
    unmatched left rows are packed out.
    """
    if how != "inner":
        raise NotImplementedError("join_unique supports inner joins")
    r = sort_by_key(right, key)
    rkeys = torch.where(r.valid_mask(), r.columns[key], _key_sentinel(r.columns[key].dtype))
    lkeys = left.columns[key]
    pos_c, found = probe_ops.probe_sorted(rkeys, lkeys)
    # a left key equal to the sentinel "finds" padding: only hits inside r.count count
    hit = found & left.valid_mask() & (pos_c < r.count)

    cols: dict[str, torch.Tensor] = dict(left.columns)
    for name, col in r.columns.items():
        if name == key:
            continue
        tag = f"{name}_r" if name in left.columns else name
        cols[tag] = col.index_select(0, pos_c)
    return Table(cols, left.count).filter(hit)


def join_sorted_expand(left: Table, right: Table, key: str, out_capacity: int) -> Table:
    """General inner equi-join (many-to-many) with fixed output capacity.

    For each valid left row, the matching right range is [lo, hi) via double
    binary search; output slot j is mapped back to its (left row, offset)
    pair by searching the prefix-sum of match counts.  Rows beyond
    ``out_capacity`` are truncated (count reports the true total clamped).
    """
    l = sort_by_key(left, key)
    r = sort_by_key(right, key)
    dev = left.device
    sent = _key_sentinel(l.columns[key].dtype)
    lkeys = torch.where(l.valid_mask(), l.columns[key], sent)
    rkeys = torch.where(r.valid_mask(), r.columns[key], sent)
    rkeys_srch = torch.where(torch.arange(r.capacity, device=dev) < r.count, rkeys, sent)

    lo = torch.searchsorted(rkeys_srch, lkeys, out_int32=True)
    hi = torch.searchsorted(rkeys_srch, lkeys, right=True, out_int32=True)
    hi = torch.minimum(hi, r.count)
    lo = torch.minimum(lo, hi)
    counts = torch.where(l.valid_mask(), hi - lo, 0)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    total = ends[-1] if counts.shape[0] else torch.zeros((), dtype=torch.int32, device=dev)

    slots = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    li = torch.searchsorted(ends, slots, right=True, out_int32=True)
    li_c = li.clamp(0, left.capacity - 1)
    begin = ends[li_c] - counts[li_c]
    ri = lo[li_c] + (slots - begin)
    valid_out = slots < torch.clamp(total, max=out_capacity)
    ri_c = ri.clamp(0, right.capacity - 1)

    cols: dict[str, torch.Tensor] = {}
    for name, col in l.columns.items():
        cols[name] = col.index_select(0, li_c)
    for name, col in r.columns.items():
        if name == key:
            continue
        tag = f"{name}_r" if name in l.columns else name
        cols[tag] = col.index_select(0, ri_c)
    out = Table(cols, torch.clamp(total, max=out_capacity).to(torch.int32))
    # zero out padding rows for determinism
    return _zero_padding(out, valid_out)
