"""Hash partitioning — step 1 of every shuffle-based operator (paper §III-D:
"1) Hash applicable columns into partitioned tables, 2) Use AllToAll ...,
3) Execute a local join").  Port of ``repro.dataframe.partition``, bit-exact.

For CUDA tensors the row hash, the bucket ids and the bucket histogram come
from one launch of the hand-written kernel (``kernels/csrc/hash_partition.cu``);
for CPU tensors from its plain version, which emulates uint32 in int64.
"""

from __future__ import annotations

import torch

from repro_torch.dataframe.table import Table
from repro_torch.kernels.hash_partition import ops as hp_ops


def _key_columns(table: Table, key_cols: list[str]) -> list[torch.Tensor]:
    cols = []
    for c in key_cols:
        col = table.columns[c]
        if col.dim() != 1:
            raise ValueError(f"key column {c} must be 1-D")
        cols.append(col)
    return cols


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3-style 32-bit finalizer over integer keys, as uint32."""
    h, _ = hp_ops.hash_partition(x, num_partitions=1, seed=seed)
    return h


def hash_columns(table: Table, key_cols: list[str], seed: int = 0) -> torch.Tensor:
    """Combine per-column hashes into one row hash (boost-style mixing)."""
    return hp_ops.row_hash(_key_columns(table, key_cols), seed)


def bucket_ids(table: Table, key_cols: list[str], num_partitions: int, seed: int = 0) -> torch.Tensor:
    """Destination partition per row; padding rows get the sentinel P."""
    b, _ = hp_ops.row_buckets(
        _key_columns(table, key_cols), num_partitions, table.count, seed, with_hist=False
    )
    return b


def partition_counts(table: Table, key_cols: list[str], num_partitions: int, seed: int = 0) -> torch.Tensor:
    _, hist = hp_ops.row_buckets(_key_columns(table, key_cols), num_partitions, table.count, seed)
    return hist[:num_partitions]


def build_partition_payload(
    table: Table,
    num_partitions: int,
    key_cols: list[str],
    cap_per_dest: int | None = None,
    seed: int = 0,
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Bucket rows by hash(key) % P into a fixed-capacity send buffer.

    Returns (payload, counts): payload[col] is ``[P, cap_per_dest, ...]`` with
    partition d's rows packed at the front of slot d; counts is ``[P]`` int32.
    Rows beyond ``cap_per_dest`` in a slot are dropped and counts are clamped.
    """
    p = num_partitions
    cap_dst = cap_per_dest or table.capacity
    dev = table.device
    b, hist = hp_ops.row_buckets(_key_columns(table, key_cols), p, table.count, seed)

    # Stable sort rows by bucket so each partition's rows are contiguous.
    order = torch.argsort(b, stable=True)
    b_sorted = b[order]
    counts_full = hist[:p]
    counts = torch.clamp(counts_full, max=cap_dst).to(torch.int32)
    starts = torch.cumsum(counts_full, 0, dtype=torch.int32) - counts_full

    dest_slot = torch.clamp(b_sorted, max=p - 1)
    pos_in_group = torch.arange(table.capacity, device=dev, dtype=torch.int32) - starts[dest_slot]
    # cap_dst is the drop slot: the only index written more than once
    dest_row = torch.where((b_sorted < p) & (pos_in_group < cap_dst), pos_in_group, cap_dst)

    payload = {}
    for name, col in table.columns.items():
        src = col[order]
        buf = torch.zeros((p, cap_dst + 1) + tuple(col.shape[1:]), dtype=col.dtype, device=dev)
        buf[dest_slot.long(), dest_row.long()] = src
        payload[name] = buf[:, :cap_dst]
    return payload, counts
