"""Public hash-partition ops: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.hash_partition import kernel, ref


def row_buckets(
    key_cols: list[torch.Tensor], num_partitions: int, count: torch.Tensor, seed: int = 0,
    with_hist: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(bucket [n] int32, histogram [P+1] int32 or None) of the combined row
    hash; rows at index >= ``count`` go to bucket ``num_partitions``."""
    if key_cols[0].device.type == "cpu":
        return ref.row_buckets_ref(key_cols, num_partitions, count, seed, with_hist)
    _, b, hist = kernel.row_buckets(key_cols, num_partitions, count, seed, want_hist=with_hist)
    return b, hist


def row_hash(key_cols: list[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Combined row hash as uint32."""
    if key_cols[0].device.type == "cpu":
        return ref.row_hash_u32(key_cols, seed).to(torch.uint32)
    h, _, _ = kernel.row_buckets(
        key_cols, 1, None, seed, want_hash=True, want_buckets=False, want_hist=False
    )
    return h


def hash_partition(keys: torch.Tensor, *, num_partitions: int, seed: int = 0):
    """(hash32(keys) uint32, bucket int32) — the single-column contract."""
    if keys.device.type == "cpu":
        return ref.hash_partition_ref(keys, num_partitions=num_partitions, seed=seed)
    return kernel.hash_partition(keys, num_partitions=num_partitions, seed=seed)
