"""Plain PyTorch version of the hash/bucket kernel (``csrc/hash_partition.cu``).

PyTorch on the CPU has no ``>>``, ``<<``, ``%`` or ``+`` for ``uint32``, so
the uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF`` after every
operation that can leave 32 bits; the results are bit-exact with the
reference's uint32 arithmetic and come back as int64 holding the uint32 value.
The same code runs on any device.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
SEED_MIX = 0x9E3779B9
ROW_SEED = 0x51ED270B


def seed_mixed(seed: int) -> int:
    """``uint32(seed) * 0x9E3779B9 + 1`` wrapped to 32 bits."""
    return ((seed & MASK) * SEED_MIX + 1) & MASK


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer keys as their uint32 bit pattern, held in int64 (two's
    complement for negatives; the low 32 bits of an int64)."""
    return x.to(torch.int64) & MASK


def hash32_u32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3 finalizer; int64 in, int64 holding the uint32 hash out."""
    h = as_u32(x) ^ seed_mixed(seed)
    h = h ^ (h >> 16)
    h = (h * M1) & MASK
    h = h ^ (h >> 13)
    h = (h * M2) & MASK
    return h ^ (h >> 16)


def row_hash_u32(key_cols: list[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """Boost-style combined row hash of ``hash_columns``."""
    n = key_cols[0].shape[0]
    h = torch.full((n,), (seed & MASK) ^ ROW_SEED, dtype=torch.int64, device=key_cols[0].device)
    for col in key_cols:
        ch = hash32_u32(col, seed)
        h = h ^ ((ch + SEED_MIX + ((h << 6) & MASK) + (h >> 2)) & MASK)
    return h


def row_buckets_ref(
    key_cols: list[torch.Tensor], num_partitions: int, count: torch.Tensor, seed: int = 0,
    with_hist: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(bucket [n] int32 with padding rows at ``num_partitions``, histogram
    [P+1] int32 or None) — what ``hash_partition.cu`` computes."""
    h = row_hash_u32(key_cols, seed)
    valid = torch.arange(h.shape[0], device=h.device) < count
    b = torch.where(valid, h % num_partitions, num_partitions).to(torch.int32)
    hist = None
    if with_hist:
        hist = torch.bincount(b, minlength=num_partitions + 1).to(torch.int32)
    return b, hist


def hash_partition_ref(
    keys: torch.Tensor, *, num_partitions: int, seed: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hash32(keys) as uint32, hash % P as int32) — kernel.py:36's contract."""
    h = hash32_u32(keys, seed)
    return h.to(torch.uint32), (h % num_partitions).to(torch.int32)
