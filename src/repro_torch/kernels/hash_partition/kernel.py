"""Launch wrappers for ``csrc/hash_partition.cu`` (CUDA tensors only).

``launches`` counts launches of the row-bucket/histogram kernel (the main
path: every shuffle); ``single_launches`` counts the single-column
``hash_partition`` entry.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hash_partition.ref import seed_mixed

launches = 0
single_launches = 0

MAX_KEY_COLS = 4
MAX_PARTITIONS = 8192  # the histogram is (P+1) ints of shared memory per block
_KEY_DTYPES = {torch.int32: 4, torch.uint32: 4, torch.int64: 8}


def _check_partitions(num_partitions: int) -> None:
    if not 1 <= num_partitions <= MAX_PARTITIONS:
        raise ValueError(f"num_partitions must be in [1, {MAX_PARTITIONS}], got {num_partitions}")


def row_buckets(
    key_cols: list[torch.Tensor],
    num_partitions: int,
    count: torch.Tensor | None,
    seed: int = 0,
    *,
    want_hash: bool = False,
    want_buckets: bool = True,
    want_hist: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """(row hash [n] uint32, bucket [n] int32, histogram [P+1] int32), each
    None unless asked for.  Rows at index >= ``count`` (a 0-d int32 tensor
    read on the device; None means all rows) go to bucket ``num_partitions``."""
    global launches
    if not 1 <= len(key_cols) <= MAX_KEY_COLS:
        raise ValueError(f"need 1..{MAX_KEY_COLS} key columns, got {len(key_cols)}")
    _check_partitions(num_partitions)
    extra = [] if count is None else [count]
    dev = _build.require_cuda("row_buckets", *key_cols, *extra)
    n = key_cols[0].shape[0]
    for col in key_cols:
        if col.dim() != 1 or col.shape[0] != n or col.dtype not in _KEY_DTYPES:
            raise ValueError(
                f"key columns must be 1-D int32/uint32/int64 of {n} rows, "
                f"got {tuple(col.shape)} {col.dtype}"
            )
    if count is not None and (count.dtype != torch.int32 or count.numel() != 1):
        raise ValueError("count must be a 0-d int32 tensor")
    h = torch.empty(n, dtype=torch.uint32, device=dev) if want_hash else None
    b = torch.empty(n, dtype=torch.int32, device=dev) if want_buckets else None
    hist = torch.empty(num_partitions + 1, dtype=torch.int32, device=dev) if want_hist else None
    ptrs = [c.data_ptr() for c in key_cols] + [None] * (MAX_KEY_COLS - len(key_cols))
    widths = [_KEY_DTYPES[c.dtype] for c in key_cols] + [0] * (MAX_KEY_COLS - len(key_cols))
    rc = _build.library().rt_hash_row_buckets(
        *ptrs, *widths, len(key_cols), n, seed & 0xFFFFFFFF, seed_mixed(seed),
        num_partitions, _build.ptr(count), _build.ptr(h), _build.ptr(b), _build.ptr(hist),
        _build.stream(dev),
    )
    _build.check(rc, "hash_partition.row_buckets")
    launches += 1
    return h, b, hist


def hash_partition(
    keys: torch.Tensor, *, num_partitions: int, seed: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hash32(keys) [n] uint32, hash % P [n] int32) for int32/uint32 keys."""
    global single_launches
    _check_partitions(num_partitions)
    dev = _build.require_cuda("hash_partition", keys)
    if keys.dim() != 1 or keys.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"keys must be 1-D int32/uint32, got {tuple(keys.shape)} {keys.dtype}")
    n = keys.shape[0]
    h = torch.empty(n, dtype=torch.uint32, device=dev)
    b = torch.empty(n, dtype=torch.int32, device=dev)
    rc = _build.library().rt_hash_partition(
        keys.data_ptr(), n, seed_mixed(seed), num_partitions, h.data_ptr(), b.data_ptr(),
        _build.stream(dev),
    )
    _build.check(rc, "hash_partition.hash_partition")
    single_launches += 1
    return h, b
