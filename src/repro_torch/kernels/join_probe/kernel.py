"""Launch wrapper for ``csrc/join_probe.cu`` (CUDA tensors only)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

FAN = 8          # csrc kFan: keys per sector, the index's fan-out per level
TOP_MAX = 8192   # csrc kTopMax: keys of the top level, held in shared memory


def index_entries(page: int) -> int:
    """int32 entries of the search index below the top level for a page of
    ``page`` keys: level k holds every FAN**k-th key, padded to whole
    sectors, down from the first level of at most TOP_MAX keys."""
    total, n = 0, page
    while n > TOP_MAX:
        n = -(-n // FAN)
        total += -(-n // FAN) * FAN
    return total


def probe_sorted(right_keys: torch.Tensor, left_keys: torch.Tensor):
    """(lower-bound position clipped to the page [n] int32, hit [n] bool) of
    each left key in the sorted int32 right page; no page-size cap."""
    global launches
    dev = _build.require_cuda("probe_sorted", right_keys, left_keys)
    for name, t in (("right_keys", right_keys), ("left_keys", left_keys)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be 1-D int32, got {tuple(t.shape)} {t.dtype}")
    page = right_keys.shape[0]
    if not 1 <= page < 2**31:
        raise ValueError(f"page must hold 1..2**31-1 keys, got {page}")
    n = left_keys.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    entries = index_entries(page)
    scratch = torch.empty(max(entries, 1), dtype=torch.int32, device=dev)
    rc = _build.library().rt_probe_sorted(
        right_keys.data_ptr(), page, left_keys.data_ptr(), n, idx.data_ptr(), hit.data_ptr(),
        scratch.data_ptr(), entries, _build.stream(dev),
    )
    _build.check(rc, "join_probe.probe_sorted")
    launches += 1
    return idx, hit
