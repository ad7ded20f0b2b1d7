"""Plain PyTorch version of the sorted probe (``csrc/join_probe.cu``)."""

from __future__ import annotations

import torch


def probe_sorted_ref(right_keys: torch.Tensor, left_keys: torch.Tensor):
    """(lower-bound position clipped to the page [n] int32, hit [n] bool)."""
    pos = torch.searchsorted(right_keys, left_keys, out_int32=True)
    pos_c = pos.clamp(0, right_keys.shape[0] - 1)
    return pos_c, right_keys[pos_c] == left_keys
