"""Plain PyTorch version of the sorted-segment sum (``csrc/segment_reduce.cu``)."""

from __future__ import annotations

import torch


def segment_sum_ref(
    seg_ids: torch.Tensor, values: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """[num_segments] sums in the values' dtype (int32 wraps mod 2^32); ids
    outside [0, num_segments) are dropped, as ``jax.ops.segment_sum`` does."""
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids[keep], values[keep])
