"""Public segment-sum op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import kernel, ref


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sorted-segment sum in the values' dtype."""
    if values.device.type == "cpu":
        return ref.segment_sum_ref(seg_ids, values, num_segments)
    return kernel.segment_sum(seg_ids, values, num_segments)
