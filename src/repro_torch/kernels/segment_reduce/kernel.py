"""Launch wrapper for ``csrc/segment_reduce.cu`` (CUDA tensors only)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

_ENTRY = {torch.int32: "rt_segment_sum_i32", torch.float32: "rt_segment_sum_f32"}


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments] sums of int32 or float32 ``values`` over sorted int32
    ``seg_ids``, in the values' dtype; drops no row at any segment density."""
    global launches
    dev = _build.require_cuda("segment_sum", seg_ids, values)
    if seg_ids.dim() != 1 or seg_ids.dtype != torch.int32:
        raise ValueError(f"seg_ids must be 1-D int32, got {tuple(seg_ids.shape)} {seg_ids.dtype}")
    if values.shape != seg_ids.shape or values.dtype not in _ENTRY:
        raise ValueError(
            f"values must be int32/float32 shaped like seg_ids, got "
            f"{tuple(values.shape)} {values.dtype}"
        )
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    out = torch.empty(num_segments, dtype=values.dtype, device=dev)
    rc = getattr(_build.library(), _ENTRY[values.dtype])(
        seg_ids.data_ptr(), values.data_ptr(), seg_ids.shape[0], num_segments, out.data_ptr(),
        _build.stream(dev),
    )
    _build.check(rc, "segment_reduce.segment_sum")
    launches += 1
    return out
