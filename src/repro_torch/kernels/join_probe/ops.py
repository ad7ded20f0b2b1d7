"""Public sorted-probe op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.join_probe import kernel, ref


def probe_sorted(right_keys: torch.Tensor, left_keys: torch.Tensor):
    if right_keys.device.type == "cpu":
        return ref.probe_sorted_ref(right_keys, left_keys)
    return kernel.probe_sorted(right_keys, left_keys)
