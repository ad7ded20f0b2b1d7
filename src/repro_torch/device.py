"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card (``cuda``) and raises when there is none;
    the CPU is used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for every kernel queued on ``device`` (a no-op on the CPU).

    A function that launches kernels returns before they run, so a host
    stamp taken after it times the launches, not the work: the port's
    compute-measurement points (``core/bsp.py``, ``jobs/executor.py``) call
    this before each stamp."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
