"""Assigned architecture configs: the port's own copy of ``repro.configs``
(the same data, one module per architecture).

``get(name)`` returns the exact assigned ArchConfig; ``REGISTRY`` lists all.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "gemma3-4b",
    "minicpm-2b",
    "starcoder2-3b",
    "h2o-danube-3-4b",
    "internvl2-2b",
    "qwen3-moe-235b-a22b",
    "kimi-k2-1t-a32b",
    "rwkv6-7b",
    "recurrentgemma-9b",
    "whisper-medium",
)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


REGISTRY = {a: a for a in ARCH_IDS}
