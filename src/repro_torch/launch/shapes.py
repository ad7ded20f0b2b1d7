"""Assigned input-shape cells and their allocation-free trees — the port of
``repro.launch.shapes``.

Four cells per architecture (40 total):

- train_4k     : seq 4,096   global_batch 256   -> train_step
- prefill_32k  : seq 32,768  global_batch 32    -> prefill (serve)
- decode_32k   : seq 32,768  global_batch 128   -> serve_step (1 new token,
                 KV cache of seq_len)
- long_500k    : seq 524,288 global_batch 1     -> serve_step; requires
                 sub-quadratic attention

Every tree here lives on the meta device (shapes and dtypes, no storage):
the model inputs (``input_specs``), the decode state
(``decode_state_specs``), the parameters as training holds them
(``params_specs``: float32 masters) and the optimizer state
(``opt_state_specs``, float32 or int8 moments).  The sharding rules
(``dist.sharding``) read them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    # memory knobs (per-cell)
    microbatches: int = 1


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256, microbatches=4),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# per-arch microbatch overrides for train_4k (memory fit)
TRAIN_MICROBATCH = {
    "qwen3-moe-235b-a22b": 8,
    "kimi-k2-1t-a32b": 8,
}


def cell_supported(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """40-cell applicability matrix."""
    if cell.name == "long_500k" and cfg.family == "audio":
        return False, "long_500k skipped: enc-dec operating regime is <=1500 source frames"
    if cell.name == "long_500k" and not cfg.has_subquadratic_attention:
        return False, "long_500k skipped: pure full-attention family"
    return True, ""


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Model inputs of one cell as meta tensors."""
    b = cell.global_batch
    s = cell.seq_len if cell.kind != "decode" else 1
    specs = {"tokens": _meta((b, s), torch.int32)}
    if cell.kind == "train":
        specs["mask"] = _meta((b, s), torch.float32)
    if cfg.family == "audio":
        specs["frames"] = _meta((b, cfg.source_positions, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm" and cell.kind != "decode":
        specs["patches"] = _meta((b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    return specs


def decode_state_specs(cfg: ArchConfig, cell: ShapeCell):
    """The decode state (KV cache / recurrent state) of a cell on the meta
    device (a cache's ``len`` is the host int the port keeps)."""
    return api.init_decode_state(cfg, cell.global_batch, cell.seq_len, device="meta")


def params_specs(cfg: ArchConfig) -> dict:
    """The parameter tree on the meta device, as training holds it: every
    leaf in ``cfg.param_dtype`` (the reference's ``init_params`` tree)."""
    return api.init_params(cfg, None, device="meta", master=True)


def opt_state_specs(cfg: ArchConfig, state_dtype: str = "float32") -> dict:
    """The AdamW state of ``params_specs(cfg)`` on the meta device: float32
    moments, or int8 blocks with float32 scales (``state_dtype="int8"``)."""
    return optimizer.init_state(params_specs(cfg), optimizer.OptConfig(state_dtype=state_dtype))
