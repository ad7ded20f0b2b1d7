"""Unified architecture configuration for the 10 assigned model families:
the port's own copy of ``repro.models.config``.

One dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM; family-
specific fields are None/0 when unused.  ``repro_torch/configs/<id>.py``
holds the exact assigned configs; smoke tests shrink them via ``reduced()``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 => d_model // num_heads

    # -- attention pattern ----------------------------------------------------
    sliding_window: int = 0                # 0 => full attention
    local_global_ratio: int = 0            # gemma3: 5 => [L,L,L,L,L,G] repeating
    global_window: int = 0                 # window for 'G' layers (0=full)
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0              # gemma-style logit soft-capping
    qk_norm: bool = False

    # -- MoE --------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                      # per-expert hidden dim
    n_shared_experts: int = 0              # dense(shared) experts alongside routed
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # -- recurrent families -----------------------------------------------------
    # hybrid (recurrentgemma): block pattern, e.g. ("rec", "rec", "attn")
    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0                     # RG-LRU state width (0 => d_model)
    conv_width: int = 4
    # rwkv6: head size for the wkv state
    rwkv_head_size: int = 64

    # -- encoder-decoder ----------------------------------------------------------
    encoder_layers: int = 0
    source_positions: int = 0              # encoder sequence length (frames)

    # -- modality frontend stub ---------------------------------------------------
    frontend: str = ""                     # "vit-stub" | "conv-stub"
    frontend_tokens: int = 0               # prefix positions fed by input_specs()

    # -- misc -----------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    schedule: str = "cosine"               # minicpm: "wsd"
    dtype: str = "bfloat16"
    # training-memory knobs (per-cell tuning lives in launch/shapes.py)
    remat: bool = True
    # distributed-optimizer knobs
    zero_partition: bool = True            # shard optimizer state over dp axes
    opt_state_dtype: str = "float32"       # "int8" => block-quantized AdamW state
    grad_compression: bool = False         # int8 + error feedback on dp all-reduce
    param_dtype: str = "float32"           # "bfloat16" => bf16 weight storage
                                           # (optimizer math stays f32)
    seq_shard_activations: bool = False    # Megatron-SP: residual stream
                                           # sequence-sharded over 'model'
                                           # between blocks (hillclimb G1)
    moe_pad_experts: int = 0               # pad experts so E divides the joint
                                           # ('data','model') EP axis (hillclimb K2)

    # -------------------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_experts_padded(self) -> int:
        return self.num_experts + self.moe_pad_experts

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_attention(self) -> bool:
        """Eligibility for long_500k (DESIGN.md §Arch-applicability)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window and self.local_global_ratio == 0:
            return True  # all-SWA (h2o-danube)
        if self.local_global_ratio > 0:
            return True  # mostly-local (gemma3); global layers decode O(S) w/ sharded KV
        return False

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer temporal-block kind: 'attn' | 'rec' | 'local'/'global'."""
        if self.family == "hybrid" and self.block_pattern:
            reps = -(-self.num_layers // len(self.block_pattern))
            return tuple((self.block_pattern * reps)[: self.num_layers])
        if self.local_global_ratio > 0:
            pat = ("local",) * self.local_global_ratio + ("global",)
            reps = -(-self.num_layers // len(pat))
            return tuple((pat * reps)[: self.num_layers])
        return ("attn",) * self.num_layers

    def param_count(self) -> int:
        """Exact parameter count of this implementation (N for 6*N*D):
        counted from the shapes ``init_params`` makes on the meta device —
        no allocation."""
        from repro_torch.models import api as _api

        params = _api.init_params(self, None, device="meta")
        total = sum(t.numel() for t in _api.tree_leaves(params))
        # dead (padding) experts are storage, not model parameters
        total -= self.num_layers * self.moe_pad_experts * 3 * self.d_model * self.moe_d_ff
        return int(total)

    def _param_count_analytic(self) -> int:
        """Analytic parameter count (cross-check for tests)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * self.num_heads * 2 + d * hd * self.num_kv_heads * 2
        dense_mlp = 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = []
        for kind in self.layer_kinds():
            p = 2 * d  # norms
            if kind in ("attn", "local", "global"):
                p += attn
            elif kind == "rec":
                w = self.lru_width or d
                p += 2 * d * w + w * d + 3 * w + self.conv_width * w
            if self.family == "moe":
                p += d * self.num_experts
                p += self.num_experts * 3 * d * self.moe_d_ff
                p += self.n_shared_experts * 3 * d * self.moe_d_ff
            elif self.family == "ssm":
                # rwkv6 time-mix + channel-mix
                p += 4 * d * d + 2 * d * 64 + 5 * d  # r,k,v,o + decay lora + mixes
                p += 2 * d * self.d_ff + d * d
            else:
                p += dense_mlp
            per_layer.append(p)
        total = sum(per_layer) + emb + d
        if self.encoder_layers:
            total += self.encoder_layers * (attn + dense_mlp + 2 * d)
            # decoder cross-attention
            total += self.num_layers * (attn + d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only) for 6*N_active*D."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()  # already excludes padding experts
        all_experts = self.num_layers * self.num_experts * 3 * d * self.moe_d_ff
        active_experts = self.num_layers * self.experts_per_token * 3 * d * self.moe_d_ff
        return int(full - all_experts + active_experts)

    def reduced(self, **overrides) -> ArchConfig:
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 4 if not self.block_pattern else 2 * max(1, len(self.block_pattern))),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // max(self.num_heads, 1)) or 1),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            global_window=0,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            moe_pad_experts=0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            lru_width=128 if self.lru_width else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            source_positions=16 if self.source_positions else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
            rwkv_head_size=32,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
