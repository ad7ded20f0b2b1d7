"""kimi-k2-1t-a32b [moe]: 61L d7168 64H (GQA kv=8) expert-ff2048
vocab163840, 384 experts top-8 + 1 shared — trillion-param MoE.
[arXiv:2501.kimi2; paper-table entry]

Memory posture: 1T params on 512 v5e chips requires int8-quantized AdamW
state (EXPERIMENTS.md §Perf documents the fit math)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    opt_state_dtype="int8",
    param_dtype="bfloat16",   # 1T params: bf16 store + f32 optimizer math
    moe_pad_experts=128,      # 384 -> 512 = 2 experts per rank on the joint
                              # 256-way ('data','model') EP axis
)
