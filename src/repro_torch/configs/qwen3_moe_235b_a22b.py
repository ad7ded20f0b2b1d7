"""qwen3-moe-235b-a22b [moe]: 94L d4096 64H (GQA kv=4) expert-ff1536
vocab151936, 128 experts top-8. [hf:Qwen/Qwen3-235B-A22B]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    param_dtype="bfloat16",
    moe_pad_experts=128,      # 128 -> 256 = 1 expert per rank on the joint EP axis
)
