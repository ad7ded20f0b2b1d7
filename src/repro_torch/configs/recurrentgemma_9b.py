"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) ff12288 vocab256000,
RG-LRU + local attention 2:1. [arXiv:2402.19427]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    sliding_window=2048,
    tie_embeddings=True,
    act="gelu",
)
