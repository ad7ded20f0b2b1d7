"""starcoder2-3b [dense]: 30L d3072 24H (GQA kv=2) ff12288 vocab49152,
GQA + RoPE. [arXiv:2402.19173]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    act="gelu",
    rope_theta=100_000.0,
)
