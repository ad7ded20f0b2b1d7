"""rwkv6-7b "Finch" [ssm]: 32L d4096 (attention-free) ff14336 vocab65536,
data-dependent decay. [arXiv:2404.05892]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                # d_model / rwkv_head_size
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_size=64,
)
