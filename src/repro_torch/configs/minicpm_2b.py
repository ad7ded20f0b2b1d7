"""minicpm-2b [dense]: 40L d2304 36H (MHA) ff5760 vocab122753, WSD schedule
(llama-like arch). [arXiv:2404.06395]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    tie_embeddings=True,
    schedule="wsd",              # warmup-stable-decay (the MiniCPM contribution)
)
