"""internvl2-2b [vlm]: InternViT stub + InternLM2 backbone: 24L d2048 16H
(GQA kv=8) ff8192 vocab92553. [arXiv:2404.16821]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    frontend="vit-stub",         # input_specs() supplies patch embeddings
    frontend_tokens=256,
)
