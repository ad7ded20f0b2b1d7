"""whisper-medium [audio]: enc-dec 24+24L d1024 16H ff4096 vocab51865,
conv frontend STUB (input_specs supplies frame embeddings).
[arXiv:2212.04356]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,               # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    source_positions=1500,
    frontend="conv-stub",
    tie_embeddings=True,
    act="gelu",
)
