"""gemma3-4b [dense]: 34L d2560 8H (GQA kv=4) ff10240 vocab262144,
5:1 local:global, 128k context. [hf:google/gemma-3-*-pt]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    local_global_ratio=5,        # [L,L,L,L,L,G] repeating
    sliding_window=1024,
    global_window=0,             # global layers: full attention
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
)
