"""h2o-danube-3-4b [dense]: 24L d3840 32H (GQA kv=8) ff10240 vocab32000,
llama+mistral mix with SWA. [arXiv:2401.16818]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,         # all layers SWA (mistral-style)
)
