"""llama3-405b [dense] — GQA, 128k vocab; the paper-representative frontier config.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
[arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
)
