"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
[arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm="layernorm",
)
