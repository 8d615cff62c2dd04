"""moonshot-v1-16b-a3b [moe] — Moonlight 16B-A3B: 64 experts top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    rope_theta=50000.0,
)
