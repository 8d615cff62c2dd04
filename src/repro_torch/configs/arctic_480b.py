"""arctic-480b [moe] — Snowflake Arctic: 128 experts top-2 + dense residual FFN.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,            # dense residual path hidden
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    rope_theta=10000.0,
)
