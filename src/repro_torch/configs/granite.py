"""The paper's own Granite model family (Table 2) [arXiv:2405.04324].

granite-20b-code was trained on Vela with 4-way TP, 4-way PP, 48-way DP (768 GPUs).
These configs drive the paper-claims benchmarks (Tables 2 & 4, Fig 7).
"""
from repro_torch.configs.base import ModelConfig

GRANITE_8B = ModelConfig(
    name="granite-8b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
)

GRANITE_13B = ModelConfig(
    name="granite-13b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=20480,
    vocab_size=49152,
    act="gelu",
    norm="layernorm",
    use_bias=True,
)

GRANITE_20B = ModelConfig(
    name="granite-20b-code",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,       # MQA (GPT-BigCode style)
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    norm="layernorm",
    use_bias=True,
)
