"""internvl2-2b [vlm] — InternViT + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The ViT frontend is a STUB: a request or a batch carries precomputed patch
embeddings (num_image_tokens per image) prepended to the text sequence.
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    num_image_tokens=256,
    rope_theta=1000000.0,
)
