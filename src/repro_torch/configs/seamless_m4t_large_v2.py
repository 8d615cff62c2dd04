"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal backbone.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
The modality frontend is a STUB: input_specs() provides precomputed frame
embeddings of length seq_len // enc_ratio.
[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    source="arXiv:2308.11596",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    enc_ratio=4,
    norm="layernorm",
    act="gelu",
    use_bias=True,
)
