"""The assigned input-shape set (identical across the LM-family archs): a
copy of the JAX package's ``configs/shapes.py``, values and rules
unchanged."""
from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable(model_cfg, shape: ShapeConfig) -> bool:
    """Shape-cell applicability rules.

    long_500k needs sub-quadratic attention state: run for ssm/hybrid only.
    """
    if shape.name == "long_500k":
        return model_cfg.sub_quadratic
    if shape.kind == "decode" and not model_cfg.has_decoder:
        return False
    return True
