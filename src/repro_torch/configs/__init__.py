"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

Only the dense decoder configs the port serves are registered.  Their files
are copies of the JAX package's, values unchanged (the port is held to the
JAX package, not to the hub configs the files cite)."""
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3

CONFIGS = {c.name: c for c in (_qwen3, _llama32)}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


__all__ = ["CONFIGS", "ModelConfig", "TrainConfig", "get_config"]
