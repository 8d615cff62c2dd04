"""Config registry of the port: ``get_config(name)`` / ``--arch <id>``.

The dense decoder configs the port serves and trains (qwen3-4b,
llama3.2-3b, llama3-405b, starcoder2-3b and the paper's Granite family,
the last two with LayerNorm, GELU and biases), the vlm config it serves
and trains with a stub image prefix (internvl2-2b), the MoE configs it
serves and trains (moonshot-v1-16b-a3b; arctic-480b, with its dense
residual FFN), the recurrent configs it trains and whose forward, eval,
prefill and decode it runs (zamba2-1.2b, hybrid; rwkv6-1.6b, ssm), and
the encoder-decoder config it trains and prefills and decodes over its
dense cache behind a stub audio frontend (seamless-m4t-large-v2).  Their files are copies of the JAX
package's, values unchanged (the port is held to the JAX package, not to
the hub configs the files cite).  ``ASSIGNED_ARCHS`` and ``PAPER_ARCHS``
split the registry as JAX's does; the dry-run iterates the first over
``SHAPES``."""
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.base import (ModelConfig, ParallelConfig, RunConfig,
                                     ShapeConfig, TrainConfig)
from repro_torch.configs.granite import GRANITE_8B, GRANITE_13B, GRANITE_20B
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.llama3_2_3b import CONFIG as _llama32
from repro_torch.configs.llama3_405b import CONFIG as _llama405
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.shapes import SHAPES, applicable, get_shape
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

ASSIGNED_ARCHS = {
    c.name: c
    for c in (_arctic, _moonshot, _zamba2, _llama32, _starcoder2,
              _llama405, _qwen3, _rwkv6, _seamless, _internvl2)
}

PAPER_ARCHS = {c.name: c for c in (GRANITE_8B, GRANITE_13B, GRANITE_20B)}

CONFIGS = {**ASSIGNED_ARCHS, **PAPER_ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def list_configs(assigned_only: bool = False):
    return sorted(ASSIGNED_ARCHS if assigned_only else CONFIGS)


def archs(*families: str):
    """The registered arch names of ``families``, sorted: the ``--arch``
    choices of a launcher that runs only those families."""
    return sorted(n for n, c in CONFIGS.items() if c.family in families)


__all__ = [
    "ModelConfig", "ParallelConfig", "RunConfig", "ShapeConfig", "TrainConfig",
    "SHAPES", "applicable", "get_shape", "get_config", "list_configs",
    "ASSIGNED_ARCHS", "PAPER_ARCHS", "CONFIGS", "archs",
]
