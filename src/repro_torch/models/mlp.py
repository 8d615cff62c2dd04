"""Dense FFN of the port: SwiGLU ``act(x @ wg) * (x @ wi) @ wo`` (the gate is
``wg``), or ``act(x @ wi) @ wo`` when the config has no gate; with
``cfg.use_bias`` each matrix has a bias, added after its matmul.  Under a
sharding context whose model axis splits ``mlp``, ``wi``/``wg`` are column-
and ``wo`` row-parallel (``parallel.tpmm``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_spec, depth_scale
from repro_torch.parallel.tpmm import col_proj_tp, down_proj_tp


def mlp_spec(cfg):
    d, f, bias = cfg.d_model, cfg.d_ff, cfg.use_bias
    spec = {"wi": dense_spec((d, f), ("embed", "mlp"), bias),
            "wo": dense_spec((f, d), ("mlp", "embed"), bias,
                             scale=depth_scale(cfg))}
    if cfg.act == "silu":
        spec["wg"] = dense_spec((d, f), ("embed", "mlp"), bias)
    return spec


def mlp(p, cfg, x, tp_shardmap: bool = False):
    """Weights (and biases) are cast to x's dtype at each use (a no-op for
    leaves stored in it), as JAX casts its fp32 masters.  Tensor-parallel
    reductions run in fp32, or with ``tp_shardmap`` in the compute dtype."""
    act = activation(cfg.act)
    psum = None if tp_shardmap else torch.float32

    def up(q):
        return col_proj_tp(x, q["kernel"], q.get("bias"), psum_dtype=psum)

    h = up(p["wi"])
    h = act(up(p["wg"])) * h if "wg" in p else act(h)
    return down_proj_tp(h, p["wo"]["kernel"], p["wo"].get("bias"),
                        psum_dtype=psum)
