"""Dense FFN of the port: SwiGLU ``act(x @ wg) * (x @ wi) @ wo`` (the gate is
``wg``), or ``act(x @ wi) @ wo`` when the config has no gate."""
from __future__ import annotations

from repro_torch.models.common import P, activation, depth_scale


def mlp_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    assert not cfg.use_bias, "the port's dense configs have no biases"
    spec = {"wi": {"kernel": P((d, f))},
            "wo": {"kernel": P((f, d), scale=depth_scale(cfg))}}
    if cfg.act == "silu":
        spec["wg"] = {"kernel": P((d, f))}
    return spec


def mlp(p, cfg, x):
    """Weights are cast to x's dtype at each use (a no-op for weights stored
    in it), as JAX casts its fp32 masters."""
    act = activation(cfg.act)
    h = x @ p["wi"]["kernel"].to(x.dtype)
    h = act(x @ p["wg"]["kernel"].to(x.dtype)) * h if "wg" in p else act(h)
    return h @ p["wo"]["kernel"].to(x.dtype)
