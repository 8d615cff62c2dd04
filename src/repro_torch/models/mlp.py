"""Dense FFN of the port: SwiGLU ``act(x @ wg) * (x @ wi) @ wo`` (the gate is
``wg``), or ``act(x @ wi) @ wo`` when the config has no gate; with
``cfg.use_bias`` each matrix has a bias, added after its matmul."""
from __future__ import annotations

from repro_torch.models.common import activation, add_bias, dense_spec, \
    depth_scale


def mlp_spec(cfg):
    d, f, bias = cfg.d_model, cfg.d_ff, cfg.use_bias
    spec = {"wi": dense_spec((d, f), bias),
            "wo": dense_spec((f, d), bias, scale=depth_scale(cfg))}
    if cfg.act == "silu":
        spec["wg"] = dense_spec((d, f), bias)
    return spec


def mlp(p, cfg, x):
    """Weights (and biases) are cast to x's dtype at each use (a no-op for
    leaves stored in it), as JAX casts its fp32 masters."""
    act = activation(cfg.act)

    def dense(q, y):
        return add_bias(q, y @ q["kernel"].to(y.dtype))

    h = dense(p["wi"], x)
    h = act(dense(p["wg"], x)) * h if "wg" in p else act(h)
    return dense(p["wo"], h)
