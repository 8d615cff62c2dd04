"""Dense decoder-only transformer of the port (counterpart of the dense
family of the JAX ``repro.models.transformer``).

Layers are stacked along a leading dim of every parameter and applied in a
Python loop.  Two entry points share the weights:

* ``forward``     — full sequence (training; prefill when ``collect_cache``)
* ``decode_step`` — one token per slot at (B,) positions over a paged cache,
  whose pools it updates in place
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (DTYPES, P, norm_spec, rms_norm,
                                       stack_spec)


@dataclass(frozen=True)
class ForwardOpts:
    attn_impl: str = "flash"      # flash (K2) | dense (reference) | blockwise
    norm_impl: str = "kernel"     # kernel (K3) | plain (reference)
    q_chunk: int = 1024           # blockwise attention chunks
    kv_chunk: int = 1024
    remat: str = "none"           # the JAX trainer's "none"; nothing else
    xent_impl: str = "kernel"     # loss: kernel (K4) | plain (reference)

    def __post_init__(self):
        if self.remat != "none":
            raise ValueError(f"remat={self.remat!r}: the port keeps every "
                             "activation (remat 'none' only)")


def layer_spec(cfg):
    return {"ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}


def build_spec(cfg):
    assert cfg.family == "dense", (
        f"the port serves the dense family only (got {cfg.family})")
    d, v = cfg.d_model, cfg.padded_vocab
    spec = {"embed": {"table": P((v, d))},
            "layers": stack_spec(layer_spec(cfg), cfg.num_layers),
            "final_norm": norm_spec(cfg)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"kernel": P((d, v))}
    return spec


def layer_params(params, i: int):
    """Layer ``i``'s parameters: views into the stacked tensors."""
    def pick(t):
        return t[i] if isinstance(t, torch.Tensor) else \
            {k: pick(v) for k, v in t.items()}
    return pick(params["layers"])


def embed(params, cfg, tokens):
    """Token embedding in the compute dtype (``cfg.dtype``)."""
    return params["embed"]["table"][tokens].to(DTYPES[cfg.dtype])


def unembed(params, cfg, h, norm_impl: str = "kernel"):
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps, norm_impl)
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].to(h.dtype).T
    return h @ params["lm_head"]["kernel"].to(h.dtype)


def forward(params, cfg, tokens, opts: ForwardOpts = ForwardOpts(),
            collect_cache: bool = False):
    """tokens (B, S).  Returns (logits (B, S, Vp), cache | None) where cache
    is ``{"layers": {"k": (L, B, S, KV, D), "v": ...}}``."""
    h = embed(params, cfg, tokens)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        a_in = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps, opts.norm_impl)
        a, (k, v) = attn.attention_block(lp["attn"], cfg, a_in,
                                         impl=opts.attn_impl,
                                         norm_impl=opts.norm_impl,
                                         q_chunk=opts.q_chunk,
                                         kv_chunk=opts.kv_chunk)
        h = h + a
        f_in = rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps, opts.norm_impl)
        h = h + mlp_mod.mlp(lp["mlp"], cfg, f_in)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    logits = unembed(params, cfg, h, opts.norm_impl)
    cache = ({"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
             if collect_cache else None)
    return logits, cache


def decode_step(params, cfg, tokens, cache, positions,
                decode_impl: str = "kernel", norm_impl: str = "kernel"):
    """One token per slot.  tokens (B, 1); positions (B,) int32; cache is a
    paged view ``{"layers": {"k": (L, P, page, KV, D), "v": ...},
    "page_table": (B, M) int32}`` whose pools are written in place; int8
    pools come with ``"k_scale"``/``"v_scale"`` (L, P, page, KV) fp32,
    which each layer's attention block is handed.  Returns (logits
    (B, 1, Vp), cache)."""
    page_table = cache["page_table"]
    pools = cache["layers"]
    quantized = "k_scale" in pools
    h = embed(params, cfg, tokens)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        a_in = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps, norm_impl)
        scales = ({"k_scale": pools["k_scale"][i],
                   "v_scale": pools["v_scale"][i]} if quantized else {})
        h = h + attn.attention_decode_block(
            lp["attn"], cfg, a_in, pools["k"][i], pools["v"][i], positions,
            page_table, decode_impl=decode_impl, norm_impl=norm_impl,
            **scales)
        f_in = rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps, norm_impl)
        h = h + mlp_mod.mlp(lp["mlp"], cfg, f_in)
    return unembed(params, cfg, h, norm_impl), cache
