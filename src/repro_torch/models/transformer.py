"""Decoder-only stack of the port: the dense, hybrid (zamba2) and ssm
(rwkv6) families of the JAX ``repro.models.transformer``.

Layers are stacked along a leading dim of every parameter and applied in a
Python loop.  Three entry points share the weights:

* ``forward``     — full sequence (training and eval; prefill when
  ``collect_cache``, for the dense family only)
* ``decode_step`` — one token per slot at (B,) positions over a paged cache,
  whose pools it updates in place (dense family only), over this rank's
  shards of pools split over a ``PoolGroup``, or over the dense cache of
  ``init_cache`` (the contiguous layout)
* ``prefill_chunk`` — a (B, C) chunk of prompt tokens at per-request
  offsets over a paged cache (dense family only), the chunked prefill

The recurrent families run forward only: their prefill (final states) and
decode step wait for ROADMAP Queue 1 item 16's "decode states".
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, rwkv6
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (DTYPES, P, apply_norm, norm_spec,
                                       rms_norm, stack_spec)

RECURRENT = ("hybrid", "ssm")


@dataclass(frozen=True)
class ForwardOpts:
    attn_impl: str = "flash"      # flash (K2) | dense (reference) | blockwise
    norm_impl: str = "kernel"     # kernel (K3) | plain (reference)
    q_chunk: int = 1024           # blockwise attention chunks
    kv_chunk: int = 1024
    remat: str = "none"           # the JAX trainer's "none"; nothing else
    xent_impl: str = "kernel"     # loss: kernel (K4) | plain (reference)
    mixer_impl: str = "kernel"    # mamba2 SSD / rwkv6 WKV: kernel (K6/K7) |
    #                               plain (the JAX models' chunked forms)

    def __post_init__(self):
        if self.remat != "none":
            raise ValueError(f"remat={self.remat!r}: the port keeps every "
                             "activation (remat 'none' only)")


def refuse_recurrent(cfg, what: str) -> None:
    """Raise for a family whose ``what`` the port does not run yet."""
    if cfg.family in RECURRENT:
        raise NotImplementedError(
            f"{what} for the {cfg.family} family ({cfg.name}): the port runs "
            "its full-sequence forward and eval only; prefill, decode and "
            "training are the next slices (ROADMAP Queue 1 item 16)")


def layer_spec(cfg):
    fam = cfg.family
    if fam == "dense":
        return {"ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
                "ln2": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}
    if fam == "ssm":
        return {"ln1": norm_spec(cfg), "tmix": rwkv6.tmix_spec(cfg),
                "ln2": norm_spec(cfg), "cmix": rwkv6.cmix_spec(cfg)}
    if fam == "hybrid":
        return {"ln1": norm_spec(cfg), "mamba": mamba2.mamba_spec(cfg)}
    raise ValueError(f"the port runs the dense, hybrid and ssm families "
                     f"(got {fam})")


def shared_block_spec(cfg):
    """Zamba2's shared attention + FFN block (weights tied across uses)."""
    d = cfg.d_model
    return {"in_proj": {"kernel": P((2 * d, d))},
            "ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}


def build_spec(cfg):
    d, v = cfg.d_model, cfg.padded_vocab
    spec = {"embed": {"table": P((v, d))},
            "layers": stack_spec(layer_spec(cfg), cfg.num_layers),
            "final_norm": norm_spec(cfg)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"kernel": P((d, v))}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        spec["shared"] = shared_block_spec(cfg)
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
    h = apply_norm(params["final_norm"], h, cfg, norm_impl)
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].to(h.dtype).T
    return h @ params["lm_head"]["kernel"].to(h.dtype)


def _attn_layer(lp, cfg, h, opts: ForwardOpts):
    a_in = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps, opts.norm_impl)
    a, kv = attn.attention_block(lp["attn"], cfg, a_in, impl=opts.attn_impl,
                                 norm_impl=opts.norm_impl,
                                 q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    h = h + a
    f_in = rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps, opts.norm_impl)
    return h + mlp_mod.mlp(lp["mlp"], cfg, f_in), kv


def _ssm_layer(lp, cfg, h, opts: ForwardOpts):
    x = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    h = h + rwkv6.tmix_block(lp["tmix"], cfg, x, impl=opts.mixer_impl)
    x2 = apply_norm(lp["ln2"], h, cfg, opts.norm_impl)
    return h + rwkv6.cmix_block(lp["cmix"], cfg, x2)


def _hybrid_layer(lp, cfg, h, opts: ForwardOpts):
    x = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    return h + mamba2.mamba_block(lp["mamba"], cfg, x, impl=opts.mixer_impl,
                                  norm_impl=opts.norm_impl)


def _shared_block(sp, cfg, h, emb0, opts: ForwardOpts):
    """Zamba2's shared block: the residual stream and the embedding output,
    concatenated and projected (2d -> d), through attention (K2 under
    ``attn_impl="flash"``) and the FFN; its output is added to h."""
    u = torch.cat([h, emb0], dim=-1) @ sp["in_proj"]["kernel"].to(h.dtype)
    a, _ = attn.attention_block(sp["attn"], cfg,
                                apply_norm(sp["ln1"], u, cfg, opts.norm_impl),
                                impl=opts.attn_impl, norm_impl=opts.norm_impl,
                                q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    u = u + a
    u = u + mlp_mod.mlp(sp["mlp"], cfg,
                        apply_norm(sp["ln2"], u, cfg, opts.norm_impl))
    return h + u


def forward(params, cfg, tokens, opts: ForwardOpts = ForwardOpts(),
            collect_cache: bool = False):
    """tokens (B, S).  Returns (logits (B, S, Vp), cache | None) where cache
    is ``{"layers": {"k": (L, B, S, KV, D), "v": ...}}`` (dense family
    only).  A hybrid stack runs its shared block after layer i whenever
    i % every == every - 1."""
    if collect_cache:
        refuse_recurrent(cfg, "forward(collect_cache=True)")
    h = embed(params, cfg, tokens)
    emb0, every = h, cfg.hybrid_attn_every
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        if cfg.family == "dense":
            h, (k, v) = _attn_layer(lp, cfg, h, opts)
            if collect_cache:
                ks.append(k)
                vs.append(v)
        elif cfg.family == "ssm":
            h = _ssm_layer(lp, cfg, h, opts)
        else:
            h = _hybrid_layer(lp, cfg, h, opts)
            if every and i % every == every - 1:
                h = _shared_block(params["shared"], cfg, h, emb0, opts)
    logits = unembed(params, cfg, h, opts.norm_impl)
    cache = ({"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
             if collect_cache else None)
    return logits, cache


def init_cache(cfg, batch_size: int, max_seq: int, device, dtype):
    """The dense decode cache (the JAX ``transformer.init_cache`` of the
    dense family): ``{"layers": {"k": (L, B, S, KV, D), "v": ...}}`` of
    zeros, the contiguous layout that ``decode_step`` takes directly."""
    refuse_recurrent(cfg, "init_cache")
    shape = (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": {name: torch.zeros(shape, dtype=dtype, device=device)
                       for name in "kv"}}


def decode_step(params, cfg, tokens, cache, positions,
                decode_impl: str = "kernel", norm_impl: str = "kernel",
                pool_group=None, dp_group=None):
    """One token per slot.  tokens (B, 1); positions (B,) int32; cache is a
    paged view ``{"layers": {"k": (L, P, page, KV, D), "v": ...},
    "page_table": (B, M) int32}`` whose pools are written in place; int8
    pools come with ``"k_scale"``/``"v_scale"`` (L, P, page, KV) fp32,
    which each layer's attention block is handed.  With ``pool_group``
    (the counterpart of the JAX ``mesh``/``kv_axis``) the pools are this
    rank's (L, P/n + 1, page, ...) shards with their sink pages, the table
    holds global ids, and every layer's attention merges across the group,
    so the logits are the same on every rank; ``dp_group`` (the JAX
    ``dp_axis``) is the dp group of a 2-D batch x pages mesh, over which
    each layer's attention rows are split.  A cache with no
    ``"page_table"`` is the dense (L, B, S, KV, D) layout of
    ``init_cache``, written in place, each slot at its own position
    (``decode_impl`` ignored).  Returns (logits (B, 1, Vp), cache)."""
    refuse_recurrent(cfg, "decode_step")
    page_table = cache.get("page_table")
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
            pool_group=pool_group, dp_group=dp_group, **scales)
        f_in = rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps, norm_impl)
        h = h + mlp_mod.mlp(lp["mlp"], cfg, f_in)
    return unembed(params, cfg, h, norm_impl), cache


def prefill_chunk(params, cfg, tokens, cache, start_pos, dest, last_pos,
                  norm_impl: str = "kernel", pool_group=None, dp_group=None):
    """One chunk of chunked prefill (the JAX ``transformer.prefill_chunk``):
    tokens (B, C) at global offsets ``start_pos`` (B,) through the stack;
    each layer writes the chunk's K/V into the paged pools in place at
    ``dest`` (B, C) flat rows and attends over the slot's earlier chunks
    and the chunk itself (``attention.attention_prefill_chunk_block``).
    ``cache`` is ``{"layers": pools, "page_table": (B, M)}`` holding the
    slots' REAL table rows; ``last_pos`` (B,) is each chunk's last valid
    position.  Only the hidden row at ``last_pos`` is unembedded, so a
    chunk pays one vocab projection.  Returns (logits (B, 1, Vp), cache).
    Dense family only: recurrent state has no position-indexed cache."""
    if cfg.family != "dense":
        raise ValueError("chunked prefill is dense-FFN attention-cache "
                         f"families only (family={cfg.family})")
    page_table = cache["page_table"]
    pools = cache["layers"]
    quantized = "k_scale" in pools
    h = embed(params, cfg, tokens)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        a_in = rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps, norm_impl)
        scales = ({"k_scale": pools["k_scale"][i],
                   "v_scale": pools["v_scale"][i]} if quantized else {})
        h = h + attn.attention_prefill_chunk_block(
            lp["attn"], cfg, a_in, pools["k"][i], pools["v"][i], start_pos,
            dest, page_table, last_pos, norm_impl=norm_impl,
            pool_group=pool_group, dp_group=dp_group, **scales)
        f_in = rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps, norm_impl)
        h = h + mlp_mod.mlp(lp["mlp"], cfg, f_in)
    take = (last_pos - start_pos).long()
    h_last = h[torch.arange(h.shape[0], device=h.device), take][:, None]
    return unembed(params, cfg, h_last, norm_impl), cache
