"""Encoder-decoder stack of the port (the seamless-m4t backbone; counterpart
of the JAX ``repro.models.encdec``).  The audio frontend is a stub: the
encoder takes precomputed frame embeddings (B, E, d), E = S / enc_ratio.

* ``encode``          — the non-causal encoder (K2 under
  ``attn_impl="flash"``; blockwise or dense attention otherwise)
* ``decoder_forward`` — the causal decoder over the encoder output: self-
  attention, cross-attention (plain ``blockwise_attention``, as JAX's:
  no TPU kernel runs there) and the FFN, with an untied ``lm_head``
* ``forward``         — both; with ``collect_cache`` the decoder's K/V and
  every layer's cross-attention K/V
* ``decode_step``     — one token per slot over the dense cache of
  ``init_cache`` (self-attention rows written in place at per-slot
  positions; the cross-attention K/V are position-free)

LayerNorm with biases (``ln1``/``ln2``/``ln3``) and biased projections, as
the config says.  While autograd records, the encoder and decoder layer
bodies run under the remat policy of ``ForwardOpts`` (``_remat``).  The
cross-attention K/V are dense per-request state with no page structure:
the paged backend, pool groups, chunked prefill and the serve engine
refuse encdec configs, as JAX's do.

Under a sharding context on a mesh of processes every attention (self and
cross) and MLP is tensor-parallel where the rules split its heads and
columns (``parallel.tpmm``, its reductions in fp32: JAX's enc-dec takes no
``tp_shardmap``), and the decode step reads the dense cache split along
its sequence over the model axis (``ENC_CACHE_AXES``): the self-attention
rows merged as the decoder-only families merge theirs, the encoder rows
by ``attention.sharded_cross_attention_decode_block``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import DTYPES, P, apply_norm, norm_spec, \
    stack_spec
from repro_torch.models.transformer import (ForwardOpts, _cache_split,
                                            _records_grad, _remat, _stack,
                                            embed, unembed, use, use_top)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding

#: the logical axes of every leaf of the enc-dec cache, the cross-attention
#: K/V's too (the JAX ``input_logical_axes``' choice)
ENC_CACHE_AXES = ("layers", "batch", "kv_seq", "kv_heads", None)


def enc_layer_spec(cfg):
    return {"ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}


def dec_layer_spec(cfg):
    return {"ln1": norm_spec(cfg), "self_attn": attn.attention_spec(cfg),
            "ln2": norm_spec(cfg),
            "cross_attn": attn.attention_spec(cfg, cross=True),
            "ln3": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}


def build_spec(cfg):
    d, v = cfg.d_model, cfg.padded_vocab
    return {"embed": {"table": P((v, d), axes=("vocab", "embed"))},
            "enc_layers": stack_spec(enc_layer_spec(cfg), cfg.encoder_layers),
            "enc_norm": norm_spec(cfg),
            "dec_layers": stack_spec(dec_layer_spec(cfg), cfg.num_layers),
            "final_norm": norm_spec(cfg),
            "lm_head": {"kernel": P((d, v), axes=("embed", "vocab"))}}


def encode(params, cfg, enc_embeds, opts: ForwardOpts = ForwardOpts(),
           sf=None):
    """enc_embeds (B, E, d), the stub frontend's output -> the encoder's
    hidden states (B, E, d) in the compute dtype.  ``sf``: the
    ``ShardedForward`` of a sharded forward (``forward``), whose layers
    this gathers one by one; the other leaves come gathered
    (``use_top``)."""
    h = enc_embeds.to(DTYPES[cfg.dtype])

    def body(h, i):
        lp = use(params, "enc_layers", sf, i)
        a, _ = attn.attention_block(
            lp["attn"], cfg, apply_norm(lp["ln1"], h, cfg, opts.norm_impl),
            impl=opts.attn_impl, causal=False, norm_impl=opts.norm_impl,
            q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
        h = h + a
        return h + mlp_mod.mlp(lp["mlp"], cfg,
                               apply_norm(lp["ln2"], h, cfg, opts.norm_impl))

    if _records_grad(params, h):
        body = _remat(body, opts.remat)
    for i in range(cfg.encoder_layers):
        h = body(h, i)
    return apply_norm(params["enc_norm"], h, cfg, opts.norm_impl)


def decoder_forward(params, cfg, tokens, enc_out,
                    opts: ForwardOpts = ForwardOpts(),
                    collect_cache: bool = False, sf=None):
    """tokens (B, S), enc_out (B, E, d) -> (logits (B, S, Vp), cache |
    None): with ``collect_cache``, ``{"layers": {"k", "v", "xk", "xv"}}``,
    the self-attention K/V (L, B, S, KV, D) and the cross-attention K/V
    (L, B, E, KV, D)."""
    h = embed(params, cfg, tokens)

    def body(h, enc_out, i):
        lp = use(params, "dec_layers", sf, i)
        a, (k, v) = attn.attention_block(
            lp["self_attn"], cfg,
            apply_norm(lp["ln1"], h, cfg, opts.norm_impl),
            impl=opts.attn_impl, norm_impl=opts.norm_impl,
            q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
        h = h + a
        xk, xv = attn.encode_kv(lp["cross_attn"], cfg, enc_out)
        h = h + attn.cross_attention_block(
            lp["cross_attn"], cfg,
            apply_norm(lp["ln2"], h, cfg, opts.norm_impl), (xk, xv))
        h = h + mlp_mod.mlp(lp["mlp"], cfg,
                            apply_norm(lp["ln3"], h, cfg, opts.norm_impl))
        cache = ({"k": k, "v": v, "xk": xk, "xv": xv} if collect_cache
                 else None)
        return h, cache

    if _records_grad(params, h):
        body = _remat(body, opts.remat)
    caches = []
    for i in range(cfg.num_layers):
        h, cache = body(h, enc_out, i)
        caches.append(cache)
    logits = unembed(params, cfg, h, opts.norm_impl)
    return logits, ({"layers": _stack(caches)} if collect_cache else None)


def forward(params, cfg, tokens, enc_embeds,
            opts: ForwardOpts = ForwardOpts(), collect_cache: bool = False):
    """The encoder over ``enc_embeds`` (B, E, d), then the decoder over
    tokens (B, S).  Returns (logits (B, S, Vp), cache | None).  Under a
    sharding context on a mesh of processes, this rank's share of the
    batch, its FSDP shards gathered layer by layer and its model shards
    computed tensor-parallel; a collected cache holds this rank's rows
    with the K/V heads of its projections (self and cross)."""
    sf = sharding.sharded_forward(cfg, build_spec)
    params = use_top(params, sf)
    enc_out = encode(params, cfg, enc_embeds, opts, sf)
    return decoder_forward(params, cfg, tokens, enc_out, opts, collect_cache,
                           sf)


def init_cache(cfg, batch_size: int, max_seq: int, enc_len: int, device,
               dtype):
    """The dense decode cache, zeros: ``{"layers": {"k", "v"}}`` (L, B,
    max_seq, KV, D) and ``{"xk", "xv"}`` (L, B, enc_len, KV, D)."""
    L, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(s):
        return torch.zeros((L, batch_size, s, kvh, hd), dtype=dtype,
                           device=device)

    return {"layers": {"k": zeros(max_seq), "v": zeros(max_seq),
                       "xk": zeros(enc_len), "xv": zeros(enc_len)}}


def decode_step(params, cfg, tokens, cache, positions,
                norm_impl: str = "kernel"):
    """One decoder token per slot.  tokens (B, 1); positions (B,) int32;
    ``cache`` the dense layout of ``init_cache`` (or a prefill's cache
    whose K/V rows were copied into one), its self-attention rows written
    in place at each slot's position.  Returns (logits (B, 1, Vp),
    cache).  Under a sharding context on a mesh of processes, ``tokens``
    and ``positions`` are the global batch's and ``cache`` this rank's
    shards of it (``LM.shard_cache``: its batch rows, each leaf's
    sequence split over the model axis); the whole batch's logits come
    back on every rank."""
    if "page_table" in cache:
        raise ValueError("paged KV decode is decoder-only transformer "
                         "families")
    lc = cache["layers"]
    sf = sharding.sharded_forward(cfg, build_spec)
    dp = None
    if sf is not None:
        _, self_group, offset = _cache_split(cache, "layers", "k",
                                             ENC_CACHE_AXES, sf)
        cross_group = _cache_split(cache, "layers", "xk", ENC_CACHE_AXES,
                                   sf)[1]
        rows = sharding.batch_rows(sf.mesh, sf.rules, tokens.shape[0])
        dp = sf.mesh.group(sf.batch_axes) if sf.batch_axes else None
        tokens, positions = tokens[rows], positions[rows]
        params = use_top(params, sf)
    h = embed(params, cfg, tokens)
    for i in range(cfg.num_layers):
        lp = use(params, "dec_layers", sf, i)
        a_in = apply_norm(lp["ln1"], h, cfg, norm_impl)
        if sf is None:
            h = h + attn.attention_decode_block(
                lp["self_attn"], cfg, a_in, lc["k"][i], lc["v"][i],
                positions, norm_impl=norm_impl)
        else:
            h = h + attn.sharded_attention_decode_block(
                lp["self_attn"], cfg, a_in, lc["k"][i], lc["v"][i],
                positions, self_group, offset, norm_impl)
        c_in = apply_norm(lp["ln2"], h, cfg, norm_impl)
        if sf is None:
            h = h + attn.cross_attention_block(
                lp["cross_attn"], cfg, c_in, (lc["xk"][i], lc["xv"][i]))
        else:
            h = h + attn.sharded_cross_attention_decode_block(
                lp["cross_attn"], cfg, c_in, lc["xk"][i], lc["xv"][i],
                cross_group)
        h = h + mlp_mod.mlp(lp["mlp"], cfg,
                            apply_norm(lp["ln3"], h, cfg, norm_impl))
    logits = unembed(params, cfg, h, norm_impl)
    return (logits if sf is None else coll.gather_from(logits, 0, dp)), cache
