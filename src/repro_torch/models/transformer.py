"""Decoder-only stack of the port: the dense, vlm (internvl2), moe
(moonshot, arctic), hybrid (zamba2) and ssm (rwkv6) families of the JAX
``repro.models.transformer``.

Layers are stacked along a leading dim of every parameter and applied in a
Python loop, each layer body under the remat policy of ``ForwardOpts``
(``_remat``) while autograd records.  Three entry points share the
weights:

* ``forward``     — full sequence (training and eval; prefill when
  ``collect_cache``: K/V for the attention families, the final recurrent
  states and zamba2's shared-block K/V for the others); a vlm forward
  takes the image embeddings in front of the text (``embed_inputs``)
* ``decode_step`` — one token per slot at (B,) positions over a paged cache,
  whose pools it updates in place (attention families only), over this rank's
  shards of pools split over a ``PoolGroup``, or over the cache of
  ``init_cache`` (the dense contiguous layout; the recurrent states, which
  it also updates in place); a moe layer routes the whole batch as one
  group
* ``prefill_chunk`` — a (B, C) chunk of prompt tokens at per-request
  offsets over a paged cache (dense family only), the chunked prefill

Recurrent state has no per-position mask: a recurrent prefill takes
equal-length prompts, as JAX's does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe as moe_mod, rwkv6
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (DTYPES, P, apply_norm, norm_spec,
                                       stack_spec)

@dataclass(frozen=True)
class ForwardOpts:
    attn_impl: str = "flash"      # flash (K2) | dense (reference) | blockwise
    norm_impl: str = "kernel"     # kernel (K3) | plain (reference)
    q_chunk: int = 1024           # blockwise attention chunks
    kv_chunk: int = 1024
    remat: str = "selective"      # none | selective | full (``_remat``)
    xent_impl: str = "kernel"     # loss: kernel (K4) | plain (reference)
    mixer_impl: str = "kernel"    # mamba2 SSD / rwkv6 WKV: kernel (K6/K7) |
    #                               plain (the JAX models' chunked forms)

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r} not in "
                             f"{REMAT_POLICIES}")


REMAT_POLICIES = ("none", "selective", "full")

# JAX's "selective" saves ``dots_with_no_batch_dims_saveable``: the outputs
# of every matmul without batch dims.  A ``x @ W`` of the layer bodies,
# (B, S, d) by a (d, e) weight, dispatches ``aten.mm`` on the folded rows
# (``addmm`` with a bias); batched products (attention scores and PV, the
# SSD and WKV einsums) dispatch ``bmm`` and are recomputed, as is every
# elementwise op.  JAX's policy also saves ``TP_SAVE_NAME``, the outputs of
# ``parallel/tpmm.py``'s tensor-parallel contractions, which the port does
# not have until ROADMAP item 18: no op of the port carries that name.
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _selective_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _selective_contexts():
    return create_selective_checkpoint_contexts(_selective_policy)


def _remat(fn, policy: str):
    """The JAX ``_remat``: ``fn`` as it is (``"none"``), or checkpointed, so
    its backward recomputes what it did not keep: everything but its inputs
    (``"full"``), or all but the outputs of the matmuls with no batch dims
    (``"selective"``).  Recomputation runs the same ops on the same inputs,
    so values and gradients are those of ``"none"``."""
    if policy == "none":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "selective":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=_selective_contexts)
    raise ValueError(policy)


def _records_grad(params, h) -> bool:
    """Whether autograd records this forward: grad mode on and the input or
    a parameter requires grad.  Eval, prefill, decode and the serve paths
    record nothing, so their layer bodies run unwrapped."""
    if not torch.is_grad_enabled():
        return False

    def any_grad(t):
        if isinstance(t, torch.Tensor):
            return t.requires_grad
        return any(any_grad(v) for v in t.values())
    return h.requires_grad or any_grad(params)


def layer_spec(cfg):
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
                "ln2": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}
    if fam == "moe":
        return {"ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
                "ln2": norm_spec(cfg), "moe": moe_mod.moe_spec(cfg)}
    if fam == "ssm":
        return {"ln1": norm_spec(cfg), "tmix": rwkv6.tmix_spec(cfg),
                "ln2": norm_spec(cfg), "cmix": rwkv6.cmix_spec(cfg)}
    if fam == "hybrid":
        return {"ln1": norm_spec(cfg), "mamba": mamba2.mamba_spec(cfg)}
    raise ValueError(f"the decoder stack runs the dense, vlm, moe, hybrid "
                     f"and ssm families (got {fam}; encdec: "
                     "repro_torch.models.encdec)")


def shared_block_spec(cfg):
    """Zamba2's shared attention + FFN block (weights tied across uses)."""
    d = cfg.d_model
    return {"in_proj": {"kernel": P((2 * d, d))},
            "ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}


def has_image(cfg) -> bool:
    """Whether ``cfg``'s sequences lead with stub-ViT image positions."""
    return cfg.family == "vlm" and bool(cfg.num_image_tokens)


def build_spec(cfg):
    d, v = cfg.d_model, cfg.padded_vocab
    spec = {"embed": {"table": P((v, d))},
            "layers": stack_spec(layer_spec(cfg), cfg.num_layers),
            "final_norm": norm_spec(cfg)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"kernel": P((d, v))}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        spec["shared"] = shared_block_spec(cfg)
    if has_image(cfg):
        # the stub ViT's learned image positions, zeros at init and fp32
        # (JAX pins their dtype)
        spec["img_pos"] = P((cfg.num_image_tokens, d), init="zeros",
                            fp32=True)
    return spec


def layer_params(params, i: int, stack: str = "layers"):
    """Layer ``i``'s parameters of the stacked subtree ``params[stack]``:
    views into the stacked tensors."""
    def pick(t):
        return t[i] if isinstance(t, torch.Tensor) else \
            {k: pick(v) for k, v in t.items()}
    return pick(params[stack])


def embed(params, cfg, tokens):
    """Token embedding in the compute dtype (``cfg.dtype``)."""
    return params["embed"]["table"][tokens].to(DTYPES[cfg.dtype])


def embed_inputs(params, cfg, tokens, img_embeds=None):
    """The JAX ``embed_inputs``: the token embedding (B, S, d) and, for a
    vlm config, the stub ViT's (B, num_image_tokens, d) patch embeddings
    plus ``img_pos`` in front of it, in the compute dtype: (B, n + S, d)."""
    h = embed(params, cfg, tokens)
    if not has_image(cfg):
        return h
    if img_embeds is None:
        raise ValueError(
            f"{cfg.name} is a vlm config: its forward takes img_embeds "
            f"(B, {cfg.num_image_tokens}, {cfg.d_model}), the image patch "
            "embeddings in front of the text, and none were given")
    img = img_embeds.to(h.dtype) + params["img_pos"].to(h.dtype)[None]
    return torch.cat([img, h], dim=1)


def unembed(params, cfg, h, norm_impl: str = "kernel"):
    h = apply_norm(params["final_norm"], h, cfg, norm_impl)
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].to(h.dtype).T
    return h @ params["lm_head"]["kernel"].to(h.dtype)


# each layer body returns (h, aux, cache): aux is the MoE load-balance
# loss of a moe layer, None for the others

def _ffn(lp, cfg, f_in):
    """The dense FFN, or a moe layer's experts (each sequence routes on its
    own).  Returns (y, aux | None)."""
    if "moe" in lp:
        return moe_mod.moe_ffn(lp["moe"], cfg, f_in)
    return mlp_mod.mlp(lp["mlp"], cfg, f_in), None


def _attn_layer(lp, cfg, h, opts: ForwardOpts, collect: bool = False):
    del collect                  # the K/V come with the attention output
    a_in = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    a, (k, v) = attn.attention_block(lp["attn"], cfg, a_in,
                                     impl=opts.attn_impl,
                                     norm_impl=opts.norm_impl,
                                     q_chunk=opts.q_chunk,
                                     kv_chunk=opts.kv_chunk)
    h = h + a
    f, aux = _ffn(lp, cfg, apply_norm(lp["ln2"], h, cfg, opts.norm_impl))
    return h + f, aux, {"k": k, "v": v}


# K6 and K7 have no final-state output (neither have the TPU kernels), so a
# collected cache takes the plain chunked forms, as JAX takes "xla" there

def _ssm_layer(lp, cfg, h, opts: ForwardOpts, collect: bool = False):
    x = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    y, (shift1, wkv) = rwkv6.tmix_block(
        lp["tmix"], cfg, x, impl="plain" if collect else opts.mixer_impl)
    h = h + y
    x2 = apply_norm(lp["ln2"], h, cfg, opts.norm_impl)
    y2, shift2 = rwkv6.cmix_block(lp["cmix"], cfg, x2)
    return h + y2, None, {"shift1": shift1, "wkv": wkv, "shift2": shift2}


def _hybrid_layer(lp, cfg, h, opts: ForwardOpts, collect: bool = False):
    x = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    y, (conv, ssm) = mamba2.mamba_block(
        lp["mamba"], cfg, x, impl="plain" if collect else opts.mixer_impl,
        norm_impl=opts.norm_impl)
    if not collect:
        return h + y, None, None
    return h + y, None, {"conv": torch.cat(conv, dim=-1), "ssm": ssm}


def _shared_in(sp, h, emb0):
    """Zamba2's shared block input: the residual stream and the embedding
    output, concatenated and projected (2d -> d)."""
    return torch.cat([h, emb0], dim=-1) @ sp["in_proj"]["kernel"].to(h.dtype)


def _shared_ffn(sp, cfg, u, norm_impl: str):
    return u + mlp_mod.mlp(sp["mlp"], cfg,
                           apply_norm(sp["ln2"], u, cfg, norm_impl))


def _shared_block(sp, cfg, h, emb0, opts: ForwardOpts):
    """Zamba2's shared block through attention (K2 under
    ``attn_impl="flash"``) and the FFN; its output is added to h.  Returns
    (h, {"k", "v"})."""
    u = _shared_in(sp, h, emb0)
    a, (k, v) = attn.attention_block(
        sp["attn"], cfg, apply_norm(sp["ln1"], u, cfg, opts.norm_impl),
        impl=opts.attn_impl, norm_impl=opts.norm_impl, q_chunk=opts.q_chunk,
        kv_chunk=opts.kv_chunk)
    return h + _shared_ffn(sp, cfg, u + a, opts.norm_impl), {"k": k, "v": v}


def _fires(cfg, i: int) -> bool:
    """Whether zamba2's shared block runs after layer i."""
    every = cfg.hybrid_attn_every
    return cfg.family == "hybrid" and bool(every) and i % every == every - 1


def _stack(caches):
    return {name: torch.stack([c[name] for c in caches])
            for name in caches[0]}


def forward(params, cfg, tokens, opts: ForwardOpts = ForwardOpts(),
            collect_cache: bool = False, img_embeds=None,
            return_aux: bool = False):
    """tokens (B, S); ``img_embeds`` (B, n, d) for a vlm config, whose
    logits and cache then cover its n image positions first (S becomes
    n + S below).  Returns (logits (B, S, Vp), cache | None), and with
    ``return_aux`` a third item, the JAX forward's ``moe_aux``: the sum of
    the layers' MoE load-balance losses, a 0-d fp32 tensor (0 for the
    families without experts).  While
    autograd records, each layer body (with zamba2's shared block where it
    fires after that layer, as in JAX's scan body) runs under
    ``_remat(opts.remat)``.  The
    collected cache is ``{"layers": ...}`` of per-layer leaves stacked along
    a leading L dim: ``{"k", "v"}`` (L, B, S, KV, D) for the attention
    families,
    ``{"shift1", "wkv", "shift2"}`` (L, B, 1, d), (L, B, H, K, V) fp32 and
    (L, B, 1, d) for ssm, ``{"conv", "ssm"}`` (L, B, w-1, d_inner + 2N) and
    (L, B, H, P, N) fp32 for hybrid, whose cache also holds ``"shared"``:
    the shared block's ``{"k", "v"}`` (n_shared, B, S, KV, D), use j at
    index j.  A hybrid stack runs its shared block after layer i whenever
    i % every == every - 1."""
    layer = {"dense": _attn_layer, "vlm": _attn_layer, "moe": _attn_layer,
             "ssm": _ssm_layer, "hybrid": _hybrid_layer}[cfg.family]
    h = embed_inputs(params, cfg, tokens, img_embeds)
    emb0 = h

    def body(h, i):
        h, aux, cache = layer(layer_params(params, i), cfg, h, opts,
                              collect_cache)
        kv = None
        if _fires(cfg, i):
            h, kv = _shared_block(params["shared"], cfg, h, emb0, opts)
        return h, aux, cache, kv

    if _records_grad(params, h):
        body = _remat(body, opts.remat)
    caches, shared, auxs = [], [], []
    for i in range(cfg.num_layers):
        h, aux, cache, kv = body(h, i)
        if aux is not None:
            auxs.append(aux)
        if kv is not None:
            shared.append(kv)
        if collect_cache:
            caches.append(cache)
    logits = unembed(params, cfg, h, opts.norm_impl)
    cache = None
    if collect_cache:
        cache = {"layers": _stack(caches)}
        if shared:
            cache["shared"] = _stack(shared)
    if not return_aux:
        return logits, cache
    aux = (torch.stack(auxs).sum() if auxs
           else torch.zeros((), device=logits.device))
    return logits, cache, aux


def init_cache(cfg, batch_size: int, max_seq: int, device, dtype):
    """The raw decode cache (the JAX ``transformer.init_cache``), zeros:
    ``{"layers": {"k", "v"}}`` (L, B, S, KV, D) for the dense family (the
    contiguous layout that ``decode_step`` takes directly), and for vlm,
    whose image rows are cache positions too; for ssm the
    shift states (L, B, 1, d) in ``dtype`` and the WKV state (L, B, H, K, K)
    fp32; for hybrid the conv state (L, B, w-1, d_inner + 2N) in ``dtype``,
    the SSM state (L, B, H, P, N) fp32 and the shared block's ``{"k", "v"}``
    (n_shared, B, S, KV, D)."""
    L, b = cfg.num_layers, batch_size
    kv_shape = (b, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family in ("dense", "vlm", "moe"):
        return {"layers": {"k": zeros((L, *kv_shape)),
                           "v": zeros((L, *kv_shape))}}
    if cfg.family == "ssm":
        d, h, kd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
        return {"layers": {"shift1": zeros((L, b, 1, d)),
                           "wkv": zeros((L, b, h, kd, kd), torch.float32),
                           "shift2": zeros((L, b, 1, d))}}
    din, n = cfg.d_inner, cfg.ssm_state
    cache = {"layers": {
        "conv": zeros((L, b, cfg.ssm_conv_dim - 1, din + 2 * n)),
        "ssm": zeros((L, b, cfg.ssm_heads, cfg.ssm_head_dim, n),
                     torch.float32)}}
    n_shared = sum(_fires(cfg, i) for i in range(L))
    if n_shared:
        cache["shared"] = {"k": zeros((n_shared, *kv_shape)),
                           "v": zeros((n_shared, *kv_shape))}
    return cache


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
    (``decode_impl`` ignored).  The recurrent families take the cache of
    ``init_cache`` (or of ``forward(collect_cache=True)``) only, whose
    states they update in place (``_recurrent_decode``).  A vlm step takes
    no image: its image rows are in the cache from the prefill, as in JAX.
    Returns (logits (B, 1, Vp), cache)."""
    page_table = cache.get("page_table")
    if cfg.family not in ("dense", "vlm", "moe"):
        if page_table is not None or pool_group is not None \
                or dp_group is not None:
            raise ValueError(
                "paged KV decode is attention-cache families only; recurrent "
                f"state has no page structure (family={cfg.family})")
        return _recurrent_decode(params, cfg, tokens, cache, positions,
                                 norm_impl), cache
    pools = cache["layers"]
    quantized = "k_scale" in pools
    h = embed(params, cfg, tokens)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        a_in = apply_norm(lp["ln1"], h, cfg, norm_impl)
        scales = ({"k_scale": pools["k_scale"][i],
                   "v_scale": pools["v_scale"][i]} if quantized else {})
        h = h + attn.attention_decode_block(
            lp["attn"], cfg, a_in, pools["k"][i], pools["v"][i], positions,
            page_table, decode_impl=decode_impl, norm_impl=norm_impl,
            pool_group=pool_group, dp_group=dp_group, **scales)
        f_in = apply_norm(lp["ln2"], h, cfg, norm_impl)
        if "moe" in lp:
            h = h + moe_mod.moe_ffn_decode(lp["moe"], cfg, f_in)[0]
        else:
            h = h + mlp_mod.mlp(lp["mlp"], cfg, f_in)
    return unembed(params, cfg, h, norm_impl), cache


def _recurrent_decode(params, cfg, tokens, cache, positions, norm_impl):
    """The ssm and hybrid decode step (the JAX ``decode_step`` bodies):
    every layer's exact single-step recurrence (plain torch: neither
    package has a kernel for it), its new states copied into the cache in
    place; zamba2's shared block decodes over its raw dense K/V rows at
    ``positions``.  Returns the logits (B, 1, Vp)."""
    states = cache["layers"]
    h = embed(params, cfg, tokens)
    emb0 = h
    n_shared = 0
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        x = apply_norm(lp["ln1"], h, cfg, norm_impl)
        if cfg.family == "ssm":
            y, (shift1, wkv) = rwkv6.tmix_block(
                lp["tmix"], cfg, x, shift_state=states["shift1"][i],
                wkv_state=states["wkv"][i], decode=True)
            h = h + y
            x2 = apply_norm(lp["ln2"], h, cfg, norm_impl)
            y2, shift2 = rwkv6.cmix_block(lp["cmix"], cfg, x2,
                                          shift_state=states["shift2"][i])
            h = h + y2
            new = {"shift1": shift1, "wkv": wkv, "shift2": shift2}
        else:
            y, (conv, ssm) = mamba2.mamba_block(
                lp["mamba"], cfg, x, norm_impl=norm_impl,
                conv_state=states["conv"][i], ssm_state=states["ssm"][i],
                decode=True)
            h = h + y
            new = {"conv": torch.cat(conv, dim=-1), "ssm": ssm}
            if _fires(cfg, i):
                sp, skv = params["shared"], cache["shared"]
                u = _shared_in(sp, h, emb0)
                a = attn.attention_decode_block(
                    sp["attn"], cfg, apply_norm(sp["ln1"], u, cfg, norm_impl),
                    skv["k"][n_shared], skv["v"][n_shared], positions,
                    norm_impl=norm_impl)
                h = h + _shared_ffn(sp, cfg, u + a, norm_impl)
                n_shared += 1
        for name, t in new.items():
            states[name][i].copy_(t)
    return unembed(params, cfg, h, norm_impl)


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
    Dense-FFN attention families only (dense, vlm): recurrent state has no
    position-indexed cache, and a moe layer's capacity routing depends on
    the forwarded group, so a chunk would route otherwise than the whole
    prompt (JAX refuses both)."""
    if cfg.family not in ("dense", "vlm"):
        raise ValueError("chunked prefill is dense-FFN attention-cache "
                         f"families only (family={cfg.family})")
    page_table = cache["page_table"]
    pools = cache["layers"]
    quantized = "k_scale" in pools
    h = embed(params, cfg, tokens)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        a_in = apply_norm(lp["ln1"], h, cfg, norm_impl)
        scales = ({"k_scale": pools["k_scale"][i],
                   "v_scale": pools["v_scale"][i]} if quantized else {})
        h = h + attn.attention_prefill_chunk_block(
            lp["attn"], cfg, a_in, pools["k"][i], pools["v"][i], start_pos,
            dest, page_table, last_pos, norm_impl=norm_impl,
            pool_group=pool_group, dp_group=dp_group, **scales)
        f_in = apply_norm(lp["ln2"], h, cfg, norm_impl)
        h = h + mlp_mod.mlp(lp["mlp"], cfg, f_in)
    take = (last_pos - start_pos).long()
    h_last = h[torch.arange(h.shape[0], device=h.device), take][:, None]
    return unembed(params, cfg, h_last, norm_impl), cache
