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

Under ``parallel.sharding.sharding_context`` on a mesh of processes,
``forward`` runs this rank's share of a sharded model
(``sharding.ShardedForward``): each layer's weights are gathered over the
batch axes just before the layer (FSDP), the embedding, attention, MLP,
experts and the vocab projection are split over the model axis where the
rules split their weights (``parallel.tpmm``), and the logits come out
whole for this rank's batch rows; a collected cache holds this rank's rows
and the K/V heads its projections computed.  ``decode_step`` runs the same
way over this rank's shards of the dense cache (``shard_cache``: the rows
of its batch split, and the sequence split over the model axis by
``cache_logical_axes``), its attention merged over the sequence split,
and returns the whole batch's logits on every rank.  The hybrid and ssm
families split their mixers over the model axis as JAX's rules do
(``mamba2``, ``rwkv6``): their collected cache holds this rank's channels
and heads of each state, and their decode step reads ``shard_cache``'s
state shards, gathering a leaf over the model group where its split does
not line up with the weights' (zamba2's conv state, ``_recurrent_decode``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe as moe_mod, rwkv6
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (DTYPES, P, apply_norm, norm_spec,
                                       stack_spec)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding
from repro_torch.parallel.tpmm import col_proj_tp, tp_group

@dataclass(frozen=True)
class ForwardOpts:
    attn_impl: str = "flash"      # flash (K2) | dense (reference) |
    #                               blockwise | seqsp (sequence-sharded)
    norm_impl: str = "kernel"     # kernel (K3) | plain (reference)
    q_chunk: int = 1024           # blockwise attention chunks
    kv_chunk: int = 1024
    remat: str = "selective"      # none | selective | full (``_remat``)
    xent_impl: str = "kernel"     # loss: kernel (K4) | plain (reference)
    mixer_impl: str = "kernel"    # mamba2 SSD / rwkv6 WKV: kernel (K6/K7) |
    #                               plain (the JAX models' chunked forms)
    flat_heads: bool = False      # repeat K/V to H heads (train/prefill)
    tp_shardmap: bool = False     # tensor-parallel reductions in the compute
    #                               dtype (tpmm's), not fp32 (GSPMD's)
    moe_ep: bool = False          # expert parallel (parallel.epmoe)

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
# elementwise op.  JAX's policy also saves ``TP_SAVE_NAME``, the reduced
# outputs of the tensor-parallel contractions; the port saves every
# collective's output (``parallel.collectives.SAVED_OPS``), so the
# backward's replay of a layer runs no collective again.
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) \
    + coll.SAVED_OPS


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
    and of the collectives (``"selective"``).  Recomputation runs the same
    ops on the same inputs, under the sharding context of the forward
    (autograd may replay it on another thread), so values and gradients
    are those of ``"none"``."""
    if policy == "none":
        return fn
    if policy not in ("full", "selective"):
        raise ValueError(policy)

    def run(*args):
        ctx = sharding.current_context()

        def contexts():
            fwd, rec = (_selective_contexts() if policy == "selective"
                        else (contextlib.nullcontext(),
                              contextlib.nullcontext()))
            return fwd, _replay(ctx, rec)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=contexts)
    return run


@contextlib.contextmanager
def _replay(ctx, rec):
    """The recompute's context: the forward's sharding context, then
    ``rec``."""
    with contextlib.ExitStack() as stack:
        if ctx is not None:
            stack.enter_context(sharding.sharding_context(*ctx))
        stack.enter_context(rec)
        yield


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
    return {"in_proj": {"kernel": P((2 * d, d), axes=(None, "embed"))},
            "ln1": norm_spec(cfg), "attn": attn.attention_spec(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_mod.mlp_spec(cfg)}


def has_image(cfg) -> bool:
    """Whether ``cfg``'s sequences lead with stub-ViT image positions."""
    return cfg.family == "vlm" and bool(cfg.num_image_tokens)


def build_spec(cfg):
    d, v = cfg.d_model, cfg.padded_vocab
    spec = {"embed": {"table": P((v, d), axes=("vocab", "embed"))},
            "layers": stack_spec(layer_spec(cfg), cfg.num_layers),
            "final_norm": norm_spec(cfg)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"kernel": P((d, v), axes=("embed", "vocab"))}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        spec["shared"] = shared_block_spec(cfg)
    if has_image(cfg):
        # the stub ViT's learned image positions, zeros at init and fp32
        # (JAX pins their dtype)
        spec["img_pos"] = P((cfg.num_image_tokens, d), init="zeros",
                            fp32=True, axes=("img", "embed"))
    return spec


def layer_params(params, i: int, stack: str = "layers"):
    """Layer ``i``'s parameters of the stacked subtree ``params[stack]``:
    views into the stacked tensors."""
    def pick(t):
        return t[i] if isinstance(t, torch.Tensor) else \
            {k: pick(v) for k, v in t.items()}
    return pick(params[stack])


def use(params, name: str, sf=None, i=None):
    """``params[name]``, or layer ``i`` of that stacked subtree, as the
    forward uses it: under a ``ShardedForward`` gathered for use
    (``sharding.ShardedForward.use``), else as it is."""
    sub = params[name] if i is None else layer_params(params, i, name)
    return sub if sf is None else sf.use(sub, sf.specs[name],
                                         stacked=i is not None)


#: the subtrees a sharded forward gathers where it uses them, layer by layer
_PER_USE = ("layers", "shared", "enc_layers", "dec_layers")


def use_top(params, sf):
    """``params`` with every subtree but the layers (and zamba2's shared
    block) gathered once for the whole forward under a ``ShardedForward``:
    a tied embedding then serves the lookup and the vocab projection from
    one gather, whose backward reduce-scatters their summed gradient once.
    Without one, ``params`` as it is."""
    if sf is None:
        return params
    return {k: v if k in _PER_USE else use(params, k, sf)
            for k, v in params.items()}


def embed(params, cfg, tokens, psum_dtype=torch.float32):
    """Token embedding in the compute dtype (``cfg.dtype``).  Where the
    table is this rank's rows of a vocab split over the model axis
    (``use_top``), each rank looks up the tokens of its rows and the
    embeddings are summed over the model group."""
    table = params["embed"]["table"]
    g = tp_group(table, 0)
    if g is None:
        return table[tokens].to(DTYPES[cfg.dtype])
    vl = table.shape[0]
    local = tokens.long() - coll.group_rank(g) * vl
    mine = ((local >= 0) & (local < vl))[..., None].to(table.dtype)
    e = table[local.clamp(0, vl - 1)] * mine
    return coll.reduce_from(e, g, psum_dtype).to(DTYPES[cfg.dtype])


def embed_inputs(params, cfg, tokens, img_embeds=None,
                 psum_dtype=torch.float32):
    """The JAX ``embed_inputs``: the token embedding (B, S, d) and, for a
    vlm config, the stub ViT's (B, num_image_tokens, d) patch embeddings
    plus ``img_pos`` in front of it, in the compute dtype: (B, n + S, d)."""
    h = embed(params, cfg, tokens, psum_dtype)
    if not has_image(cfg):
        return h
    if img_embeds is None:
        raise ValueError(
            f"{cfg.name} is a vlm config: its forward takes img_embeds "
            f"(B, {cfg.num_image_tokens}, {cfg.d_model}), the image patch "
            "embeddings in front of the text, and none were given")
    img = img_embeds.to(h.dtype) + params["img_pos"].to(h.dtype)[None]
    return torch.cat([img, h], dim=1)


def unembed(params, cfg, h, norm_impl: str = "kernel",
            psum_dtype=torch.float32):
    """The final norm and the vocab projection.  Where the vocab is split
    over the model axis (``use_top``), each rank projects onto its columns
    and the logits are gathered whole over the model group."""
    h = apply_norm(params["final_norm"], h, cfg, norm_impl)
    if cfg.tie_embeddings:
        table = params["embed"]["table"]
        g = tp_group(table, 0)
        logits = coll.copy_to(h, g, psum_dtype) @ table.to(h.dtype).T
    else:
        w = params["lm_head"]["kernel"]
        g = tp_group(w, 1)
        logits = col_proj_tp(h, w, psum_dtype=psum_dtype)
    return coll.gather_from(logits, -1, g)


# each layer body returns (h, aux, cache): aux is the MoE load-balance
# loss of a moe layer, None for the others

def _ffn(lp, cfg, f_in, opts: ForwardOpts):
    """The dense FFN, or a moe layer's experts (each sequence routes on its
    own; with ``opts.moe_ep`` expert parallel, ``parallel.epmoe``).
    Returns (y, aux | None)."""
    if "moe" in lp:
        if opts.moe_ep:
            from repro_torch.parallel.epmoe import moe_ffn_ep
            return moe_ffn_ep(lp["moe"], cfg, f_in)
        return moe_mod.moe_ffn(lp["moe"], cfg, f_in,
                               tp_shardmap=opts.tp_shardmap)
    return mlp_mod.mlp(lp["mlp"], cfg, f_in, opts.tp_shardmap), None


def _attention(p, cfg, x, opts: ForwardOpts, collect: bool):
    # flat_heads repeats K/V, so it is off when the (grouped) decode cache
    # is collected, as in JAX
    return attn.attention_block(p, cfg, x, impl=opts.attn_impl,
                                norm_impl=opts.norm_impl,
                                q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk,
                                flat_heads=opts.flat_heads and not collect,
                                tp_shardmap=opts.tp_shardmap)


def _attn_layer(lp, cfg, h, opts: ForwardOpts, collect: bool = False):
    a_in = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    a, (k, v) = _attention(lp["attn"], cfg, a_in, opts, collect)
    h = h + a
    f, aux = _ffn(lp, cfg, apply_norm(lp["ln2"], h, cfg, opts.norm_impl),
                  opts)
    return h + f, aux, {"k": k, "v": v}


# K6 and K7 have no final-state output (neither have the TPU kernels), so a
# collected cache takes the plain chunked forms, as JAX takes "xla" there

def _ssm_layer(lp, cfg, h, opts: ForwardOpts, collect: bool = False):
    x = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    y, (shift1, wkv) = rwkv6.tmix_block(
        lp["tmix"], cfg, x, impl="plain" if collect else opts.mixer_impl,
        tp_shardmap=opts.tp_shardmap)
    h = h + y
    x2 = apply_norm(lp["ln2"], h, cfg, opts.norm_impl)
    y2, shift2 = rwkv6.cmix_block(lp["cmix"], cfg, x2,
                                  tp_shardmap=opts.tp_shardmap)
    return h + y2, None, {"shift1": shift1, "wkv": wkv, "shift2": shift2}


def _hybrid_layer(lp, cfg, h, opts: ForwardOpts, collect: bool = False):
    x = apply_norm(lp["ln1"], h, cfg, opts.norm_impl)
    y, (conv, ssm) = mamba2.mamba_block(
        lp["mamba"], cfg, x, impl="plain" if collect else opts.mixer_impl,
        norm_impl=opts.norm_impl, tp_shardmap=opts.tp_shardmap)
    if not collect:
        return h + y, None, None
    return h + y, None, {"conv": torch.cat(conv, dim=-1), "ssm": ssm}


def _shared_in(sp, h, emb0):
    """Zamba2's shared block input: the residual stream and the embedding
    output, concatenated and projected (2d -> d)."""
    return torch.cat([h, emb0], dim=-1) @ sp["in_proj"]["kernel"].to(h.dtype)


def _shared_ffn(sp, cfg, u, norm_impl: str, tp_shardmap: bool = False):
    return u + mlp_mod.mlp(sp["mlp"], cfg,
                           apply_norm(sp["ln2"], u, cfg, norm_impl),
                           tp_shardmap)


def _shared_block(sp, cfg, h, emb0, opts: ForwardOpts, collect: bool = False):
    """Zamba2's shared block through attention (K2 under
    ``attn_impl="flash"``) and the FFN; its output is added to h.  Returns
    (h, {"k", "v"})."""
    u = _shared_in(sp, h, emb0)
    a, (k, v) = _attention(sp["attn"], cfg,
                           apply_norm(sp["ln1"], u, cfg, opts.norm_impl),
                           opts, collect)
    return (h + _shared_ffn(sp, cfg, u + a, opts.norm_impl,
                            opts.tp_shardmap), {"k": k, "v": v})


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
    i % every == every - 1.

    Under a sharding context on a mesh of processes (see the module), the
    forward is this rank's share: ``tokens`` are its batch rows, the
    parameters its shards, and a collected cache holds its rows (with the
    K/V heads of its projections, and the recurrent states of its mixers'
    channels and heads: its own where the rules split them; a hybrid conv
    state is its x channels, then B and C)."""
    layer = {"dense": _attn_layer, "vlm": _attn_layer, "moe": _attn_layer,
             "ssm": _ssm_layer, "hybrid": _hybrid_layer}[cfg.family]
    sf = sharding.sharded_forward(cfg, build_spec)
    psum = None if opts.tp_shardmap else torch.float32
    params = use_top(params, sf)
    h = embed_inputs(params, cfg, tokens, img_embeds, psum)
    emb0 = h

    def body(h, i):
        h, aux, cache = layer(use(params, "layers", sf, i), cfg, h, opts,
                              collect_cache)
        kv = None
        if _fires(cfg, i):
            h, kv = _shared_block(use(params, "shared", sf), cfg, h, emb0,
                                  opts, collect_cache)
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
    logits = unembed(params, cfg, h, opts.norm_impl, psum)
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


#: the logical axes of a decode cache's leaves, by leaf name (the JAX
#: ``cache_logical_axes``' table); zamba2's shared K/V take k's and v's
CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "shift1": ("layers", "batch", None, "embed"),
    "shift2": ("layers", "batch", None, "embed"),
    "wkv": ("layers", "batch", "rwkv_heads", None, None),
    "conv": ("layers", "batch", "conv", "mamba_inner"),
    "ssm": ("layers", "batch", "mamba_heads", None, "state"),
}


def cache_logical_axes(cfg, cache):
    """The logical axes of every leaf of ``init_cache``'s cache (the JAX
    ``cache_logical_axes``), a tree like the cache."""
    del cfg

    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return CACHE_AXES[name]
    return walk(cache)


def _cache_split(cache, part, name, axes, sf):
    """(the mesh axes splitting the sequence dim, their group, this rank's
    first position) of the leaf ``cache[part][name]``, a shard from
    ``shard_cache`` of a dense cache leaf (L, B, S, ...) whose logical
    ``axes`` name its dims; its global shape is the cache's
    ``"global_shapes"`` entry.  Raises where the split is not one this step
    runs: the batch dim split other than the batch rows, or a dim past the
    sequence split."""
    full = cache.get("global_shapes", {}).get(part, {}).get(name)
    if full is None:
        raise ValueError(
            "under a sharding context the decode step takes this rank's "
            "shards of the dense cache from LM.shard_cache (or "
            "transformer.shard_cache), which records the cache's global "
            "shapes")
    spec = sharding.spec_for(axes, full, sf.rules, sf.mesh)
    entries = tuple(spec) + (None,) * (len(full) - len(spec))
    ax = sharding.spec_axes
    if entries[0] is not None or ax((entries[1],)) != sf.batch_axes:
        raise ValueError(f"a cache leaf split {entries} does not split its "
                         f"batch rows over the batch axes {sf.batch_axes}")
    if any(e is not None for e in entries[3:]):
        raise ValueError(f"a cache leaf split {entries} past its sequence "
                         "dim: the sharded decode splits the batch rows and "
                         "the sequence only")
    seq = ax((entries[2],))
    if not seq:
        return (), None, 0
    return (seq, sf.mesh.group(seq),
            sf.mesh.index(seq) * cache[part][name].shape[2])


def shard_cache(cfg, cache, mesh, rules, axes=None):
    """This rank's shards of a whole dense cache (``init_cache``'s, or its
    meta stand-in) under ``rules`` by ``axes`` (default
    ``cache_logical_axes``), with ``"global_shapes"``: each leaf's whole
    shape, a tree like the cache's, which the sharded ``decode_step``
    reads (a shard alone cannot tell whether a rule split it)."""
    axes = axes if axes is not None else cache_logical_axes(cfg, cache)
    specs = sharding.logical_to_sharding(axes, cache, mesh, rules)

    def walk(t, spec, leaf):
        if isinstance(t, dict):
            return {k: walk(v, spec[k], leaf) for k, v in t.items()}
        return leaf(t, spec)
    out = walk(cache, specs, lambda t, spec: sharding.shard(t, spec, mesh))
    out["global_shapes"] = walk(cache, specs, lambda t, _: tuple(t.shape))
    return out


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
    Returns (logits (B, 1, Vp), cache).

    Under a sharding context on a mesh of processes, ``tokens`` and
    ``positions`` are the global batch's and ``cache`` this rank's shards
    of the dense cache (``shard_cache``); see ``_sharded_decode``.  The
    returned logits are the whole batch's, on every rank."""
    page_table = cache.get("page_table")
    sf = sharding.sharded_forward(cfg, build_spec)
    if sf is not None:
        if page_table is not None or pool_group is not None \
                or dp_group is not None:
            raise ValueError(
                "under a sharding context the decode step runs over the "
                "dense cache of init_cache (shard_cache); paged pools and "
                "pool groups split pages instead")
        return _sharded_decode(params, cfg, tokens, cache, positions, sf,
                               norm_impl), cache
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


def _sharded_decode(params, cfg, tokens, cache, positions, sf, norm_impl):
    """The decode step of this rank of ``sf``'s mesh (the decode the JAX
    dry-run lowers with the cache sharded by ``cache_logical_axes``): this
    rank's rows of the global ``tokens`` and ``positions`` over its shards
    of the dense cache; each layer's weights gathered over the batch axes
    just before the layer (FSDP, ``ShardedForward.use``); the projections,
    MLP, experts, mixers and vocab projection tensor-parallel where the
    rules split their weights; the attention over this rank's rows of the
    sequence, merged over the sequence split
    (``attention.sharded_attention_decode_block``); a moe layer routes the
    whole batch as one group, its rows gathered over the batch axes first,
    as the single-rank step routes them; the hybrid and ssm families over
    their state shards (``_recurrent_decode``).  Returns the whole batch's
    logits (B, 1, Vp), gathered over the batch axes."""
    mesh, rules = sf.mesh, sf.rules
    rows = sharding.batch_rows(mesh, rules, tokens.shape[0])
    dp = mesh.group(sf.batch_axes) if sf.batch_axes else None
    tokens, positions = tokens[rows], positions[rows]
    params = use_top(params, sf)
    if cfg.family in ("hybrid", "ssm"):
        logits = _recurrent_decode(params, cfg, tokens, cache, positions,
                                   norm_impl, sf)
        return coll.gather_from(logits, 0, dp)
    kc, vc = cache["layers"]["k"], cache["layers"]["v"]
    _, seq_group, offset = _cache_split(cache, "layers", "k",
                                        CACHE_AXES["k"], sf)
    h = embed(params, cfg, tokens)
    for i in range(cfg.num_layers):
        lp = use(params, "layers", sf, i)
        h = h + attn.sharded_attention_decode_block(
            lp["attn"], cfg, apply_norm(lp["ln1"], h, cfg, norm_impl),
            kc[i], vc[i], positions, seq_group, offset, norm_impl)
        f_in = apply_norm(lp["ln2"], h, cfg, norm_impl)
        if "moe" in lp:
            whole = coll.gather_from(f_in, 0, dp)
            h = h + moe_mod.moe_ffn_decode(lp["moe"], cfg, whole)[0][rows]
        else:
            h = h + mlp_mod.mlp(lp["mlp"], cfg, f_in)
    return coll.gather_from(unembed(params, cfg, h, norm_impl), 0, dp)


#: the dim of each recurrent state leaf that a split can cut past its
#: batch rows: the shift states' and the conv state's channels, the WKV
#: and SSM states' heads
_STATE_DIM = {"shift1": 3, "shift2": 3, "conv": 3, "wkv": 2, "ssm": 2}


def _state_entry(cache, name, sf):
    """The spec entry (None: whole) splitting the state dim of the
    recurrent leaf ``cache["layers"][name]``, a shard from ``shard_cache``
    whose global shape is the cache's ``"global_shapes"`` entry.  Raises
    where the split is not one this step reads: the batch dim split other
    than the batch rows, or another dim split."""
    full = cache.get("global_shapes", {}).get("layers", {}).get(name)
    if full is None:
        raise ValueError(
            "under a sharding context the decode step takes this rank's "
            "shards of the dense cache from LM.shard_cache (or "
            "transformer.shard_cache), which records the cache's global "
            "shapes")
    spec = sharding.spec_for(CACHE_AXES[name], full, sf.rules, sf.mesh)
    entries = tuple(spec) + (None,) * (len(full) - len(spec))
    dim = _STATE_DIM[name]
    if entries[0] is not None or sharding.spec_axes(
            (entries[1],)) != sf.batch_axes or any(
            e is not None for j, e in enumerate(entries) if j > 1
            and j != dim):
        raise ValueError(f"a {name} state split {entries}: the sharded "
                         "decode splits the batch rows and the state's "
                         f"dim {dim} only")
    return entries[dim]


def _group(entry, sf):
    return None if entry is None else sf.mesh.group(
        sharding.spec_axes((entry,)))


def _block(t, dim: int, entry, sf):
    """This rank's block along ``dim`` of ``t``, whole there, under a spec
    ``entry`` (None: all of it)."""
    if entry is None:
        return t
    axes = sharding.spec_axes((entry,))
    n = t.shape[dim] // sf.mesh.axis_size(axes)
    return t.narrow(dim, sf.mesh.index(axes) * n, n)


def _regroup(t, dim: int, have, want, sf):
    """``t``, split along ``dim`` by the spec entry ``have``, split by
    ``want`` instead (gathered over ``have``'s group where they differ)."""
    if have == want:
        return t
    return _block(coll.all_gather(t, dim, _group(have, sf)), dim, want, sf)


def _state_in(name, t, have, want, sf, din: int):
    """One layer's state shard ``t`` (split by the cache's entry ``have``)
    as the mixer reads it (split by its weights' entry ``want``).  The
    conv state's shard of d_inner + 2N columns does not line up with the
    mixer's d_inner / n x channels (nor its B and C, whole on every rank):
    it is gathered whole and cut to the x channels, then B and C."""
    dim = _STATE_DIM[name] - 1
    if name != "conv":
        return _regroup(t, dim, have, want, sf)
    whole = coll.all_gather(t, dim, _group(have, sf))
    return torch.cat([_block(whole[..., :din], dim, want, sf),
                      whole[..., din:]], dim)


def _state_out(name, t, have, want, sf, din_local: int):
    """The mixer's new state ``t`` as the cache's shard holds it: the
    inverse of ``_state_in`` (the conv state's x channels gathered whole
    over the mixer's group, then the cache's block taken)."""
    dim = _STATE_DIM[name] - 1
    if name != "conv":
        return _regroup(t, dim, want, have, sf)
    xs = coll.all_gather(t[..., :din_local], dim, _group(want, sf))
    return _block(torch.cat([xs, t[..., din_local:]], dim), dim, have, sf)


def _mixer_entries(lp, cfg):
    """The spec entry by which each recurrent state's dim is split in the
    mixer's weights (``ShardedForward.use``'s ``mesh_axes``)."""
    if cfg.family == "ssm":
        return {"shift1": None, "shift2": None,
                "wkv": lp["tmix"]["u"].mesh_axes[0]}
    return {"conv": lp["mamba"]["wx"]["kernel"].mesh_axes[1],
            "ssm": lp["mamba"]["A_log"].mesh_axes[0]}


def _recurrent_decode(params, cfg, tokens, cache, positions, norm_impl,
                      sf=None):
    """The ssm and hybrid decode step (the JAX ``decode_step`` bodies):
    every layer's exact single-step recurrence (plain torch: neither
    package has a kernel for it), its new states copied into the cache in
    place; zamba2's shared block decodes over its raw dense K/V rows at
    ``positions``.  Under a ``ShardedForward`` these are this rank's rows
    and shards, each layer's weights gathered just before it; each state
    shard is moved to the split its mixer reads (``_state_in``: as it is
    where they line up, gathered where they do not, as zamba2's conv state
    over a model split) and back (``_state_out``), and the shared block
    attends over a sequence split where the rules make one.  Returns the
    logits (B, 1, Vp)."""
    states = cache["layers"]
    have = (None if sf is None else
            {name: _state_entry(cache, name, sf) for name in states})
    h = embed(params, cfg, tokens)
    emb0 = h
    n_shared = 0
    for i in range(cfg.num_layers):
        lp = use(params, "layers", sf, i)
        st = {name: t[i] for name, t in states.items()}
        if sf is not None:
            want = _mixer_entries(lp, cfg)
            st = {name: _state_in(name, t, have[name], want[name], sf,
                                  cfg.d_inner) for name, t in st.items()}
        x = apply_norm(lp["ln1"], h, cfg, norm_impl)
        if cfg.family == "ssm":
            y, (shift1, wkv) = rwkv6.tmix_block(
                lp["tmix"], cfg, x, shift_state=st["shift1"],
                wkv_state=st["wkv"], decode=True)
            h = h + y
            x2 = apply_norm(lp["ln2"], h, cfg, norm_impl)
            y2, shift2 = rwkv6.cmix_block(lp["cmix"], cfg, x2,
                                          shift_state=st["shift2"])
            h = h + y2
            new = {"shift1": shift1, "wkv": wkv, "shift2": shift2}
        else:
            y, (conv, ssm) = mamba2.mamba_block(
                lp["mamba"], cfg, x, norm_impl=norm_impl,
                conv_state=st["conv"], ssm_state=st["ssm"], decode=True)
            h = h + y
            new = {"conv": torch.cat(conv, dim=-1), "ssm": ssm}
            if _fires(cfg, i):
                sp, skv = use(params, "shared", sf), cache["shared"]
                u = _shared_in(sp, h, emb0)
                a_in = apply_norm(sp["ln1"], u, cfg, norm_impl)
                k, v = skv["k"][n_shared], skv["v"][n_shared]
                if sf is None:
                    a = attn.attention_decode_block(
                        sp["attn"], cfg, a_in, k, v, positions,
                        norm_impl=norm_impl)
                else:
                    _, group, offset = _cache_split(
                        cache, "shared", "k", CACHE_AXES["k"], sf)
                    a = attn.sharded_attention_decode_block(
                        sp["attn"], cfg, a_in, k, v, positions, group,
                        offset, norm_impl)
                h = h + _shared_ffn(sp, cfg, u + a, norm_impl)
                n_shared += 1
        if sf is not None:
            din_local = lp["mamba"]["wx"]["kernel"].shape[1] \
                if cfg.family == "hybrid" else 0
            new = {name: _state_out(name, t, have[name], want[name], sf,
                                    din_local) for name, t in new.items()}
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
