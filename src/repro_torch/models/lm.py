"""Top-level model facade of the port (counterpart of the JAX
``repro.models.lm.LM``) for every family: the decoder-only stack
(``transformer``: dense, vlm, moe, hybrid, ssm) and the encoder-decoder
(``encdec``).  The recurrent families and encdec prefill and decode over
their raw dense cache only.  ``input_specs`` and ``input_logical_axes``
describe a shape cell's batch on meta tensors, for the dry-run."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import (DTYPES, abstract_params, cross_entropy,
                                       init_params, logical_axes,
                                       resolve_device)
from repro_torch.models.transformer import ForwardOpts
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding


@dataclass
class LM:
    cfg: ModelConfig

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def spec(self):
        return (encdec.build_spec(self.cfg) if self.is_encdec
                else transformer.build_spec(self.cfg))

    def init(self, seed: int = 0, device="cuda", dtype=None):
        """Random parameters from an explicit generator seeded with
        ``seed``, on ``device`` (CUDA unless the caller asks for the CPU),
        matrices in ``dtype`` (default ``cfg.dtype``), norms in fp32."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_params(self.spec(), gen, dev,
                           dtype or DTYPES[self.cfg.dtype])

    def abstract_params(self):
        """Meta tensors with the shapes and dtypes of ``init(dtype=
        param_dtype)``'s leaves (the JAX ``LM.abstract_params``)."""
        return abstract_params(self.spec(), DTYPES[self.cfg.param_dtype])

    def param_logical_axes(self):
        """Each parameter's logical axes (the JAX ``LM.param_logical_axes``),
        which ``parallel.sharding.spec_for`` resolves on a mesh."""
        return logical_axes(self.spec())

    def _enc(self, enc_embeds):
        if enc_embeds is None:
            raise ValueError(
                f"{self.cfg.name} is an encdec config: its forward takes "
                f"enc_embeds (B, S // {self.cfg.enc_ratio}, "
                f"{self.cfg.d_model}), the stub audio frontend's frame "
                "embeddings, and none were given")
        return enc_embeds

    def forward(self, params, tokens, opts: ForwardOpts = ForwardOpts(),
                collect_cache: bool = False, img_embeds=None,
                enc_embeds=None, return_aux: bool = False):
        """``img_embeds`` (B, num_image_tokens, d): a vlm config's image,
        in front of the text (``transformer.embed_inputs``);
        ``enc_embeds`` (B, S // enc_ratio, d): an encdec config's frames,
        which its encoder reads.  Returns (logits, cache | None), and with
        ``return_aux`` the ``moe_aux`` (0 but for the moe family)."""
        if self.is_encdec:
            logits, cache = encdec.forward(params, self.cfg, tokens,
                                           self._enc(enc_embeds), opts,
                                           collect_cache)
            if not return_aux:
                return logits, cache
            return logits, cache, torch.zeros((), device=logits.device)
        return transformer.forward(params, self.cfg, tokens, opts,
                                   collect_cache, img_embeds=img_embeds,
                                   return_aux=return_aux)

    def loss(self, params, batch, opts: ForwardOpts = ForwardOpts(),
             moe_aux_weight: float = 1e-2, z_loss: float = 1e-4):
        """Next-token loss of ``batch`` = {"tokens", "labels"}, both (B, S)
        int tensors; for a vlm config "img_embeds" (B, n, d), whose n
        image positions' logits are dropped before the loss; for an encdec
        config "enc_embeds" (B, S // enc_ratio, d).  Returns (loss,
        {"loss", "nll", "z_loss", "moe_aux"}), the JAX ``LM.loss``: the
        loss adds ``moe_aux_weight`` times the layers' summed MoE
        load-balance loss (0 but for the moe family).

        Under a sharding context on a mesh of processes, ``batch`` is this
        rank's rows of the global batch (``make_train_step`` takes them):
        the loss returned is this rank's share (its tokens' loss over the
        global count, its aux loss over the dp ranks), whose gradients
        summed over the dp group are the global loss's, and the metrics
        are the global batch's, the same on every rank."""
        logits, _, aux = self.forward(params, batch["tokens"], opts,
                                      img_embeds=batch.get("img_embeds"),
                                      enc_embeds=batch.get("enc_embeds"),
                                      return_aux=True)
        if transformer.has_image(self.cfg):
            logits = logits[:, self.cfg.num_image_tokens:]
        loss, ce = cross_entropy(logits, batch["labels"], self.cfg.vocab_size,
                                 z_loss=z_loss, impl=opts.xent_impl)
        loss = loss + moe_aux_weight * aux
        metrics = {"loss": loss, "nll": ce["nll"], "z_loss": ce["z_loss"],
                   "moe_aux": aux}
        ctx = sharding.active_mesh()
        if ctx is None:
            return loss, metrics
        # this rank's share: its rows' loss over the dp ranks' count, so the
        # shares' gradients sum, over the dp group, to the global loss's
        mesh, rules = ctx
        axes = sharding.batch_axes(mesh, rules)
        n_dp = mesh.axis_size(axes) if axes else 1
        dp = mesh.group(axes) if axes else None
        return loss / n_dp, {k: coll.all_reduce(v.detach(), dp) / n_dp
                             for k, v in metrics.items()}

    def prefill(self, params, tokens, opts: ForwardOpts = ForwardOpts(),
                img_embeds=None, enc_embeds=None):
        """The JAX ``LM.prefill``: (the last row's logits (B, 1, Vp), the
        cache of ``forward(collect_cache=True)``).  A vlm prefill takes the
        image (``img_embeds``), whose rows lead the cache; an encdec
        prefill the frames (``enc_embeds``), whose cross-attention K/V the
        cache holds beside the decoder's.  For the
        recurrent families the cache holds the final states (and zamba2's
        shared K/V over the S prompt rows), which ``decode_step`` continues
        from once the K/V rows are copied into a cache of the decode
        length (for encdec: its self-attention K/V).

        Under a sharding context on a mesh of processes, ``tokens`` and the
        embeddings are the global batch's: this rank runs its rows, and
        the last row's logits of the whole batch come back on every rank,
        with this rank's cache (its rows; the K/V heads its projections
        computed)."""
        ctx = sharding.active_mesh()
        if ctx is None:
            logits, cache = self.forward(params, tokens, opts,
                                         collect_cache=True,
                                         img_embeds=img_embeds,
                                         enc_embeds=enc_embeds)
            return logits[:, -1:], cache
        mesh, rules = ctx
        rows = sharding.batch_rows(mesh, rules, tokens.shape[0])
        axes = sharding.batch_axes(mesh, rules)
        logits, cache = self.forward(
            params, tokens[rows], opts, collect_cache=True,
            img_embeds=None if img_embeds is None else img_embeds[rows],
            enc_embeds=None if enc_embeds is None else enc_embeds[rows])
        return (coll.gather_from(logits[:, -1:], 0,
                                 mesh.group(axes) if axes else None), cache)

    def decode_step(self, params, tokens, cache, positions,
                    decode_impl: str = "kernel", norm_impl: str = "kernel",
                    pool_group=None, dp_group=None):
        """One token per slot at (B,) positions (``transformer.decode_step``;
        an encdec config: ``encdec.decode_step`` over its dense cache,
        ``decode_impl`` ignored).  Under a sharding context, the global
        batch's tokens and positions over this rank's cache shards
        (``shard_cache``), the whole batch's logits on every rank."""
        if self.is_encdec:
            if pool_group is not None or dp_group is not None:
                raise ValueError("sharded paged decode is decoder-only")
            return encdec.decode_step(params, self.cfg, tokens, cache,
                                      positions, norm_impl=norm_impl)
        return transformer.decode_step(params, self.cfg, tokens, cache,
                                       positions, decode_impl=decode_impl,
                                       norm_impl=norm_impl,
                                       pool_group=pool_group,
                                       dp_group=dp_group)

    def cache_logical_axes(self, cache):
        """The logical axes of every leaf of the raw dense cache: the
        decoder stack's ``transformer.cache_logical_axes``, and for encdec
        ("layers", "batch", "kv_seq", "kv_heads", None) on every leaf,
        the cross-attention K/V's too (JAX's ``input_logical_axes``)."""
        if self.is_encdec:
            return {k: _tree_const(v, encdec.ENC_CACHE_AXES)
                    for k, v in cache.items()}
        return transformer.cache_logical_axes(self.cfg, cache)

    def shard_cache(self, cache, mesh, rules):
        """This rank's shards of a whole raw dense cache, which the sharded
        ``decode_step`` takes (``transformer.shard_cache``)."""
        return transformer.shard_cache(self.cfg, cache, mesh, rules,
                                       self.cache_logical_axes(cache))

    def prefill_chunk(self, params, tokens, cache, start_pos, dest, last_pos,
                      norm_impl: str = "kernel", pool_group=None,
                      dp_group=None):
        """One chunk of chunked prefill over a paged cache view whose
        ``"page_table"`` holds the slots' real rows; pools written in
        place.  Returns (logits (B, 1, Vp) at each chunk's last valid row,
        cache).  See ``transformer.prefill_chunk``."""
        if self.is_encdec:
            raise ValueError(
                "chunked prefill is decoder-only (encdec prefill is "
                "per-request dense state)")
        return transformer.prefill_chunk(params, self.cfg, tokens, cache,
                                         start_pos, dest, last_pos,
                                         norm_impl=norm_impl,
                                         pool_group=pool_group,
                                         dp_group=dp_group)

    def init_cache(self, batch_size: int, max_seq: int,
                   backend: Optional[str] = "paged", page_size: int = 16,
                   num_pages: Optional[int] = None,
                   prefix_sharing: bool = True, device="cuda", dtype=None,
                   kv_dtype: str = "native", pool_group=None,
                   locality_chips: Optional[int] = None, dp_group=None,
                   host_pages: int = 0, prefix_store=None,
                   enc_len: int = 0):
        """Decode cache construction (the JAX ``LM.init_cache``).
        ``backend=None`` returns the raw dense cache, ``{"layers": {"k":
        (L, B, S, KV, D), "v": ...}}``, which ``decode_step`` takes
        directly; ``"contiguous"`` or ``"paged"`` a managed cache of
        ``repro_torch.serve.kvcache`` for the serve engine.  The port's
        default is ``"paged"`` (JAX's is ``None``): its callers are serve
        caches.  ``kv_dtype="int8"`` (paged only) stores int8 pages with
        per-row fp32 scales; ``pool_group`` (paged only, the counterpart of
        the JAX ``mesh``/``kv_axis``) splits the pool over its ranks, and
        ``dp_group`` (the JAX ``dp_axis``) names the dp group of a 2-D batch
        x pages mesh; ``locality_chips`` (paged only) partitions only the
        free list; ``host_pages`` / ``prefix_store`` (paged only) put a
        host-RAM page tier behind the pool (``repro_torch.serve.offload``).
        The recurrent families take ``backend=None`` only: their states
        (and zamba2's shared K/V rows) have no pages, and the serve engine
        does not serve them, as in JAX.  So does encdec, whose raw cache
        adds the cross-attention K/V ``"xk"``/``"xv"`` (L, B, enc_len, KV,
        D), ``enc_len`` defaulting to ``max_seq // enc_ratio``."""
        if self.is_encdec and (backend is not None or pool_group is not None
                               or dp_group is not None):
            raise ValueError(
                "paged KV covers decoder self-attention caches; encdec "
                "cross-attention K/V is per-request dense state (use "
                "backend=None)")
        if self.cfg.family not in ("dense", "vlm", "moe") and (
                backend is not None or pool_group is not None
                or dp_group is not None):
            raise ValueError(
                f"the {self.cfg.family} family ({self.cfg.name}) decodes "
                "over its raw state cache (backend=None): recurrent state "
                "has no page structure for a managed backend or a pool "
                "group")
        dtype = dtype or DTYPES[self.cfg.dtype]
        if backend == "paged":
            from repro_torch.serve.kvcache import PagedCache
            return PagedCache(self.cfg, batch_size, max_seq,
                              page_size=page_size, num_pages=num_pages,
                              prefix_sharing=prefix_sharing, device=device,
                              dtype=dtype, kv_dtype=kv_dtype,
                              pool_group=pool_group,
                              locality_chips=locality_chips,
                              dp_group=dp_group, host_pages=host_pages,
                              prefix_store=prefix_store)
        if backend not in (None, "contiguous"):
            raise ValueError(f"cache backend {backend!r} not in (None, "
                             "'contiguous', 'paged')")
        if kv_dtype != "native":
            raise ValueError(
                f"kv_dtype={kv_dtype!r}: the int8 page format quantizes "
                "fixed-size pages with per-row scales; the dense layout has "
                "no pages (use backend='paged')")
        if (pool_group is not None or locality_chips is not None
                or dp_group is not None):
            raise ValueError(
                "pool_group and locality_chips split the paged pool's pages; "
                "the dense layout has no pages (use backend='paged')")
        if host_pages or prefix_store is not None:
            raise ValueError(
                "the host page tier offloads and prefetches fixed-size "
                "pages under the prefix-sharing key; the contiguous "
                "layout has neither (use backend='paged' for host_pages/"
                "prefix_store)")
        dev = resolve_device(device)
        if backend is None and self.is_encdec:
            return encdec.init_cache(
                self.cfg, batch_size, max_seq,
                enc_len or max_seq // self.cfg.enc_ratio, dev, dtype)
        if backend is None:
            return transformer.init_cache(self.cfg, batch_size, max_seq, dev,
                                          dtype)
        from repro_torch.serve.kvcache import ContiguousCache
        return ContiguousCache(self.cfg, batch_size, max_seq, device=dev,
                               dtype=dtype)


def _tree_const(tree, value):
    if isinstance(tree, dict):
        return {k: _tree_const(v, value) for k, v in tree.items()}
    return value


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions of a ``seq_len`` sequence: a vlm config's image takes
    its first ``num_image_tokens`` (the JAX ``text_len``)."""
    if transformer.has_image(cfg):
        return seq_len - cfg.num_image_tokens
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta tensors standing in for the batch of a shape cell (the JAX
    ``input_specs``' ``ShapeDtypeStruct``s; nothing is allocated).

    - train/prefill: int32 tokens (+ labels for train) and any stub
      frontend's embeddings in ``dtype`` (a vlm config's image patches, an
      encdec config's frames).
    - decode: one new int32 token per sequence, the raw dense cache at
      seq_len (``LM.init_cache(backend=None, device="meta")``) and the 0-d
      int32 ``cache_index``, the position every sequence decodes at.
    """
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        st = text_len(cfg, s)
        batch: Dict[str, Any] = {"tokens": meta((b, st))}
        if shape.kind == "train":
            batch["labels"] = meta((b, st))
        if transformer.has_image(cfg):
            batch["img_embeds"] = meta((b, cfg.num_image_tokens, cfg.d_model),
                                       dtype)
        if cfg.family == "encdec":
            batch["enc_embeds"] = meta((b, s // cfg.enc_ratio, cfg.d_model),
                                       dtype)
        return batch
    if shape.kind == "decode":
        return {"tokens": meta((b, 1)),
                "cache": LM(cfg).init_cache(b, s, backend=None,
                                            device="meta", dtype=dtype),
                "cache_index": meta(())}
    raise ValueError(shape.kind)


def input_logical_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The logical axes of every leaf of ``input_specs`` (the JAX
    ``input_logical_axes``)."""
    if shape.kind in ("train", "prefill"):
        axes: Dict[str, Any] = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            axes["labels"] = ("batch", "seq")
        if transformer.has_image(cfg):
            axes["img_embeds"] = ("batch", "seq", "embed")
        if cfg.family == "encdec":
            axes["enc_embeds"] = ("batch", "enc_seq", "embed")
        return axes
    lm = LM(cfg)
    cache = lm.init_cache(shape.global_batch, shape.seq_len, backend=None,
                          device="meta")
    return {"tokens": ("batch", None), "cache": lm.cache_logical_axes(cache),
            "cache_index": ()}


def make_batch(cfg: ModelConfig, shape_or_bs, seq_len: int = 0, rng=None,
               dtype=torch.bfloat16):
    """A random batch on the CPU (the JAX ``make_batch``): int32 "tokens"
    and "labels" (B, text_len), and for a vlm config "img_embeds", for an
    encdec config "enc_embeds", normal draws in ``dtype``.  The draws are
    JAX's numpy ``default_rng(rng or 0)`` calls in JAX's order, and the
    embeddings round through fp32 as JAX's conversion does, so the batch
    equals JAX's bit for bit."""
    if isinstance(shape_or_bs, ShapeConfig):
        b, s = shape_or_bs.global_batch, shape_or_bs.seq_len
    else:
        b, s = shape_or_bs, seq_len
    gen = np.random.default_rng(0 if rng is None else rng)
    st = text_len(cfg, s)

    def ints():
        return torch.from_numpy(
            gen.integers(0, cfg.vocab_size, (b, st)).astype(np.int32))

    def normal(shape):
        return torch.from_numpy(
            gen.normal(0, 1, shape).astype(np.float32)).to(dtype)

    batch = {"tokens": ints(), "labels": ints()}
    if transformer.has_image(cfg):
        batch["img_embeds"] = normal((b, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        batch["enc_embeds"] = normal((b, s // cfg.enc_ratio, cfg.d_model))
    return batch
