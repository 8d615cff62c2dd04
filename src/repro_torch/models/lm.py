"""Top-level model facade of the port (counterpart of the JAX
``repro.models.lm.LM``) for the dense family."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import (DTYPES, cross_entropy, init_params,
                                       resolve_device)
from repro_torch.models.transformer import ForwardOpts


@dataclass
class LM:
    cfg: ModelConfig

    def spec(self):
        return transformer.build_spec(self.cfg)

    def init(self, seed: int = 0, device="cuda", dtype=None):
        """Random parameters from an explicit generator seeded with
        ``seed``, on ``device`` (CUDA unless the caller asks for the CPU),
        matrices in ``dtype`` (default ``cfg.dtype``), norms in fp32."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_params(self.spec(), gen, dev,
                           dtype or DTYPES[self.cfg.dtype])

    def forward(self, params, tokens, opts: ForwardOpts = ForwardOpts(),
                collect_cache: bool = False):
        return transformer.forward(params, self.cfg, tokens, opts,
                                   collect_cache)

    def loss(self, params, batch, opts: ForwardOpts = ForwardOpts(),
             moe_aux_weight: float = 1e-2, z_loss: float = 1e-4):
        """Next-token loss of ``batch`` = {"tokens", "labels"}, both (B, S)
        int tensors.  Returns (loss, {"loss", "nll", "z_loss", "moe_aux"}),
        the JAX ``LM.loss`` for the dense family, whose ``moe_aux`` is 0,
        so ``moe_aux_weight`` adds nothing."""
        logits, _ = self.forward(params, batch["tokens"], opts)
        loss, ce = cross_entropy(logits, batch["labels"], self.cfg.vocab_size,
                                 z_loss=z_loss, impl=opts.xent_impl)
        return loss, {"loss": loss, "nll": ce["nll"], "z_loss": ce["z_loss"],
                      "moe_aux": torch.zeros((), device=loss.device)}

    def decode_step(self, params, tokens, cache, positions,
                    decode_impl: str = "kernel", norm_impl: str = "kernel"):
        return transformer.decode_step(params, self.cfg, tokens, cache,
                                       positions, decode_impl=decode_impl,
                                       norm_impl=norm_impl)

    def init_cache(self, batch_size: int, max_seq: int,
                   backend: str = "paged", page_size: int = 16,
                   num_pages: Optional[int] = None,
                   prefix_sharing: bool = True, device="cuda", dtype=None):
        """A managed paged KV cache (``repro_torch.serve.kvcache``); the
        paged backend is the only one the port has."""
        if backend != "paged":
            raise ValueError(f"the port has the paged cache backend only "
                             f"(got {backend!r})")
        from repro_torch.serve.kvcache import PagedCache
        return PagedCache(self.cfg, batch_size, max_seq, page_size=page_size,
                          num_pages=num_pages, prefix_sharing=prefix_sharing,
                          device=device,
                          dtype=dtype or DTYPES[self.cfg.dtype])
