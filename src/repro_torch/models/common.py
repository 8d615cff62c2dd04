"""Shared model pieces of the port: the device rule, parameter specs and their
initializer, RMSNorm, RoPE, activations and the cross-entropy loss
(counterpart of the JAX ``repro.models.common``).

A parameter tree is nested dicts of tensors in the JAX layouts.  For serving,
matrix weights are stored in the compute dtype (``cfg.dtype``): the JAX
model keeps fp32 masters and casts them at every use, which gives the same
numbers as casting once at load.  For training they stay fp32
(``cfg.param_dtype``) and the model casts them at every use, as JAX does.
Norm scales stay fp32, because the norm multiplies in fp32.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rmsnorm import rmsnorm_ref
from repro_torch.kernels.softmax_xent import softmax_xent_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is never silently replaced
    by the CPU: asking for it where it is absent raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the port on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ----------------------------------------------------------------- param spec --

@dataclass(frozen=True)
class P:
    """A parameter spec leaf: shape, initializer and its scale.  ``fp32``
    leaves (norm scales) keep fp32 whatever the compute dtype."""
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | ones
    scale: float = 0.02
    fp32: bool = False


def norm_spec(cfg, d: int = 0):
    assert cfg.norm == "rmsnorm", "the port's dense configs use RMSNorm"
    return {"scale": P((d or cfg.d_model,), init="ones", fp32=True)}


def stack_spec(spec, n: int):
    """Add a leading stacked-layers dim to every leaf."""
    if isinstance(spec, P):
        return P((n,) + spec.shape, spec.init, spec.scale, spec.fp32)
    return {k: stack_spec(v, n) for k, v in spec.items()}


def depth_scale(cfg) -> float:
    return 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))


def init_params(spec, generator: torch.Generator, device, dtype):
    """Materialize a spec tree: normal leaves ``scale * N(0, 1)`` in
    ``dtype``, ones leaves in fp32 (or ``dtype`` if not pinned).  Shapes and
    scales match the JAX ``build_spec``; values differ, because the random
    generators differ."""
    if isinstance(spec, P):
        if spec.init == "ones":
            return torch.ones(spec.shape, device=device,
                              dtype=torch.float32 if spec.fp32 else dtype)
        assert spec.init == "normal", spec.init
        w = torch.randn(spec.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(spec.scale).to(torch.float32 if spec.fp32 else dtype)
    return {k: init_params(v, generator, device, dtype)
            for k, v in spec.items()}


# ------------------------------------------------------------------- numerics --

def rms_norm(x, scale, eps: float, impl: str = "kernel"):
    """RMSNorm over the last dim, fp32 math, cast back to x's dtype.
    ``impl="kernel"`` goes through K3 (its plain version on CPU tensors);
    ``"plain"`` always runs the plain version."""
    if impl == "kernel":
        return ops.rmsnorm(x, scale, eps=eps)
    assert impl == "plain", impl
    return rmsnorm_ref(x, scale, eps=eps)


def activation(name: str):
    return {"silu": F.silu, "relu": F.relu,
            # jax.nn.gelu defaults to the tanh approximation
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(device: torch.device, head_dim: int, theta: float):
    # one host-to-device copy per (device, width, theta): a copy from
    # pageable memory on every call would block the host on the stream
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)) \
        .to(device)


def apply_rope(x, positions, theta: float):
    """Half-split RoPE.  x: (..., S, H, D); positions broadcastable to
    (..., S).  Frequencies in float64 numpy, cast to fp32, as JAX does."""
    freqs = _rope_freqs_on(x.device, x.shape[-1], theta)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    angles = angles[..., None, :]                               # head dim
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- losses --

def cross_entropy(logits, labels, vocab_size: int, z_loss: float = 0.0,
                  impl: str = "kernel"):
    """CE over a (possibly vocab-padded) logits tensor; labels < vocab_size.
    Returns (loss, {"nll", "z_loss"}), the JAX ``cross_entropy`` (without
    its token mask, which no caller of the port passes).
    ``impl="kernel"`` reaches K4 (forward and backward; its plain versions
    on CPU tensors); ``"plain"`` is the plain forward, which autograd
    differentiates."""
    if impl == "kernel":
        nll, lse = ops.softmax_xent(logits, labels, vocab_size)
    else:
        assert impl == "plain", impl
        nll, lse = softmax_xent_ref(logits, labels, vocab_size)
    zl = z_loss * lse.square()
    denom = float(labels.numel())
    loss = (nll + zl).sum() / denom
    return loss, {"nll": nll.sum() / denom, "z_loss": zl.sum() / denom}
