"""Shared model pieces of the port: the device rule, parameter specs and their
initializers, RMSNorm and LayerNorm, RoPE, activations and the
cross-entropy loss (counterpart of the JAX ``repro.models.common``).

A parameter tree is nested dicts of tensors in the JAX layouts.  For serving,
matrix weights are stored in the compute dtype (``cfg.dtype``): the JAX
model keeps fp32 masters and casts them at every use, which gives the same
numbers as casting once at load.  For training they stay fp32
(``cfg.param_dtype``) and the model casts them at every use, as JAX does.
Norm scales stay fp32, because the norm multiplies in fp32; so do the
leaves JAX pins to fp32 (``pin_dtype``) and the matrices JAX multiplies in
fp32 (``P.fp32``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rmsnorm import rmsnorm_ref
from repro_torch.kernels.softmax_xent import softmax_xent_ref

#: Compute dtypes by config name; float64 runs the plain paths only (no
#: kernel takes it): a witness that removes fp32 rounding from a comparison.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


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
    """A parameter spec leaf: shape, initializer and its scale, and the
    logical name of each dim (``axes``, the JAX ``P``'s), which
    ``repro_torch.parallel.sharding`` maps onto a mesh.  ``fp32`` leaves
    keep fp32 whatever the compute dtype: norm scales, JAX's ``pin_dtype``
    leaves and matrices that JAX uses in fp32."""
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | uniform_conv | a_log |
    #                       dt_bias | rwkv_decay
    scale: float = 0.02
    fp32: bool = False
    axes: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"P{self.shape}: axes {self.axes} name "
                             f"{len(self.axes)} dims, not {len(self.shape)}")


def spec_leaves(spec, prefix: str = ""):
    """(path, P) of every leaf of a spec tree, in sorted-key order (the
    order of ``optimizer.tree_leaves``); paths join keys with ``/``."""
    if isinstance(spec, P):
        return [(prefix, spec)]
    return [leaf for k in sorted(spec)
            for leaf in spec_leaves(spec[k], f"{prefix}/{k}" if prefix
                                    else k)]


def spec_tree_map(fn, spec):
    if isinstance(spec, P):
        return fn(spec)
    return {k: spec_tree_map(fn, v) for k, v in spec.items()}


def logical_axes(spec):
    """The tree of each leaf's logical axes (the JAX ``logical_axes``)."""
    return spec_tree_map(lambda p: p.axes, spec)


def abstract_params(spec, dtype):
    """Tensors on the ``meta`` device with each leaf's shape and dtype
    (``dtype``, fp32 for ``fp32`` leaves): the PyTorch form of the JAX
    ``abstract_params``' ``ShapeDtypeStruct`` tree.  Nothing is
    allocated."""
    return spec_tree_map(
        lambda p: torch.empty(p.shape, device="meta",
                              dtype=torch.float32 if p.fp32 else dtype), spec)


def norm_spec(cfg, d: int = 0, axis: str = "norm"):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": P((d,), init="ones", fp32=True, axes=(axis,))}
    assert cfg.norm == "layernorm", cfg.norm
    return {"scale": P((d,), init="ones", fp32=True, axes=(axis,)),
            "bias": P((d,), init="zeros", fp32=True, axes=(axis,))}


def dense_spec(shape, axes, use_bias: bool, scale: float = 0.02):
    """A matrix ``{"kernel": (d_in, *out)}`` with logical ``axes`` and,
    with ``use_bias``, a ``"bias"`` over every output dim (``shape[1:]``,
    ``axes[1:]``), zeros at init (the JAX ``dense_spec``)."""
    spec = {"kernel": P(tuple(shape), scale=scale, axes=tuple(axes))}
    if use_bias:
        spec["bias"] = P(tuple(shape[1:]), init="zeros",
                         axes=tuple(axes[1:]))
    return spec


def add_bias(p, y):
    """``y`` plus ``p``'s bias, cast to y's dtype, where ``p`` has one: the
    bias is added after the matmul in the activations' dtype, as the JAX
    ``dense`` adds it."""
    return y + p["bias"].to(y.dtype) if "bias" in p else y


def stack_spec(spec, n: int, axis_name: Optional[str] = "layers"):
    """Add a leading stacked-layers dim, named ``axis_name``, to every
    leaf."""
    return spec_tree_map(
        lambda p: dataclasses.replace(p, shape=(n,) + p.shape,
                                      axes=(axis_name,) + p.axes), spec)


def depth_scale(cfg) -> float:
    return 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return u.mul_(hi - lo).add_(lo)


def _init_leaf(spec: P, generator, device, dtype):
    """One leaf, with the JAX ``_init_leaf``'s distribution (values differ:
    the generators differ).  ``uniform_conv`` takes its fan from every dim
    but the last of the leaf's shape, stacked layer dim included, as JAX
    does."""
    shape = spec.shape
    if spec.init == "zeros":
        w = torch.zeros(shape, device=device)
    elif spec.init == "ones":
        w = torch.ones(shape, device=device)
    elif spec.init == "normal":
        w = torch.randn(shape, generator=generator, device=device)
        w.mul_(spec.scale)
    elif spec.init == "uniform_conv":      # depthwise conv kernels
        bound = 1.0 / math.sqrt(max(math.prod(shape[:-1]), 1))
        w = _uniform(shape, -bound, bound, generator, device)
    elif spec.init == "a_log":             # mamba2: A ~ U[1, 16], store log A
        w = torch.log(_uniform(shape, 1.0, 16.0, generator, device))
    elif spec.init == "dt_bias":           # mamba2: inverse softplus of dt
        dt = torch.exp(_uniform(shape, math.log(1e-3), math.log(0.1),
                                generator, device))
        w = dt + torch.log(-torch.expm1(-dt))
    elif spec.init == "rwkv_decay":        # rwkv6: per-channel decay ramp
        n = shape[-1]
        ramp = (np.arange(n) / max(n - 1, 1)) ** 0.9
        w = torch.from_numpy((-6.0 + 5.0 * ramp).astype(np.float32)) \
            .to(device).expand(shape).clone()
    else:
        raise ValueError(spec.init)
    return w.to(torch.float32 if spec.fp32 else dtype)


def init_params(spec, generator: torch.Generator, device, dtype):
    """Materialize a spec tree: each leaf from its initializer, in
    ``dtype``, or fp32 for ``fp32`` leaves.  Shapes and scales match the
    JAX ``build_spec``; values differ, because the random generators
    differ."""
    if isinstance(spec, P):
        return _init_leaf(spec, generator, device, dtype)
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


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm over the last dim in fp32, cast back to x's dtype (the JAX
    ``common.layer_norm``).  No TPU kernel computes it: plain torch."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(p, x, cfg, impl: str = "kernel"):
    """The config's norm: LayerNorm where the spec has a bias, else RMSNorm
    through ``impl`` (K3 or its plain version)."""
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps, impl)


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
