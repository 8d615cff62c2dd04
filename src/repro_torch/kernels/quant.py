"""Symmetric int8 quantization (counterpart of the JAX
``repro.kernels.quant``), at two granularities:

* ``quantize_int8`` / ``dequantize`` — one scale per tensor, with an
  error-feedback input: the compressed gradient sync's wire format
  (``parallel.compression``);
* ``quantize_kv`` / ``dequantize_kv`` — one scale per row: the int8 page
  format of the paged cache.

In the KV form every (position, kv-head) row of head_dim elements gets its
own fp32 scale, ``max(absmax, ABSMAX_FLOOR) / QMAX``, so a decode step
quantizes its one new row without touching the rest of its page.  The
arithmetic is the JAX package's, step for step: cast to fp32, a true
division by the scale (not a multiplication by its reciprocal), round half
to even, clip to +/-QMAX.  On the same fp32 inputs the results are bitwise
equal.  These are torch ops:
the JAX functions are plain jnp, not a Pallas kernel.

``check_pool_write`` is the guard of every write into a pool: a float block
never reaches an int8 pool through a cast, which would truncate it.
"""
from __future__ import annotations

import torch

#: Quantized levels span [-QMAX, QMAX]; absmax maps to +/-QMAX.
QMAX = 127.0

#: Floor on the absmax, so an all-zero (or denormal) row gets a tiny
#: positive scale: its elements round to 0 and dequantize to exactly 0.
ABSMAX_FLOOR = 1e-12


def quantize_int8(x, seed_err=None):
    """Per-tensor symmetric int8 quantization with error feedback.  Returns
    (q int8, scale fp32 0-d, err fp32), ``err`` = x + seed_err −
    dequantize(q, scale), the residual to carry to the next call."""
    xf = x.float()
    if seed_err is not None:
        xf = xf + seed_err
    scale = torch.clamp(xf.abs().amax(), min=ABSMAX_FLOOR) / QMAX
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8)
    return q, scale, xf - q.float() * scale


def dequantize(q, scale):
    return q.float() * scale


def quantize_kv(x):
    """x (..., D) float -> (q int8 (..., D), scale fp32 (...,))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=ABSMAX_FLOOR) / QMAX
    q = torch.clamp(torch.round(xf / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of ``quantize_kv``: (..., D) int8 and (...,) fp32 -> (..., D)
    in ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def check_pool_write(pool, block, what: str) -> None:
    """Raise unless ``block`` may be written into ``pool`` as it is: an int8
    pool takes int8 rows only (quantized by ``quantize_kv``, their scales
    written beside them), and a float pool takes no int8 rows."""
    if (pool.dtype == torch.int8) != (block.dtype == torch.int8):
        raise TypeError(
            f"{what}: a {block.dtype} block cannot be written into a "
            f"{pool.dtype} pool; int8 pools take rows quantized with "
            "quantize_kv, never a cast")
