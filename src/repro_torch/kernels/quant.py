"""Per-row symmetric int8 quantization of KV rows: the int8 page format of
the paged cache (counterpart of ``quantize_kv`` / ``dequantize_kv`` in the
JAX ``repro.kernels.quant``).

Every (position, kv-head) row of head_dim elements gets its own fp32 scale,
``max(absmax, ABSMAX_FLOOR) / QMAX``, so a decode step quantizes its one new
row without touching the rest of its page.  The arithmetic is the JAX
package's, step for step: cast to fp32, a true division by the scale (not a
multiplication by its reciprocal), round half to even, clip to +/-QMAX.  On
the same fp32 inputs the results are bitwise equal.  These are torch ops:
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
