"""K3, RMSNorm over rows: ``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, cast
back to x's dtype.

Replaces the TPU kernel ``rmsnorm_rows`` of ``src/repro/kernels/
rmsnorm.py``.  It is a Triton kernel: one program per row loads the whole
row once (``BLOCK = next_pow2(d)``, masked), reduces the sum of squares in
registers and writes the scaled row, so x is read once and written once.
It is bound by memory: 2 bytes read and 2 written per bf16 element against
~4 flops.  The same kernel serves the d=2560 hidden rows (ln1, ln2, final
norm) and the D=128 head rows of qwen3's q/k norms.

``rmsnorm_rows`` launches the kernel for CUDA tensors and runs the plain
version, ``rmsnorm_ref``, for CPU tensors; it never falls back.  The kernel
has no backward, so it raises on a CUDA input that requires a gradient
rather than return a tensor that cuts the graph.  Triton is imported, and
the kernel compiled, only where it is launched.
"""
from __future__ import annotations

import functools
import os

import torch

from repro_torch.kernels import _build


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    """Plain version (the JAX ``common.rms_norm`` arithmetic)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    # Triton's compile cache goes under the checkout's build/ directory
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, d, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0)
        x = x.to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(var + eps) * s
        tl.store(o_ptr + row * d + cols, y.to(o_ptr.dtype.element_ty),
                 mask=mask)

    return triton, rmsnorm_kernel


def rmsnorm_rows(x, scale, *, eps: float = 1e-5):
    """x: (N, d); scale: (d,) fp32.  Returns (N, d) like x."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_rows: no kernel for {x.device}")
    _build.refuse_autograd("rmsnorm_rows", x, scale)
    n, d = x.shape
    if (scale.device != x.device or scale.dtype != torch.float32
            or tuple(scale.shape) != (d,)):
        raise ValueError(f"rmsnorm_rows: scale is {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}, expected "
                         f"float32 ({d},) on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rmsnorm_rows: unsupported dtype {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    triton, kernel = _kernel()
    block = triton.next_power_of_2(d)
    with _build.on_device(x.device):
        kernel[(n,)](x, scale, out, d, eps, BLOCK=block,
                     num_warps=8 if block >= 2048 else 4 if block >= 512
                     else 1)
    rmsnorm_rows.launches += 1
    return out


rmsnorm_rows.launches = 0
