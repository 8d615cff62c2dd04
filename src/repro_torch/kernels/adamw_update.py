"""K5, fused AdamW: one pass over (g, m, v, p) that scales the gradient,
updates both moments, applies the bias corrections and decoupled weight
decay and writes the parameter, with m, v and p updated in place.

Replaces the TPU kernel ``adamw_fused`` of ``src/repro/kernels/
adamw_update.py``.  It is a Triton kernel: one program per 4096-element
block of the flattened tensors.  It is bound by memory: it reads g (2 or 4
bytes) and m, v, p (4 bytes each) and writes m, v, p, 24-28 bytes per
element against ~15 flops, so fusing the chain into one pass is the whole
design; Triton's vector loads reach the HBM rate as a CUDA kernel would.
The clip scale is read from a device pointer, so the optimizer step needs
no host synchronisation; the learning rate, betas, eps, weight decay and
bias corrections are host floats, because the port keeps the step count on
the host.  The TPU kernel returns new (m, v, master); the port updates in
place, which saves three tensor-sized allocations per parameter.

``adamw_fused`` launches the kernel for CUDA tensors and runs the plain
version, ``adamw_ref``, for CPU tensors; it never falls back.  On meta
tensors (the dry-run) it updates nothing, as there is nothing to update in
place.  Each launch and meta call reports its work to an active
``roofline.kernels`` counter.  Triton is
imported, and the kernel compiled, only where it is launched.
"""
from __future__ import annotations

import functools
import os

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import kernels as work

BLOCK = 4096


def adamw_ref(g, m, v, p, scale, *, lr: float, beta1: float, beta2: float,
              eps: float, weight_decay: float, bias_corr1: float,
              bias_corr2: float):
    """Plain version, in place (the JAX ``train.optimizer.adamw_update``
    arithmetic for one leaf)."""
    g = g.float() * scale
    m.mul_(beta1).add_((1 - beta1) * g)
    v.mul_(beta2).add_((1 - beta2) * (g * g))
    step = (m / bias_corr1) / (torch.sqrt(v / bias_corr2) + eps)
    if weight_decay:
        step = step + weight_decay * p
    p.sub_(lr * step)


@functools.lru_cache(maxsize=None)
def _kernel():
    # Triton's compile cache goes under the checkout's build/ directory
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def adamw_kernel(g_ptr, m_ptr, v_ptr, p_ptr, scale_ptr, n, lr, beta1,
                     beta2, eps, wd, bc1, bc2, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        scale = tl.load(scale_ptr)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        g = g * scale
        m = tl.load(m_ptr + offs, mask=mask, other=0.0)
        v = tl.load(v_ptr + offs, mask=mask, other=0.0)
        p = tl.load(p_ptr + offs, mask=mask, other=0.0)
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * (g * g)
        # IEEE-rounded division and square root, as the plain version
        step = tl.div_rn(tl.div_rn(m, bc1),
                         tl.sqrt_rn(tl.div_rn(v, bc2)) + eps) + wd * p
        tl.store(m_ptr + offs, m, mask=mask)
        tl.store(v_ptr + offs, v, mask=mask)
        tl.store(p_ptr + offs, p - lr * step, mask=mask)

    return triton, adamw_kernel


def adamw_fused(g, m, v, p, scale, *, lr: float, beta1: float, beta2: float,
                eps: float, weight_decay: float, bias_corr1: float,
                bias_corr2: float):
    """One AdamW step of one tensor, in place.  g: any float dtype; m, v, p:
    contiguous fp32 of g's shape; scale: 0-d fp32 tensor (the clip scale),
    read on the device."""
    if p.device.type == "cpu":
        return adamw_ref(g, m, v, p, scale, lr=lr, beta1=beta1, beta2=beta2,
                         eps=eps, weight_decay=weight_decay,
                         bias_corr1=bias_corr1, bias_corr2=bias_corr2)
    if p.device.type not in ("cuda", "meta"):
        raise ValueError(f"adamw_fused: no kernel for {p.device}")
    if g.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"adamw_fused: unsupported gradient dtype {g.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v), ("p", p)):
        if t.device != p.device or t.shape != p.shape:
            raise ValueError(f"adamw_fused: {name} is {tuple(t.shape)} on "
                             f"{t.device}, expected {tuple(p.shape)} on "
                             f"{p.device}")
        if name != "g" and (t.dtype != torch.float32
                            or not t.is_contiguous()):
            raise ValueError(f"adamw_fused: {name} must be contiguous "
                             f"float32 (got {t.dtype})")
    if (scale.device != p.device or scale.dtype != torch.float32
            or scale.numel() != 1):
        raise ValueError("adamw_fused: scale must be one float32 on "
                         f"{p.device}")
    n = p.numel()
    if not n:
        return
    work.report("adamw_fused", work.adamw, n, g.element_size())
    if p.device.type == "meta":
        return
    g = g.contiguous()
    triton, kernel = _kernel()
    with _build.on_device(p.device):
        kernel[(triton.cdiv(n, BLOCK),)](
            g, m, v, p, scale, n, *(float(x) for x in (
                lr, beta1, beta2, eps, weight_decay, bias_corr1,
                bias_corr2)), BLOCK=BLOCK, num_warps=8)
    adamw_fused.launches += 1


adamw_fused.launches = 0
