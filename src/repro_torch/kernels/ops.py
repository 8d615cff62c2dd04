"""Model-layout wrappers around the port's kernels, and their launch counts.

Model code calls these; each reshapes to its kernel's layout and back.  On a
CPU tensor the kernel module runs its plain version, on a CUDA tensor it
launches the kernel (``repro_torch.kernels.{flash_attention,paged_decode,
rmsnorm,softmax_xent,adamw_update}``).  ``launch_counts()`` reads how often
each kernel was launched; a launch is counted only where a kernel actually
runs, never for a plain version.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.adamw_update import adamw_fused
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.paged_decode import (paged_flash_decode,
                                              paged_flash_decode_int8)
from repro_torch.kernels.rmsnorm import rmsnorm_rows
from repro_torch.kernels.softmax_xent import (SoftmaxXent, softmax_xent_bwd,
                                              softmax_xent_fwd)

KERNELS = {"paged_flash_decode": paged_flash_decode,
           "paged_flash_decode_int8": paged_flash_decode_int8,
           "flash_attention_bhsd": flash_attention_bhsd,
           "rmsnorm_rows": rmsnorm_rows,
           "softmax_xent_fwd": softmax_xent_fwd,
           "softmax_xent_bwd": softmax_xent_bwd,
           "adamw_fused": adamw_fused}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, KV, G, D); k, v: (B, S, KV, D).  Returns (B, S, KV, G, D)."""
    b, s, kv, g, d = q.shape
    q2 = q.permute(0, 2, 3, 1, 4).reshape(b * kv * g, s, d)
    k2 = k.permute(0, 2, 1, 3).reshape(b * kv, s, d)
    v2 = v.permute(0, 2, 1, 3).reshape(b * kv, s, d)
    o = flash_attention_bhsd(q2, k2, v2, causal=causal)
    return o.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)


def paged_decode_attention(q, k_pool, v_pool, page_table, positions,
                           k_scale=None, v_scale=None):
    """q: (B, 1, KV, G, D); pools (P, page, KV, D); page_table (B, M) int32;
    positions (B,) int32; with int8 pools, ``k_scale``/``v_scale``
    (P, page, KV) fp32.  Returns (B, 1, KV, G, D)."""
    assert q.shape[1] == 1, q.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: k_scale and v_scale go "
                         "together")
    q = q[:, 0].contiguous()
    if k_scale is None:
        o = paged_flash_decode(q, k_pool, v_pool, page_table, positions)
    else:
        o = paged_flash_decode_int8(q, k_pool, v_pool, k_scale, v_scale,
                                    page_table, positions)
    return o[:, None]


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., d) normalized over its last dim."""
    shape = x.shape
    return rmsnorm_rows(x.reshape(-1, shape[-1]), scale, eps=eps).reshape(shape)


def softmax_xent(logits, labels, vocab: int):
    """logits (..., Vp); labels (...,) < vocab.  Returns (nll, lse), each
    (...,) fp32, differentiable in logits through K4's backward."""
    lead = logits.shape[:-1]
    nll, lse = SoftmaxXent.apply(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1), vocab)
    return nll.reshape(lead), lse.reshape(lead)
