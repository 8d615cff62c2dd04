"""K2, flash attention: causal or non-causal, K/V shared by the G query heads
of each KV head.

Replaces the TPU kernel ``flash_attention_bhsd`` of
``src/repro/kernels/flash_attention.py``; the CUDA source is
``src/repro_torch/csrc/flash_attention.cu``, which states what bounds it on
the card and what its design does about that.  Unlike the TPU kernel, any S
is taken: ragged tails are masked inside the kernel.

``flash_attention_bhsd`` launches the kernel for CUDA tensors and runs the
plain version, ``flash_attention_ref``, for CPU tensors; it never falls back.
The kernel has no backward, so it raises on a CUDA input that requires a
gradient rather than return a tensor that cuts the graph.

Layouts: q (B*KV*G, S, D); k, v (B*KV, S, D); out like q.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version: dense fp32 softmax attention over repeated K/V."""
    bhg, sq, d = q.shape
    bkv, skv = k.shape[:2]
    g = bhg // bkv

    def rep(t):      # query row b reads K/V row b // g
        return t[:, None].expand(bkv, g, skv, d).reshape(bhg, skv, d).float()

    kr, vr = rep(k), rep(v)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr) / d ** 0.5
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vr).to(q.dtype)


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """Flash attention; see the module docstring for layouts."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: no kernel for {q.device}")
    _build.refuse_autograd("flash_attention_bhsd", q, k, v)
    bhg, s, d = q.shape
    bkv = k.shape[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bhsd: unsupported dtype {q.dtype}")
    if bhg % bkv:
        raise ValueError(f"flash_attention_bhsd: {bhg} query rows are not a "
                         f"multiple of {bkv} KV rows")
    for name, t in (("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != (bkv, s, d)):
            raise ValueError(f"flash_attention_bhsd: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{q.dtype} {(bkv, s, d)} on {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        rc = _build.entry("flash_attention_launch")(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), bhg, bkv, s, d, int(causal), stream)
    _build.check(rc, "flash_attention_bhsd")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
