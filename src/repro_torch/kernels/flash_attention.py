"""K2, flash attention: causal or non-causal, K/V shared by the G query heads
of each KV head.

Replaces the TPU kernel ``flash_attention_bhsd`` of
``src/repro/kernels/flash_attention.py``; the CUDA source is
``src/repro_torch/csrc/flash_attention.cu``, which states what bounds it on
the card and what its design does about that.  Two modes, by dtype: bf16 on
the tensor cores (``wgmma``; D in ``BF16_HEAD_DIMS``), fp32 on the CUDA
cores (any D whose tiles fit shared memory).  Unlike the TPU kernel, any S
is taken: ragged tails are masked inside the kernel.

Two entry points share one launch: ``flash_attention_bhsd`` on the public
layout q (B*KV*G, S, D), k, v (B*KV, S, D); and ``flash_attention_model``
on the model layout q (B, S, KV, G, D), k, v (B, S, KV, D), which the kernel
reads and writes through element strides, with no permute or copy.  Each
launches the kernel for CUDA tensors and runs the plain version,
``flash_attention_ref``, for CPU tensors; it never falls back.  On meta
tensors (the dry-run) it checks the operands as ``plan`` does and returns
a meta output, computing nothing.  Each launch and meta call reports its
work to an active ``roofline.kernels`` counter.  The kernel has no
backward, so it raises on a CUDA or meta input that requires a gradient
rather than return a tensor that cuts the graph.

``plan`` is the launch's host side as a pure function of the tensors'
shapes, strides, addresses and dtype (tested on CPU tensors): the mode,
tiles, grid, shared memory and strides the C entry receives.  Launch
counts: ``flash_attention_bhsd.launches`` for the bf16 mode and
``fp32_mode.launches`` for the fp32 mode, whichever entry launched.
"""
from __future__ import annotations

import ctypes
import dataclasses
import types
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import kernels as work

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BF16_HEAD_DIMS = (32, 64, 128)
SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
# bf16 mode: two warpgroups of 64 query rows a block; keys a K/V tile per
# D (csrc Tile<D>); a four-stage K/V ring.  fp32 mode: 32 x 32 tiles.
BF16_BLOCK_Q, BF16_STAGES = 128, 4
BF16_BLOCK_K = {32: 128, 64: 128, 128: 64}
FP32_BLOCK_Q, FP32_BLOCK_K = 32, 32
HEAD_CHUNK = 16               # heads whose tiles run longest first together

fp32_mode = types.SimpleNamespace(launches=0)


def smem_bytes(mode: str, d: int) -> int:
    """Dynamic shared memory a launch requests (csrc
    ``flash_attention_smem_bytes``)."""
    if mode == "bf16":
        bk = BF16_BLOCK_K[d]
        return (BF16_BLOCK_Q * d * 2 + BF16_STAGES * 2 * bk * d * 2
                + 16 * BF16_STAGES)      # Q, the K/V ring, its mbarriers
    return 4 * (FP32_BLOCK_Q * d + FP32_BLOCK_K * (d + 1) + FP32_BLOCK_K * d
                + FP32_BLOCK_Q * FP32_BLOCK_K + FP32_BLOCK_Q * d
                + 3 * FP32_BLOCK_Q)


@dataclasses.dataclass(slots=True)
class Plan:
    mode: str                  # "bf16" (tensor cores) or "fp32" (CUDA cores)
    b: int
    kv: int
    g: int
    s: int
    d: int
    causal: bool
    block_q: int
    smem: int
    # element strides: q and out (b, kv, g, s); k and v (b, kv, s)
    q_strides: Tuple[int, ...]
    k_strides: Tuple[int, ...]
    v_strides: Tuple[int, ...]
    o_strides: Tuple[int, ...]

    @property
    def n_q_tiles(self) -> int:
        return -(-self.s // self.block_q)

    @property
    def grid(self) -> int:
        return self.b * self.kv * self.g * self.n_q_tiles

    def tile(self, block: int) -> Tuple[int, int, int, int]:
        """(b, kv, g, first query row) of a block, as the kernel's
        ``block_tile``: heads in chunks of ``HEAD_CHUNK``, a chunk's tiles
        longest (the last rows) first across its heads."""
        n_qt = self.n_q_tiles
        c, r = divmod(block, HEAD_CHUNK * n_qt)
        heads = min(HEAD_CHUNK, self.b * self.kv * self.g - c * HEAD_CHUNK)
        qt = n_qt - 1 - r // heads
        h = c * HEAD_CHUNK + r % heads
        g = h % self.g
        kvh = (h // self.g) % self.kv
        return h // (self.g * self.kv), kvh, g, qt * self.block_q

    def strides(self) -> Tuple[int, ...]:
        return (*self.q_strides, *self.k_strides, *self.v_strides,
                *self.o_strides)


def plan(q, k, v, out, *, causal: bool = True) -> Plan:
    """The launch of the model layout q, out (B, S, KV, G, D) and k, v
    (B, S, KV, D), any strides with the last dim contiguous.  Raises
    ``ValueError`` for what the kernel does not take: a bf16 D outside
    ``BF16_HEAD_DIMS``, tiles beyond shared memory, a stride that is not a
    multiple of 16 bytes or a base that is not 16-byte aligned (it never
    copies to fix one)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if q.dim() != 5 or out.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and out "
                         f"{tuple(out.shape)} must be (B, S, KV, G, D)")
    b, s, kv, g, d = q.shape
    for name, t in (("k", k), ("v", v), ("out", out)):
        want = (b, s, kv, g, d) if name == "out" else (b, s, kv, d)
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != want):
            raise ValueError(f"flash_attention: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{q.dtype} {want} on {q.device}")
    mode = "bf16" if q.dtype == torch.bfloat16 else "fp32"
    if mode == "bf16" and d not in BF16_HEAD_DIMS:
        raise ValueError(f"flash_attention: bf16 head dim {d} is not one of "
                         f"the tensor-core kernel's {BF16_HEAD_DIMS}")
    smem = smem_bytes(mode, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention: head dim {d} needs {smem} B of "
                         f"shared memory, more than {SMEM_LIMIT}")
    size = q.element_size()

    def strides(t, dims):
        shape, stride = t.shape, t.stride()
        # a dim of size 1 is never stepped
        st = tuple(stride[i] if shape[i] > 1 else 0 for i in dims)
        if shape[-1] > 1 and stride[-1] != 1:
            raise ValueError("flash_attention: the head dim must be "
                             "contiguous")
        if any(x * size % 16 for x in st) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: strides {t.stride()} or base "
                             f"{t.data_ptr():#x} not 16-byte aligned "
                             f"({t.dtype}); the kernel loads 16-byte chunks")
        return st

    return Plan(mode=mode, b=b, kv=kv, g=g, s=s, d=d, causal=bool(causal),
                block_q=BF16_BLOCK_Q if mode == "bf16" else FP32_BLOCK_Q,
                smem=smem, q_strides=strides(q, (0, 2, 3, 1)),
                k_strides=strides(k, (0, 2, 1)),
                v_strides=strides(v, (0, 2, 1)),
                o_strides=strides(out, (0, 2, 3, 1)))


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version: dense fp32 softmax attention over repeated K/V.
    q (B*KV*G, S, D); k, v (B*KV, S, D)."""
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


def _launch(q, k, v, out, causal: bool) -> None:
    """Launch K2 on model-layout views (see ``plan``) into ``out``."""
    _build.refuse_autograd("flash_attention", q, k, v)
    p = plan(q, k, v, out, causal=causal)
    work.report("flash_attention_bhsd" if p.mode == "bf16"
                else "flash_attention_bhsd_fp32", work.flash_attention, q, k,
                causal)
    if q.device.type == "meta":
        return
    strides = (ctypes.c_longlong * 14)(*p.strides())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        rc = _build.entry("flash_attention_launch")(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), p.b, p.kv, p.g, p.s, p.d, int(causal), strides,
            stream)
    _build.check(rc, f"flash_attention ({p.mode} mode)")
    if p.mode == "bf16":
        flash_attention_bhsd.launches += 1
    else:
        fp32_mode.launches += 1


def _device(q):
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return q.device.type


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """Flash attention on q (B*KV*G, S, D), k, v (B*KV, S, D); returns
    (B*KV*G, S, D)."""
    if _device(q) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    bhg, bkv = q.shape[0], k.shape[0]
    if bhg % bkv:
        raise ValueError(f"flash_attention_bhsd: {bhg} query rows are not a "
                         f"multiple of {bkv} KV rows")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(*bhsd_views(q, k, v, out), causal)
    return out


def bhsd_views(q, k, v, out):
    """The public layout as model-layout views, no copy: q, out (B*KV*G, S,
    D) -> (B*KV, S, 1, G, D); k, v (B*KV, S, D) -> (B*KV, S, 1, D)."""
    bkv = k.shape[0]
    g = q.shape[0] // bkv

    def view(t, heads):     # (B*KV*heads, S, D) -> (B*KV, S, 1, heads, D)
        return t.unflatten(0, (bkv, heads)).transpose(1, 2).unsqueeze(2)

    return (view(q, g), view(k, 1)[:, :, :, 0], view(v, 1)[:, :, :, 0],
            view(out, g))


def flash_attention_model(q, k, v, *, causal: bool = True):
    """Flash attention on the model layout: q (B, S, KV, G, D), k, v
    (B, S, KV, D); returns (B, S, KV, G, D), contiguous on the card."""
    if _device(q) == "cpu":
        b, s, kv, g, d = q.shape
        o = flash_attention_ref(
            q.permute(0, 2, 3, 1, 4).reshape(b * kv * g, s, d),
            k.permute(0, 2, 1, 3).reshape(b * kv, s, d),
            v.permute(0, 2, 1, 3).reshape(b * kv, s, d), causal=causal)
        return o.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal)
    return out


flash_attention_bhsd.launches = 0
