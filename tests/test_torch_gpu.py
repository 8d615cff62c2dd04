"""The port's hand-written kernels against their plain PyTorch versions on a
CUDA card (``-m gpu``), the forward-only kernels' refusal of autograd, and a
kernel-path train step against the plain path, the launch counts of a
chunked served run, Autopilot's two probes on the card, the serving
health loop around the CUDA-graph step, K1 carrying a poisoned page's NaN
to its victim only (``chip_smoke.py`` phase 5c's cases), and the poison
mask and fault plans through the graph step, and the host-RAM page tier's
two hazards (a freed page's offload must be a snapshot, a prefetch must
be fenced against the host's next write of its slab slot) and its round
trip through the graph step; K1 at arctic-480b's G=7 and K2 non-causal at
seamless-m4t's D=64 on the model layout against their plain versions, and
a MoE engine's graph replays against its eager steps, bitwise.  Without a
card every test
here skips; the file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

fp32 is held to 1e-4 (the kernels sum in another order) and bf16 to 2e-2
(outputs round to bf16)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.kernels import adamw_update as taw
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import rwkv6_wkv as twkv
from repro_torch.kernels import softmax_xent as tsx
from repro_torch.models import LM, ForwardOpts
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.optimizer import tree_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DT = {"float32": 0, "bfloat16": 1}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def _splits(q, k_pool, table, quant=False) -> int:
    """The split count K1's plan gives these operands on this card."""
    b, kv, g, d = q.shape
    return tpd.plan(b, kv, g, d, k_pool.shape[1], table.shape[1], q.dtype,
                    quant, False, tpd._n_sms(q.device.index or 0)).splits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,page,g", [(32, 4, 4), (128, 16, 4), (40, 4, 4),
                                      (256, 16, 4), (128, 16, 12),
                                      (128, 16, 1), (128, 16, 48)])
def test_paged_decode_kernel_matches_plain(dtype, d, page, g):
    """Boundary positions (0, page edges, a full table), a freed slot on
    scratch page 0, and NaN in every dead page.  bf16 at D=40 and D=256
    takes the CUDA-core path, G=12 two clusters of query rows; G=1
    (granite-13b's MHA, 7 of 8 tensor-core rows padding) and G=48
    (granite-20b-code's MQA, six 8-row query blocks) the biased configs'
    head layouts."""
    dev = _card()
    gen = torch.Generator().manual_seed(1)
    b, kv, m = 6, 2, 6
    n_pages = b * m + 1
    pos = torch.tensor([0, page - 1, page, page + 1, m * page - 1, 0],
                       dtype=torch.int32)
    table = (torch.randperm(n_pages - 1, generator=gen)[: b * m] + 1)
    table = table.reshape(b, m).to(torch.int32)
    table[5] = 0
    k = torch.randn(n_pages, page, kv, d, generator=gen)
    v = torch.randn(n_pages, page, kv, d, generator=gen)
    for s in range(b - 1):
        dead = table[s, pos[s] // page + 1:].long()
        k[dead] = float("nan")
        v[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen)
    td = DTYPES[dtype]
    q, k, v = (x.to(dev, td) for x in (q, k, v))
    table, pos = table.to(dev), pos.to(dev)
    before = tpd.paged_flash_decode.launches
    got = tpd.paged_flash_decode(q, k, v, table, pos)
    assert tpd.paged_flash_decode.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    assert _err(got, tpd.paged_decode_ref(q, k, v, table, pos)) <= TOL[dtype]
    assert _err(got, tpd.paged_decode_split_ref(
        q, k, v, table, pos, splits=_splits(q, k, table))) <= TOL[dtype]
    assert torch.equal(got, tpd.paged_flash_decode(q, k, v, table, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,page", [(32, 4), (128, 16)])
def test_paged_decode_int8_kernel_matches_plain(dtype, d, page):
    """K1's int8 mode: int8 pools made by quantize_kv, boundary positions,
    a freed slot on scratch page 0, and NaN scales on every dead page."""
    from repro_torch.kernels.quant import quantize_kv
    dev = _card()
    gen = torch.Generator().manual_seed(2)
    b, kv, g, m = 6, 2, 4, 6
    n_pages = b * m + 1
    pos = torch.tensor([0, page - 1, page, page + 1, m * page - 1, 0],
                       dtype=torch.int32)
    table = (torch.randperm(n_pages - 1, generator=gen)[: b * m] + 1)
    table = table.reshape(b, m).to(torch.int32)
    table[5] = 0
    k, ks = quantize_kv(torch.randn(n_pages, page, kv, d, generator=gen))
    v, vs = quantize_kv(torch.randn(n_pages, page, kv, d, generator=gen))
    for s in range(b - 1):
        dead = table[s, pos[s] // page + 1:].long()
        ks[dead] = float("nan")
        vs[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen).to(dev, DTYPES[dtype])
    k, v, ks, vs, table, pos = (x.to(dev) for x in (k, v, ks, vs, table, pos))
    before = tpd.paged_flash_decode_int8.launches
    got = tpd.paged_flash_decode_int8(q, k, v, ks, vs, table, pos)
    assert tpd.paged_flash_decode_int8.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    ref = tpd.paged_decode_ref(q, k, v, table, pos, ks, vs)
    assert _err(got, ref) <= TOL[dtype]
    assert _err(got, tpd.paged_decode_split_ref(
        q, k, v, table, pos, ks, vs, splits=_splits(q, k, table, True))) \
        <= TOL[dtype]
    assert torch.equal(got, tpd.paged_flash_decode_int8(q, k, v, ks, vs,
                                                        table, pos))
    with pytest.raises(ValueError, match="16-byte"):
        tpd.paged_flash_decode_int8(q[..., :d - 8],
                                    k[..., :d - 8].contiguous(),
                                    v[..., :d - 8].contiguous(), ks, vs,
                                    table, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_paged_decode_partials_kernels_match_plain(dtype, quant, n):
    """K1's partials mode, native and int8, on each of n shards of one pool
    (global table, ``page_offset`` = c * P/n): the triple against the plain
    partials (both fp32 arithmetic on the same inputs: 1e-4 relative), a
    slot with no live row in a shard exactly (0, 0, -1e30), NaN on every
    dead page never read, and the merged shards against the normalized
    K1 on the whole pool."""
    from repro_torch.kernels.quant import quantize_kv
    from repro_torch.models.attention import merge_partials_local
    dev = _card()
    gen = torch.Generator().manual_seed(3)
    b, kv, g, d, page, m = 6, 8, 4, 128, 16, 8
    n_pages = -(-(b * m + 1) // n) * n
    pn = n_pages // n
    pos = torch.tensor([3, page - 1, page, 2 * page + 1, m * page - 1, 0],
                       dtype=torch.int32)
    table = (torch.randperm(n_pages - 1, generator=gen)[: b * m] + 1)
    table = table.reshape(b, m).to(torch.int32)
    table[5] = 0                                  # freed slot
    k = torch.randn(n_pages, page, kv, d, generator=gen)
    v = torch.randn(n_pages, page, kv, d, generator=gen)
    for s in range(b - 1):
        dead = table[s, pos[s] // page + 1:].long()
        k[dead] = float("nan")
        v[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen).to(dev, DTYPES[dtype])
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        ks, vs = ks.to(dev), vs.to(dev)
    else:
        k, v = k.to(DTYPES[dtype]), v.to(DTYPES[dtype])
        ks = vs = None
    k, v, table, pos = (x.to(dev) for x in (k, v, table, pos))
    fn = (tpd.paged_flash_decode_partials_int8 if quant
          else tpd.paged_flash_decode_partials)
    triples = []
    for c in range(n):
        sl = slice(c * pn, (c + 1) * pn)
        shard = [k[sl], v[sl]] + ([ks[sl], vs[sl]] if quant else [])
        before = fn.launches
        got = fn(q, *shard, table, pos, c * pn)
        assert fn.launches == before + 1
        ref = tpd.paged_decode_ref(q, k[sl], v[sl], table, pos,
                                   *(shard[2:] or [None, None]),
                                   page_offset=c * pn, partials=True)
        split = tpd.paged_decode_split_ref(
            q, k[sl], v[sl], table, pos, *(shard[2:] or [None, None]),
            page_offset=c * pn, partials=True,
            splits=_splits(q, k, table, quant))
        for a, r, sp in zip(got, ref, split):
            assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
            assert _err(a, r) <= 1e-4 * max(1.0, float(r.abs().max()))
            assert _err(a, sp) <= 1e-4 * max(1.0, float(sp.abs().max()))
        again = fn(q, *shard, table, pos, c * pn)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        empty = ref[2] == -1e30
        assert bool((got[2][empty] == -1e30).all())
        assert bool((got[1][empty] == 0).all())
        assert bool((got[0][empty.unsqueeze(-1).expand_as(got[0])] == 0)
                    .all())
        triples.append((got[0][:, None], got[1], got[2]))
    assert int((torch.stack([t[2] for t in triples]) == -1e30).sum()) > 0
    merged = merge_partials_local(triples)[:, 0].to(q.dtype)
    whole = (tpd.paged_flash_decode_int8(q, k, v, ks, vs, table, pos) if quant
             else tpd.paged_flash_decode(q, k, v, table, pos))
    assert _err(merged, whole) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("positions", [
    (4095,) * 8, (4095, 15, 16, 17, 130, 255, 511, 0)])
def test_paged_decode_long_context_matches_plain(dtype, quant, positions):
    """K1 at a 4,096-position context (B=8, KV=8, G=4, D=128, page 16,
    M=256; every slot full, or ragged with a freed slot on scratch page 0
    and NaN on every dead page), normalized and as partials of two shards:
    against the plain version and the plain version of its split schedule,
    one launch a call, two calls bitwise equal."""
    from repro_torch.kernels.quant import quantize_kv
    dev = _card()
    gen = torch.Generator().manual_seed(4)
    b, kv, g, d, page, m = 8, 8, 4, 128, 16, 256
    n_pages = b * m + 2                  # two shards of b * m / 2 + 1 pages
    pos = torch.tensor(positions, dtype=torch.int32)
    table = (torch.randperm(n_pages - 1, generator=gen)[: b * m] + 1)
    table = table.reshape(b, m).to(torch.int32)
    if positions[-1] == 0:
        table[-1] = 0                                 # freed slot
    k = torch.randn(n_pages, page, kv, d, generator=gen)
    v = torch.randn(n_pages, page, kv, d, generator=gen)
    for s in range(b - 1):
        dead = table[s, pos[s] // page + 1:].long()
        k[dead] = float("nan")
        v[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen).to(dev, DTYPES[dtype])
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = [ks.to(dev), vs.to(dev)]
    else:
        k, v, scales = k.to(DTYPES[dtype]), v.to(DTYPES[dtype]), []
    k, v, table, pos = (x.to(dev) for x in (k, v, table, pos))
    splits = _splits(q, k, table, quant)
    fn = tpd.paged_flash_decode_int8 if quant else tpd.paged_flash_decode
    before = fn.launches
    got = fn(q, k, v, *scales, table, pos)
    assert fn.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    ref = tpd.paged_decode_ref(q, k, v, table, pos, *(scales or [None] * 2))
    split = tpd.paged_decode_split_ref(q, k, v, table, pos,
                                       *(scales or [None] * 2), splits=splits)
    assert _err(got, ref) <= TOL[dtype] and _err(got, split) <= TOL[dtype]
    assert torch.equal(got, fn(q, k, v, *scales, table, pos))
    part = (tpd.paged_flash_decode_partials_int8 if quant
            else tpd.paged_flash_decode_partials)
    pn = n_pages // 2
    for c in range(2):
        shard = [t[c * pn:(c + 1) * pn] for t in [k, v, *scales]]
        before = part.launches
        got = part(q, *shard, table, pos, c * pn)
        assert part.launches == before + 1
        args = (q, shard[0], shard[1], table, pos,
                *(shard[2:] or [None, None]), c * pn, True)
        for want in (tpd.paged_decode_ref(*args),
                     tpd.paged_decode_split_ref(*args, splits=splits)):
            for a, r in zip(got, want):
                assert _err(a, r) <= 1e-4 * max(1.0, float(r.abs().max()))
        again = part(q, *shard, table, pos, c * pn)
        assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plan_matches_kernel(dtype, quant):
    """K1's plan: its shared memory equals the kernel's own figure (C entry
    ``paged_decode_smem_bytes``) over G, D and M; at the serve and long
    shapes the split count puts about 2 blocks on every SM in one wave."""
    from repro_torch.kernels import _build
    _card()
    entry = _build.entry("paged_decode_smem_bytes")
    td = DTYPES[dtype]
    n_sms = tpd._n_sms(0)
    for g in (1, 2, 3, 4, 8, 12):
        for d in ((16, 32, 64, 128, 256) if quant else (8, 32, 64, 96, 128,
                                                        256)):
            if d * (1 if quant else td.itemsize) % 16:
                continue
            for m in (1, 32, 256):
                pl = tpd.plan(8, 8, g, d, 16, m, td, quant, False, n_sms)
                assert pl.smem == entry(_DT[dtype], int(quant), g, d, m), \
                    (g, d, m)
    for m in (32, 256):
        pl = tpd.plan(8, 8, 4, 128, 16, m, td, quant, False, n_sms)
        assert pl.splits * 64 >= (2 if m == 256 else 1.9) * n_sms
        assert pl.cluster <= 8 and pl.splits * 64 <= pl.blocks_per_sm * n_sms


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 200, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(dtype, s, causal):
    dev = _card()
    td = DTYPES[dtype]
    q = torch.randn(16, s, 128, device=dev).to(td)
    k = torch.randn(4, s, 128, device=dev).to(td)
    v = torch.randn(4, s, 128, device=dev).to(td)
    got = tfa.flash_attention_bhsd(q, k, v, causal=causal)
    assert _err(got, tfa.flash_attention_ref(q, k, v, causal=causal)) \
        <= TOL[dtype]


def _k2_launches():
    return tfa.flash_attention_bhsd.launches, tfa.fp32_mode.launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 4, 48])
@pytest.mark.parametrize("s,causal", [(16, True), (200, True), (256, False),
                                      (2048, True)])
def test_flash_attention_kernel_head_dims_and_groups(dtype, d, g, s, causal):
    """Each bf16 instantiation (D = 32, 64, 128) and the fp32 mode, with
    and without GQA (G = 48: granite-20b-code's MQA), ragged and long S;
    each launch counts in its mode."""
    dev = _card()
    td, kv = DTYPES[dtype], 2
    q = torch.randn(2 * kv * g, s, d, device=dev).to(td)
    k = torch.randn(2 * kv, s, d, device=dev).to(td)
    v = torch.randn(2 * kv, s, d, device=dev).to(td)
    bf16, fp32 = _k2_launches()
    got = tfa.flash_attention_bhsd(q, k, v, causal=causal)
    assert _k2_launches() == ((bf16 + 1, fp32) if dtype == "bfloat16"
                              else (bf16, fp32 + 1))
    assert bool(torch.isfinite(got.float()).all())
    assert _err(got, tfa.flash_attention_ref(q, k, v, causal=causal)) \
        <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,g", [(64, 1), (128, 4)])
def test_flash_attention_model_layout_strided(dtype, d, g):
    """ops.flash_attention on q, k, v sliced out of one fused projection
    (strided views of the model layout): one launch, no copy, and a
    contiguous (B, S, KV, G, D) output equal to the plain version's."""
    from repro_torch.kernels import ops
    dev = _card()
    b, s, kv = 2, 200, 2
    qkv = torch.randn(b, s, (kv * g + 2 * kv) * d, device=dev).to(
        DTYPES[dtype])
    q = qkv[..., :kv * g * d].unflatten(-1, (kv, g, d))
    k = qkv[..., kv * g * d:(kv * g + kv) * d].unflatten(-1, (kv, d))
    v = qkv[..., (kv * g + kv) * d:].unflatten(-1, (kv, d))
    before = sum(_k2_launches())
    got = ops.flash_attention(q, k, v, causal=True)
    assert sum(_k2_launches()) == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    ref = tfa.flash_attention_ref(
        q.permute(0, 2, 3, 1, 4).reshape(b * kv * g, s, d),
        k.permute(0, 2, 1, 3).reshape(b * kv, s, d),
        v.permute(0, 2, 1, 3).reshape(b * kv, s, d))
    assert _err(got, ref.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)) \
        <= TOL[dtype]


@pytest.mark.gpu
def test_flash_attention_refuses_bf16_head_dim_80():
    """The tensor-core mode is instantiated for D = 32, 64, 128: D = 80 in
    bf16 raises and launches nothing (fp32 takes any D that fits)."""
    dev = _card()
    q = torch.randn(8, 64, 80, device=dev)
    k = torch.randn(2, 64, 80, device=dev)
    before = _k2_launches()
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        tfa.flash_attention_bhsd(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert _k2_launches() == before
    got = tfa.flash_attention_bhsd(q, k, k)
    assert _err(got, tfa.flash_attention_ref(q, k, k)) <= TOL["float32"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(8, 2560), (256, 128)])
def test_rmsnorm_kernel_matches_plain(dtype, n, d):
    dev = _card()
    x = (2 * torch.randn(n, d, device=dev)).to(DTYPES[dtype])
    sc = 1 + 0.2 * torch.randn(d, device=dev)
    assert _err(trn.rmsnorm_rows(x, sc), trn.rmsnorm_ref(x, sc)) <= TOL[dtype]


def _elem_rel(a, b) -> float:
    """max |a - b| / |b| over the elements; where b is 0, a must be 0."""
    a, b = a.detach().float(), b.detach().float()
    diff = (a - b).abs()
    return float(torch.where(b == 0, torch.where(diff == 0, 0.0,
                                                 float("inf")),
                             diff / b.abs()).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,vp,vocab", [(64, 151936, 151936),
                                        (16, 384, 300)])
def test_softmax_xent_kernels_match_plain(dtype, n, vp, vocab):
    """Forward and backward, with a padded vocab.  The backward's elements
    span ten orders of magnitude, so each is held to its own size: 1e-5
    (fp32) or 1e-2 (bf16, one unit of rounding) relative."""
    dev = _card()
    x = (4 * torch.randn(n, vp, device=dev)).to(DTYPES[dtype])
    y = torch.randint(0, vocab, (n,), device=dev, dtype=torch.int32)
    g_nll, g_lse = torch.rand(n, device=dev), torch.rand(n, device=dev)
    before = (tsx.softmax_xent_fwd.launches, tsx.softmax_xent_bwd.launches)
    nll, lse = tsx.softmax_xent_fwd(x, y, vocab)
    d = tsx.softmax_xent_bwd(x, y, lse, g_nll, g_lse, vocab)
    assert (tsx.softmax_xent_fwd.launches, tsx.softmax_xent_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    rnll, rlse = tsx.softmax_xent_ref(x, y, vocab)
    assert _err(nll, rnll) <= 1e-4 and _err(lse, rlse) <= 1e-4
    rd = tsx.softmax_xent_bwd_ref(x, y, lse, g_nll, g_lse, vocab)
    assert d.dtype == x.dtype
    assert _elem_rel(d, rd) <= {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert float(d[:, vocab:].float().abs().sum()) == 0.0


@pytest.mark.gpu
def test_softmax_xent_kernels_refuse_unaligned_rows():
    """The kernels move 16-byte packs: rows of 1001 bf16 values do not start
    on 16-byte boundaries, so the wrappers raise and launch nothing."""
    dev = _card()
    x = torch.zeros(9, 1001, device=dev, dtype=torch.bfloat16)
    y = torch.zeros(9, device=dev, dtype=torch.int32)
    g = torch.zeros(9, device=dev)
    before = (tsx.softmax_xent_fwd.launches, tsx.softmax_xent_bwd.launches)
    with pytest.raises(ValueError, match="16-byte"):
        tsx.softmax_xent_fwd(x, y, 999)
    with pytest.raises(ValueError, match="16-byte"):
        tsx.softmax_xent_bwd(x, y, g, g, g, 999)
    assert (tsx.softmax_xent_fwd.launches,
            tsx.softmax_xent_bwd.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4096, 3 * 4096 + 7])
def test_adamw_kernel_matches_plain(gdtype, n):
    dev = _card()
    g = torch.randn(n, device=dev).to(DTYPES[gdtype])
    m, v = 0.1 * torch.randn(n, device=dev), 0.1 * torch.rand(n, device=dev)
    p = 0.02 * torch.randn(n, device=dev)
    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                 bias_corr1=1 - 0.9 ** 3, bias_corr2=1 - 0.95 ** 3)
    scale = torch.tensor(0.5, device=dev)
    km, kv, kp = m.clone(), v.clone(), p.clone()
    taw.adamw_fused(g, km, kv, kp, scale, **hyper)
    taw.adamw_ref(g, m, v, p, scale, **hyper)
    for a, b in ((km, m), (kv, v), (kp, p)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_forward_only_kernels_refuse_autograd():
    """K1-K3 have no backward: given a CUDA input that requires a gradient
    they raise instead of returning a tensor that cuts the graph; under
    no_grad they run."""
    dev = _card()
    x = torch.randn(8, 2560, device=dev)
    sc = torch.ones(2560, device=dev, requires_grad=True)
    q = torch.randn(8, 64, 128, device=dev, requires_grad=True)
    k = torch.randn(2, 64, 128, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        trn.rmsnorm_rows(x, sc)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention_bhsd(q, k, k)
    pool = torch.randn(3, 16, 2, 128, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tpd.paged_flash_decode(torch.randn(1, 2, 4, 128, device=dev), pool,
                               pool, torch.ones(1, 2, dtype=torch.int32,
                                                device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev))
    pool8 = torch.zeros(3, 16, 2, 128, device=dev, dtype=torch.int8)
    scale = torch.ones(3, 16, 2, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tpd.paged_flash_decode_int8(
            torch.randn(1, 2, 4, 128, device=dev), pool8, pool8, scale, scale,
            torch.ones(1, 2, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    with torch.no_grad():
        trn.rmsnorm_rows(x, sc)
        tfa.flash_attention_bhsd(q, k, k)


@pytest.mark.gpu
def test_kernel_path_train_step_matches_plain_path():
    """Reduced qwen3-4b in fp32: the loss gradients through K4 equal the
    plain path's element by element, and two train steps through K4 and K5
    end where two plain steps do, each tensor to a relative max error of
    1e-3 (as chip_smoke's training parity): Adam divides each element by
    its own gradient scale, so an element whose gradient cancels to near
    zero turns fp32 rounding into a visible difference."""
    dev = _card()
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              dtype="float32")
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=1, total_steps=10)
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    states, grads = {}, {}
    for impl in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           xent_impl=impl)
        state = init_train_state(lm, 0, tcfg, device=dev)
        leaves = tree_leaves(state["params"])
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm.loss(state["params"], batch, opts)
        grads[impl] = torch.autograd.grad(loss, leaves)
        step = make_train_step(lm, tcfg, opts, adamw_impl=impl)
        for _ in range(2):
            state, _ = step(state, batch)
        states[impl] = state
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    for tree in ("params", "opt"):
        for a, b in zip(tree_leaves(states["kernel"][tree]),
                        tree_leaves(states["plain"][tree])):
            assert _err(a, b) <= 1e-3 * float(b.detach().abs().max())


@pytest.mark.gpu
def test_kernel_path_bf16_grads_match_plain_path():
    """Reduced qwen3-4b at the train path's precision (fp32 parameters, bf16
    compute): the loss through K4 equals the plain loss, and every gradient
    leaf agrees to a relative max error of 2e-2 (the two paths' bf16
    dlogits may differ by one unit of rounding in some elements)."""
    dev = _card()
    cfg = get_config("qwen3-4b").reduced()
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    lm = LM(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    params = lm.init(0, device=dev, dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for impl in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           xent_impl=impl)
        loss, _ = lm.loss(params, batch, opts)
        out[impl] = (loss, torch.autograd.grad(loss, leaves))
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gk, gp):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert _err(a, b) <= 2e-2 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 1, 16, 8, 16), (2, 128, 3, 32, 16, 32), (1, 256, 2, 64, 64, 64),
    (2, 200, 4, 64, 64, 256), (1, 1, 2, 64, 64, 256)])
def test_ssd_scan_kernel_matches_plain(b, s, h, p, n, chunk, dtype):
    """``tests/test_kernels.py``'s sweep shapes, a ragged S (200: three
    full 64-step tiles and a tail) and a single step.  Inputs are shaped as
    the Mamba2 block makes them (x = X * dt, da = -dt * A with dt in
    [1e-3, 0.1] and A in [1, 16]), which keeps |y| below 4: there one bf16
    unit is at most 1.6e-2, so the two versions' rounding of one fp32 value
    stays within the bf16 tolerance."""
    dev = _card()
    td = DTYPES[dtype]
    dt = torch.empty(b * h, s, device=dev).uniform_(-6.9, -2.3).exp()
    a = torch.empty(b * h, 1, device=dev).uniform_(1.0, 16.0)
    x = (torch.randn(b * h, s, p, device=dev) * dt[..., None]).to(td)
    da = -dt * a
    bm, cm = (0.5 * torch.randn(b, s, n, device=dev).to(td)
              for _ in range(2))
    before = tssd.ssd_scan_bhsd.launches
    got = tssd.ssd_scan_bhsd(x, da, bm, cm, chunk=chunk)
    assert tssd.ssd_scan_bhsd.launches == before + 1
    assert got.dtype == td and bool(torch.isfinite(got.float()).all())
    ref = tssd.ssd_scan_ref(x, da, bm, cm, chunk=chunk)
    assert float(ref.float().abs().max()) < 4
    assert _err(got, ref) <= TOL[dtype]


def _ssd_model_inputs(b, s, h, p, n, td, dev):
    """The model layout x (B, S, H, P), da (B, S, H), b, c (B, S, N), shaped
    as the Mamba2 block makes them (see the sweep above)."""
    dt = torch.empty(b, s, h, device=dev).uniform_(-6.9, -2.3).exp()
    a = torch.empty(h, device=dev).uniform_(1.0, 16.0)
    x = (torch.randn(b, s, h, p, device=dev) * dt[..., None]).to(td)
    bm, cm = (0.5 * torch.randn(b, s, n, device=dev).to(td)
              for _ in range(2))
    return x, -dt * a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2048, 2000])
def test_ssd_scan_model_layout_matches_plain(s, dtype):
    """``ops.mamba2_ssd`` on the model layout at zamba2-1.2b's shape (B=4,
    H=64, P=N=64) and at a ragged S: one K6 launch, y (B, S, H, P)
    contiguous, against the plain version on the permuted views."""
    from repro_torch.kernels import ops
    dev = _card()
    td = DTYPES[dtype]
    b, h, p, n = 4, 64, 64, 64
    x, da, bm, cm = _ssd_model_inputs(b, s, h, p, n, td, dev)
    before = tssd.ssd_scan_bhsd.launches
    with torch.no_grad():
        got = ops.mamba2_ssd(x, da, bm, cm, chunk=256)
    assert tssd.ssd_scan_bhsd.launches == before + 1
    assert got.shape == (b, s, h, p) and got.is_contiguous()
    assert got.dtype == td and bool(torch.isfinite(got.float()).all())
    ref = tssd.ssd_scan_ref(x.permute(0, 2, 1, 3).reshape(b * h, s, p),
                            da.permute(0, 2, 1).reshape(b * h, s), bm, cm,
                            chunk=256).reshape(b, h, s, p).permute(0, 2, 1, 3)
    assert float(ref.float().abs().max()) < 4
    assert _err(got, ref) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [2048, 2000])
def test_ssd_scan_bf16_rounds_where_its_note_says(s):
    """At zamba2-1.2b's shape the bf16 mode's y equals ``ssd_scan_mma_emu``
    (the rounding points its source names, emulated in fp32) rounded to
    bf16 in at least 99.9% of the elements, and that emulation is within
    the 1e-2 of the all-fp32 plain version the source states: the kernel
    rounds there and nowhere else.  Where the two differ, the kernel's fp32
    arithmetic, in another order, has flipped one of those roundings; an
    emulation with one rounding point more (C o e^cs) or one fewer (G, S or
    X o w) matches in at most 92% of the elements at this shape
    (``tools/k6_rounding.py``)."""
    dev = _card()
    b, h, p, n = 4, 64, 64, 64
    x, da, bm, cm = _ssd_model_inputs(b, s, h, p, n, torch.bfloat16, dev)
    with torch.no_grad():
        got = tssd.ssd_scan_model(x, da, bm, cm)
    xb = x.permute(0, 2, 1, 3).reshape(b * h, s, p)
    dab = da.permute(0, 2, 1).reshape(b * h, s)
    emu = tssd.ssd_scan_mma_emu(xb, dab, bm, cm)
    got = got.permute(0, 2, 1, 3).reshape(b * h, s, p)
    same = float((got == emu.to(torch.bfloat16)).float().mean())
    assert same >= 0.999, same
    ref = tssd.ssd_scan_ref(xb.float(), dab, bm.float(), cm.float(),
                            chunk=256)
    assert _err(emu, ref) <= 1e-2


@pytest.mark.gpu
def test_ssd_scan_fp32_takes_unaligned_layouts():
    """The fp32 mode reads scalars: P and N that are not multiples of 4, a
    step stride of 52 bytes and a base off a 16-byte boundary launch as
    they are and match the plain version."""
    from repro_torch.kernels import ops
    dev = _card()
    b, s, h, p, n = 2, 200, 3, 13, 6
    x, da, bm, cm = _ssd_model_inputs(b, s, h, p, n, torch.float32, dev)
    wide = torch.zeros(b, s, h, p + 1, device=dev)
    wide[..., :p] = x
    flat = torch.zeros(b * s * n + 1, device=dev)
    flat[1:] = bm.flatten()
    shifted = flat[1:].view(b, s, n)
    before = tssd.ssd_scan_bhsd.launches
    with torch.no_grad():
        got = ops.mamba2_ssd(wide[..., :p], da, shifted, cm, chunk=64)
    assert tssd.ssd_scan_bhsd.launches == before + 1
    ref = tssd.ssd_scan_ref(x.permute(0, 2, 1, 3).reshape(b * h, s, p),
                            da.permute(0, 2, 1).reshape(b * h, s), bm, cm,
                            chunk=64).reshape(b, h, s, p).permute(0, 2, 1, 3)
    assert _err(got, ref) <= TOL["float32"]


_PROFILED_CALL = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
import test_torch_gpu as t
from repro_torch.kernels import ops
dev = t._card()
{setup}
call()                       # build and warm up
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    call()
    torch.cuda.synchronize()
print(json.dumps(sorted({{ev.key for ev in prof.key_averages()
                         if ev.device_type == torch.autograd.DeviceType.CUDA
                         and ev.self_device_time_total > 0}})))
"""


def _profiled_kernels(setup: str) -> set:
    """The device kernels of one profiled ``call()`` (defined by ``setup``,
    with this module as ``t``), each with device time, profiled in a fresh
    Python process: in a process that has run many card tests before, the
    profiler has recorded no device event at all (an empty set)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root / "tests")]))
    res = subprocess.run(
        [sys.executable, "-c", _PROFILED_CALL.format(setup=setup)],
        capture_output=True, text=True, cwd=root, env=env, timeout=900)
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


@pytest.mark.gpu
def test_ssd_scan_model_layout_launches_only_k6():
    """One profiled ``ops.mamba2_ssd`` on the model layout runs K6's device
    kernel and nothing else: no permute, copy or contiguous kernel."""
    _card()
    names = _profiled_kernels(
        "x, da, bm, cm = t._ssd_model_inputs(4, 2048, 64, 64, 64, "
        "torch.bfloat16, dev)\n"
        "def call():\n"
        "    ops.mamba2_ssd(x, da, bm, cm)")
    assert names and all("ssd_scan_mma_kernel" in k for k in names), names


@pytest.mark.gpu
def test_ssd_plan_matches_the_kernel():
    """The plan's shared memory is the C entry's for both modes, and the
    two blocks an SM its note claims for the bf16 mode are what the
    occupancy API grants after a launch."""
    from repro_torch.kernels import _build
    dev = _card()
    smem = _build.entry("mamba2_ssd_smem_bytes")
    for dtype, mode in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for p, n in ((16, 8), (64, 64), (32, 16)):
            x, da, bm, cm = _ssd_model_inputs(1, 64, 2, p, n, dtype, dev)
            pl = tssd.plan(x, da, bm, cm, torch.empty_like(x))
            assert pl.smem == smem(tssd._DTYPES[dtype], p, n)
            tssd.ssd_scan_model(x, da, bm, cm)
    torch.cuda.synchronize()
    assert _build.entry("mamba2_ssd_blocks_per_sm")() == \
        tssd.blocks_per_sm("bf16", 64, 64) == 2


@pytest.mark.gpu
def test_ssd_scan_refuses_what_it_does_not_take():
    """The bf16 mode pads P and N to 64: beyond that, another dtype, or a
    layout whose rows are not 16-byte aligned, K6 raises; it never routes
    to the plain version or to the fp32 mode, and counts no launch."""
    from repro_torch.kernels import ops
    dev = _card()
    before = tssd.ssd_scan_bhsd.launches
    for p, n in ((72, 64), (64, 72), (128, 128)):
        x, da, bm, cm = _ssd_model_inputs(1, 64, 2, p, n, torch.bfloat16,
                                          dev)
        with pytest.raises(ValueError, match="takes P and N in"):
            ops.mamba2_ssd(x, da, bm, cm)
    x, da, bm, cm = _ssd_model_inputs(1, 64, 2, 64, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError, match="dtype"):
        ops.mamba2_ssd(x.half(), da, bm.half(), cm.half())
    wide = torch.zeros(1, 64, 2, 68, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ops.mamba2_ssd(wide[..., :64], da, bm, cm)
    with pytest.raises(ValueError, match="16-byte"):
        ops.mamba2_ssd(x[..., :12], da, bm, cm)
    assert tssd.ssd_scan_bhsd.launches == before


def _wkv_model_inputs(b, s, h, kd, vd, td, dev):
    """The model layout r, k, lw (B, S, H, K), v (B, S, H, V), u (H, K):
    r, k, v ~ N(0, 0.15^2) keep |y| below 4, where one bf16 unit is at most
    1.6e-2 (see the K6 test); log decays span the model's range down to the
    -2.5 floor."""
    r, kk = (0.15 * torch.randn(b, s, h, kd, device=dev).to(td)
             for _ in range(2))
    vv = (0.15 * torch.randn(b, s, h, vd, device=dev)).to(td)
    lw = (-torch.empty(b, s, h, kd, device=dev).uniform_(-6, 1.5).exp()) \
        .clamp(min=-2.5)
    u = 0.3 * torch.randn(h, kd, device=dev)
    return r, kk, vv, lw, u


def _fold(t):
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,v,chunk", [
    (1, 64, 1, 16, 16, 16), (2, 128, 3, 32, 32, 32), (1, 96, 2, 64, 64, 32),
    (2, 100, 4, 64, 64, 32), (1, 1, 2, 64, 64, 32), (2, 300, 2, 128, 128, 32),
    (2, 100, 3, 64, 48, 32), (1, 130, 2, 128, 40, 16)])
def test_wkv6_kernel_matches_plain(b, s, h, k, v, chunk, dtype):
    """``tests/test_kernels.py``'s sweep shapes, a ragged S (100: three
    full 32-step chunks and a tail), a single step, K = V = 128, and V
    split unevenly over the blocks of a row (48 = 32 + 16, 40 = 32 + 8),
    on the public layout: one launch a call, two calls bitwise equal."""
    dev = _card()
    td = DTYPES[dtype]
    r, kk, vv, lw, u = (_fold(t) if t.dim() == 4 else t
                        for t in _wkv_model_inputs(b, s, h, k, v, td, dev))
    before = twkv.wkv6_scan_bhsd.launches
    got = twkv.wkv6_scan_bhsd(r, kk, vv, lw, u, chunk=chunk)
    assert twkv.wkv6_scan_bhsd.launches == before + 1
    assert got.dtype == td and bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, twkv.wkv6_scan_bhsd(r, kk, vv, lw, u,
                                                chunk=chunk))
    ref = twkv.wkv6_scan_ref(r, kk, vv, lw, u, chunk=chunk)
    assert float(ref.float().abs().max()) < 4
    assert _err(got, ref) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2048, 2000])
def test_wkv6_model_layout_equals_public_layout(s, dtype):
    """``ops.rwkv6_wkv`` on the model layout at rwkv6-1.6b's shape (B=4,
    H=32, K=V=64): one K7 launch, y (B, S, H, V) contiguous and bitwise
    equal to the public entry's output on the folded inputs, and to itself
    on a second call; both within the tolerance of the plain version."""
    from repro_torch.kernels import ops
    dev = _card()
    td = DTYPES[dtype]
    b, h, kd = 4, 32, 64
    args = _wkv_model_inputs(b, s, h, kd, kd, td, dev)
    before = twkv.wkv6_scan_bhsd.launches
    with torch.no_grad():
        got = ops.rwkv6_wkv(*args, chunk=32)
    assert twkv.wkv6_scan_bhsd.launches == before + 1
    assert got.shape == (b, s, h, kd) and got.is_contiguous()
    assert torch.equal(got, ops.rwkv6_wkv(*args, chunk=32))
    public = twkv.wkv6_scan_bhsd(*(_fold(t) for t in args[:4]), args[4])
    assert torch.equal(_fold(got), public)
    ref = twkv.wkv6_scan_ref(*(_fold(t) for t in args[:4]), args[4])
    assert _err(public, ref) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [2048, 2000])
def test_wkv6_bf16_rounds_where_its_note_says(s):
    """At rwkv6-1.6b's shape the bf16 mode's y equals ``wkv6_scan_mma_emu``
    (the rounding points its source names and its 32-step tiles, emulated
    in fp32 in the kernel's order of additions) rounded to bf16 in at least
    99.9% of the elements, and that emulation is within 1e-2 of the
    all-fp32 plain version: the kernel rounds there and nowhere else."""
    dev = _card()
    b, h, kd = 4, 32, 64
    args = _wkv_model_inputs(b, s, h, kd, kd, torch.bfloat16, dev)
    with torch.no_grad():
        got = _fold(twkv.wkv6_scan_model(*args))
    folded = [_fold(t) for t in args[:4]]
    emu = twkv.wkv6_scan_mma_emu(*folded, args[4])
    same = float((got == emu.to(torch.bfloat16)).float().mean())
    assert same >= 0.999, same
    ref = twkv.wkv6_scan_ref(*(t.float() for t in folded), args[4])
    assert _err(emu, ref) <= 1e-2


@pytest.mark.gpu
def test_wkv6_fp32_takes_unaligned_layouts():
    """The fp32 mode reads scalars: K and V that are not multiples of 4, a
    step stride of 56 bytes and a base off a 16-byte boundary launch as
    they are and match the plain version."""
    from repro_torch.kernels import ops
    dev = _card()
    b, s, h, kd, vd = 2, 100, 3, 13, 6
    r, kk, vv, lw, u = _wkv_model_inputs(b, s, h, kd, vd, torch.float32, dev)
    wide = torch.zeros(b, s, h, kd + 1, device=dev)
    wide[..., :kd] = r
    flat = torch.zeros(b * s * h * vd + 1, device=dev)
    flat[1:] = vv.flatten()
    shifted = flat[1:].view(b, s, h, vd)
    before = twkv.wkv6_scan_bhsd.launches
    with torch.no_grad():
        got = ops.rwkv6_wkv(wide[..., :kd], kk, shifted, lw, u, chunk=16)
    assert twkv.wkv6_scan_bhsd.launches == before + 1
    ref = twkv.wkv6_scan_ref(*(_fold(t) for t in (r, kk, vv, lw)), u,
                             chunk=16)
    assert _err(_fold(got), ref) <= TOL["float32"]


@pytest.mark.gpu
def test_wkv6_model_layout_launches_only_k7():
    """One profiled ``ops.rwkv6_wkv`` on the model layout runs K7's device
    kernel and nothing else: no permute, copy or contiguous kernel."""
    _card()
    names = _profiled_kernels(
        "args = t._wkv_model_inputs(4, 2048, 32, 64, 64, torch.bfloat16, "
        "dev)\n"
        "def call():\n"
        "    ops.rwkv6_wkv(*args)")
    assert names and all("wkv6_mma_kernel" in k for k in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kd,vd", [(64, 64), (128, 128), (16, 16), (64, 48)])
def test_wkv6_plan_matches_the_kernel(dtype, kd, vd):
    """The plan's shared memory and blocks per SM are the C entries'
    (``rwkv6_wkv_smem_bytes``, and ``rwkv6_wkv_blocks_per_sm`` from the
    occupancy API), and a launch as planned runs."""
    from repro_torch.kernels import _build
    dev = _card()
    td = DTYPES[dtype]
    r, kk, vv, lw, u = _wkv_model_inputs(1, 64, 2, kd, vd, td, dev)
    pl = twkv.plan(r, kk, vv, lw, u, torch.empty_like(vv))
    code = twkv._DTYPES[td]
    assert pl.smem == _build.entry("rwkv6_wkv_smem_bytes")(code, kd, pl.vs)
    assert pl.blocks_per_sm == \
        _build.entry("rwkv6_wkv_blocks_per_sm")(code, kd, pl.vs)
    twkv.wkv6_scan_model(r, kk, vv, lw, u)
    torch.cuda.synchronize()
    if (dtype, kd) == ("bfloat16", 64):
        assert pl.blocks_per_sm == 2


@pytest.mark.gpu
def test_wkv6_refuses_what_it_does_not_take():
    """The bf16 mode takes K and V in multiples of 8 up to 128 and loads
    rows in 16-byte chunks: beyond that, another dtype, or a layout whose
    rows are not 16-byte aligned, K7 raises; it never routes to the plain
    version or to the fp32 mode, and counts no launch."""
    from repro_torch.kernels import ops
    dev = _card()
    bf = torch.bfloat16
    before = twkv.wkv6_scan_bhsd.launches
    for kd, vd in ((12, 64), (64, 20), (136, 64)):
        args = _wkv_model_inputs(1, 64, 2, kd, vd, bf, dev)
        with pytest.raises(ValueError, match="takes K and V"):
            ops.rwkv6_wkv(*args)
    r, kk, vv, lw, u = _wkv_model_inputs(1, 64, 2, 64, 64, bf, dev)
    with pytest.raises(TypeError, match="dtype"):
        ops.rwkv6_wkv(r.half(), kk.half(), vv.half(), lw, u)
    wide = torch.zeros(1, 64, 2, 68, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rwkv6_wkv(wide[..., :64], kk, vv, lw, u)
    lwide = torch.zeros(1, 64, 2, 65, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rwkv6_wkv(r, kk, vv, lwide[..., :64], u)
    flat = torch.zeros(64 * 2 * 64 + 1, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="16-byte"):
        ops.rwkv6_wkv(r, kk, flat[1:].view(1, 64, 2, 64), lw, u)
    assert twkv.wkv6_scan_bhsd.launches == before


@pytest.mark.gpu
def test_scan_kernels_refuse_autograd_and_bad_inputs():
    """K6 and K7 have no backward in either package: a CUDA input that
    requires a gradient raises; so do a K7 chunk over 32 steps, K7 strides
    that break its 16-byte copies (bf16) and a K6 B/C of another dtype.
    Under no_grad they run, one launch a call."""
    dev = _card()
    x = torch.randn(4, 64, 32, device=dev, requires_grad=True)
    da = -torch.rand(4, 64, device=dev)
    bm = torch.randn(2, 64, 16, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        tssd.ssd_scan_bhsd(x, da, bm, bm)
    with pytest.raises(ValueError, match="expected"):
        tssd.ssd_scan_bhsd(x.detach(), da, bm.to(torch.bfloat16), bm)
    r = torch.randn(4, 64, 32, device=dev)
    lw = -torch.rand(4, 64, 32, device=dev)
    u = torch.randn(2, 32, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        twkv.wkv6_scan_bhsd(r, r, r, lw, u)
    with pytest.raises(RuntimeError, match="no backward"):
        twkv.wkv6_scan_model(*(t.unsqueeze(0) for t in (r, r, r, lw)), u)
    with torch.no_grad():
        with pytest.raises(ValueError, match="exact only for chunks"):
            twkv.wkv6_scan_bhsd(r, r, r, lw, u, chunk=64)
        rb = torch.zeros(4, 64, 36, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte"):
            twkv.wkv6_scan_bhsd(rb[..., :32], rb[..., :32], rb[..., :32],
                                lw, u)
        tssd.ssd_scan_bhsd(x, da, bm, bm)
        before = twkv.wkv6_scan_bhsd.launches
        twkv.wkv6_scan_bhsd(r, r, r, lw, u)
        assert twkv.wkv6_scan_bhsd.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_recurrent_eval_kernel_path_matches_plain_path(name):
    """Reduced zamba2 and rwkv6 in fp32: one eval through K6/K7 (and K2, K3,
    K4 where the model has them) against the plain path, loss to 1e-5
    relative, with each mixer kernel launched once per layer."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_eval_step
    dev = _card()
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    lm = LM(cfg)
    params = lm.init(3, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=dev)
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    ops.reset_launch_counts()
    got = make_eval_step(lm, ForwardOpts())(params, batch)
    mixer = "ssd_scan_bhsd" if cfg.family == "hybrid" else "wkv6_scan_bhsd"
    assert ops.launch_counts()[mixer] == cfg.num_layers
    plain = make_eval_step(lm, ForwardOpts(attn_impl="dense",
                                           norm_impl="plain",
                                           mixer_impl="plain",
                                           xent_impl="plain"))(params, batch)
    assert abs(float(got["loss"]) - float(plain["loss"])) \
        <= 1e-5 * abs(float(plain["loss"]))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_chunked_served_run_launch_counts(kv_dtype):
    """Reduced qwen3-4b in bf16 served eagerly with chunked prefill
    (chunks of 16, budget 32) over native or int8 pages: K2 never runs,
    K3 runs at every norm of every chunk dispatch and decode step, K1 (its
    int8 mode over int8 pages) once a layer a decode step; every request
    completes and the stall counter stays 0 (no round spends past the
    budget)."""
    _card()
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              dtype="bfloat16")
    lm = LM(cfg)
    eng = ServeEngine(lm, lm.init(3, device="cuda"), max_batch=4,
                      max_seq=96, page_size=8, device="cuda",
                      cuda_graph=False, kv_dtype=kv_dtype, prefill_chunk=16,
                      prefill_budget=32)
    rng = np.random.default_rng(8)
    ops.reset_launch_counts()
    for i in range(8):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, int(
            rng.integers(5, 60))).astype(np.int32), max_new_tokens=12))
    done = eng.run_until_drained()
    assert len(done) == 8 and all(len(r.out_tokens) == 12 for r in done)
    reg = eng.reg
    decodes = reg.counter("serve_decode_dispatches_total").get()
    rounds = reg.counter("serve_prefill_dispatches_total").get()
    assert reg.counter("serve_prefill_chunks_total").get() >= rounds > 0
    assert reg.counter("serve_decode_stall_iters").get() == 0
    L = cfg.num_layers
    k1 = "paged_flash_decode" + ("_int8" if kv_dtype == "int8" else "")
    want = {name: 0 for name in ops.KERNELS}
    want.update({"rmsnorm_rows": (decodes + rounds) * (4 * L + 1),
                 k1: decodes * L})
    assert ops.launch_counts() == want


@pytest.mark.gpu
def test_autopilot_probes_on_the_card():
    """``Autopilot(measure_real=True)`` on the card: the fp32 GEMM and the
    pinned host-to-device copy read finite, positive values and every check
    passes; no alert fires."""
    from repro_torch.core import alerts, health
    from repro_torch.core.cluster import SimCluster
    from repro_torch.core.telemetry import MetricsRegistry
    _card()
    reg = MetricsRegistry()
    ap = health.Autopilot(SimCluster(1, registry=reg), reg, measure_real=True)
    assert ap.device == torch.device("cuda", torch.cuda.current_device())
    res = ap.run_checks()
    assert all(r.passed for r in res)
    for r in res:
        assert np.isfinite(r.value) and r.value > 0, r
    mgr = alerts.AlertManager(reg, rules=alerts.DEFAULT_RULES
                              + alerts.SERVE_RULES)
    assert mgr.evaluate() == []


@pytest.mark.gpu
def test_health_loop_keeps_the_graph_step():
    """Reduced qwen3-4b in bf16 through the CUDA-graph step with the health
    loop wired in (alerts, checks every 4 iterations, the allocator checked
    every iteration): the same streams as without it, one replay per decode
    step, every serve check PASS, no alert."""
    from repro_torch.core import alerts
    from repro_torch.core.telemetry import MetricsRegistry
    _card()
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              dtype="bfloat16")
    lm = LM(cfg)
    params = lm.init(3, device="cuda")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(5, 40)))
               .astype(np.int32) for _ in range(6)]
    streams = []
    for wired in (False, True):
        reg = MetricsRegistry()
        mgr = alerts.AlertManager(reg, rules=alerts.DEFAULT_RULES
                                  + alerts.SERVE_RULES) if wired else None
        eng = ServeEngine(lm, params, max_batch=4, max_seq=96, page_size=8,
                          device="cuda", registry=reg, alerts=mgr,
                          health_every=4, verify_cache=wired)
        replays = []
        replay = eng._replay

        def counted(view, replay=replay):
            replays.append(1)
            return replay(view)

        eng._replay = counted
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=10))
        streams.append({r.id: r.out_tokens for r in eng.run_until_drained()})
        assert len(replays) == reg.counter(
            "serve_decode_dispatches_total").get() > 0
    assert streams[0] == streams[1]
    assert mgr.fired == []
    assert all(v == 1.0 for name, series in reg.snapshot().items()
               if name.startswith("autopilot") for v in series.values())
    assert reg.gauge("autopilot_serve_cache_invariants").get() == 1.0


def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module: its phase 5c K1 NaN cases
    are the cases of the test below."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["mid", "split", "recycled"])
@pytest.mark.parametrize("mode", ["native bf16", "native fp32", "int8",
                                  "partials n=2"])
def test_paged_decode_carries_a_poisoned_page_to_its_victim_only(mode,
                                                                 where):
    """K1 in every mode at the serve shape: a poisoned live page (mid-range,
    or the only page of a split's range) makes every element of its
    victim's row non-finite and leaves every other slot's row bitwise the
    clean call's; NaN rows past a new owner's position (a recycled page)
    are never read, so every row stays bitwise the clean call's."""
    _card()
    r = _chip_smoke().k1_nan_case(mode, where)
    want = 0 if where == "recycled" else r["victim"]
    assert r["victim_nonfinite"] == want, r
    assert r["others_equal"], r


def _poison_engine(graph, **kw):
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              dtype="bfloat16")
    lm = LM(cfg)
    eng = ServeEngine(lm, lm.init(3, device="cuda"), max_batch=4,
                      max_seq=64, page_size=8, device="cuda",
                      cuda_graph=graph, **kw)
    rng = np.random.default_rng(12)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 6 + 5 * i)
                    .astype(np.int32), max_new_tokens=12) for i in range(6)]
    return eng, reqs


@pytest.mark.gpu
def test_graph_replay_with_poison_mask_equals_eager_bitwise():
    """The nan_logits seam inside the graph: with the poison mask set on
    two live slots one replay's (B, V) rows equal the eager step's on the
    same static inputs, NaN for exactly those rows (tokens -1), the rest
    finite; with the mask cleared the same graph gives finite rows."""
    _card()
    eng, reqs = _poison_engine(True)
    for r in reqs[:4]:
        eng.submit(r)
    eng.step()
    assert eng.active.all()
    eng._poison.set(np.array([False, True, False, True]))
    view = eng.kv.decode_view()
    eager_rows, eager_tok = eng._decode(view)
    rows, tok = (t.clone() for t in eng._replay(view))
    assert torch.equal(torch.isnan(rows), torch.isnan(eager_rows))
    assert torch.equal(rows.nan_to_num(0.0), eager_rows.nan_to_num(0.0))
    assert bool(torch.isnan(rows[[1, 3]]).all())
    assert bool(torch.isfinite(rows[[0, 2]]).all())
    assert torch.equal(tok, eager_tok) and tok[[1, 3]].tolist() == [-1, -1]
    eng._poison.set(False)
    rows, tok = eng._replay(view)
    assert bool(torch.isfinite(rows).all()) and bool((tok >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["nan_logits@2,poison_page@5",
                                  "dispatch_error@3:dur=2"])
def test_faulted_run_graph_equals_eager(plan):
    """A fault plan through the graph step and eagerly (bf16, so the
    recovered streams are not held to the fault-free run): the same
    streams, statuses and fault counters, one replay per decode step and
    the graph never recaptured."""
    from repro_torch.serve import FaultPlan
    _card()
    out = []
    for graph in (True, False):
        eng, reqs = _poison_engine(graph, watchdog_iters=8,
                                   verify_cache=True,
                                   fault_plan=FaultPlan.parse(plan))
        captured, replays = eng._graph, []

        def counted(view, replay=eng._replay):
            replays.append(1)
            return replay(view)

        eng._replay = counted
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        decodes = eng.reg.counter("serve_decode_dispatches_total").get()
        assert len(replays) == (decodes if graph else 0)
        assert eng._graph is captured
        out.append(({r.id: (r.status, r.out_tokens) for r in done},
                    sorted(eng.reg.counter(
                        "serve_stream_retries_total").labels_values())))
    assert out[0] == out[1] and out[0][1]


@pytest.mark.gpu
def test_host_tier_offload_is_a_snapshot_and_prefetch_is_fenced():
    """``chip_smoke.py`` phase 5d (c) with the stream held busy: the store
    holds a freed page's first bytes although a chunked slot claimed and
    rewrote the page before the drain, and a page prefetched just before
    the host poisons its store entry holds the clean bytes.  A cache that
    stores a view of the freed page fails the first check."""
    _card()
    cs = _chip_smoke()
    assert cs.tier_hazards() == {"view_holds_a": True, "view_holds_b": False,
                                 "fence_clean": True}
    view = cs.tier_hazards("view")
    assert view["view_holds_b"] and not view["view_holds_a"]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_host_tier_warm_engine_equals_cold_through_the_graph(kv_dtype):
    """A cold engine lands three 48-token prefixes in chunks of 8 (page 8,
    bf16) and offloads them; a new engine on the same store prefetches
    them (6 hits, 6 of 7 chunks skipped a prompt): its streams are
    bitwise the cold ones, every decode step one replay of the graph it
    captured, and the pools never re-allocated."""
    from repro_torch.serve import PrefixStore
    _card()
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              dtype="bfloat16")
    lm = LM(cfg)
    params = lm.init(5, device="cuda")
    rng = np.random.default_rng(4)
    prompts = [np.concatenate([rng.integers(0, cfg.vocab_size, 48),
                               rng.integers(0, cfg.vocab_size, 3)])
               .astype(np.int32) for _ in range(3)]
    store, streams = PrefixStore(32), []
    for phase in ("cold", "warm"):
        eng = ServeEngine(lm, params, max_batch=2, max_seq=64, page_size=8,
                          device="cuda", prefill_chunk=8, prefix_store=store,
                          kv_dtype=kv_dtype)
        captured, replays = eng._graph, []

        def counted(view, replay=eng._replay):
            replays.append(1)
            return replay(view)

        eng._replay = counted
        before = store.stats()
        streams.append([cs._serve_one(eng, i, p)[1]
                        for i, p in enumerate(prompts)])
        decodes = eng.reg.counter("serve_decode_dispatches_total").get()
        assert len(replays) == decodes and eng._graph is captured
        hits = store.stats()["hits"] - before["hits"]
        skipped = eng.reg.counter("serve_prefill_chunks_skipped_total").get()
        assert (hits, skipped) == ((0, 0) if phase == "cold" else (18, 18))
    assert streams[1] == streams[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_g7_native_and_int8_match_plain(dtype):
    """K1 at arctic-480b's head layout (KV=8, G=7, D=128, page 16): an odd
    query group, so the tensor-core path pads 7 rows to 8; native and int8
    pools against the plain version and the plain split schedule, with
    boundary positions, a freed slot and NaN dead pages."""
    from repro_torch.kernels.quant import quantize_kv
    dev = _card()
    gen = torch.Generator().manual_seed(28)
    b, kv, g, d, page, m = 6, 8, 7, 128, 16, 8
    n_pages = b * m + 1
    pos = torch.tensor([0, page - 1, page, 3 * page + 5, m * page - 1, 0],
                       dtype=torch.int32)
    table = (torch.randperm(n_pages - 1, generator=gen)[: b * m] + 1)
    table = table.reshape(b, m).to(torch.int32)
    table[5] = 0
    k = torch.randn(n_pages, page, kv, d, generator=gen)
    v = torch.randn(n_pages, page, kv, d, generator=gen)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    for s in range(b - 1):
        dead = table[s, pos[s] // page + 1:].long()
        for t in (k, v, ks, vs):
            t[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen).to(dev, DTYPES[dtype])
    k, v, kq, vq, ks, vs, table, pos = (
        x.to(dev) for x in (k, v, kq, vq, ks, vs, table, pos))
    k, v = k.to(DTYPES[dtype]), v.to(DTYPES[dtype])
    for fn, pools, quant in ((tpd.paged_flash_decode, (k, v), False),
                             (tpd.paged_flash_decode_int8, (kq, vq, ks, vs),
                              True)):
        mode = "int8" if quant else "native"
        before = fn.launches
        got = fn(q, *pools, table, pos)
        assert fn.launches == before + 1
        assert bool(torch.isfinite(got.float()).all())
        scales = pools[2:]
        ref = tpd.paged_decode_ref(q, pools[0], pools[1], table, pos, *scales)
        assert _err(got, ref) <= TOL[dtype], mode
        split = tpd.paged_decode_split_ref(
            q, pools[0], pools[1], table, pos, *scales,
            splits=_splits(q, pools[0], table, quant))
        assert _err(got, split) <= TOL[dtype], mode
        assert torch.equal(got, fn(q, *pools, table, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 128])
def test_flash_attention_noncausal_d64_model_layout(dtype, s):
    """K2 as seamless-m4t's encoder runs it: non-causal, KV=16, G=1,
    D=64, on q, k, v sliced out of one fused (B, S, 3·16·64) projection
    (strided views), one launch, against the plain version."""
    dev = _card()
    b, kv, g, d = 4, 16, 1, 64
    gen = torch.Generator(device=dev).manual_seed(16)
    qkv = torch.randn(b, s, 3 * kv * d, device=dev, generator=gen).to(
        DTYPES[dtype])
    q = qkv[..., :kv * d].unflatten(-1, (kv, g, d))
    k = qkv[..., kv * d:2 * kv * d].unflatten(-1, (kv, d))
    v = qkv[..., 2 * kv * d:].unflatten(-1, (kv, d))
    before = sum(_k2_launches())
    got = ops.flash_attention(q, k, v, causal=False)
    assert sum(_k2_launches()) == before + 1
    ref = tfa.flash_attention_ref(
        q.permute(0, 2, 3, 1, 4).reshape(b * kv * g, s, d),
        k.permute(0, 2, 1, 3).reshape(b * kv, s, d),
        v.permute(0, 2, 1, 3).reshape(b * kv, s, d), causal=False)
    assert _err(got, ref.reshape(b, kv, g, s, d).permute(0, 3, 1, 2, 4)) \
        <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_moe_graph_replay_equals_eager_step(kv_dtype):
    """moonshot-v1-16b-a3b reduced in bf16 (8 experts, top-2): one
    engine through its CUDA-graph step, one eagerly, the same ragged
    requests arriving over several iterations (parked slots route in the
    decode group): every decode step's live logit rows bitwise equal, and
    equal streams."""
    _card()
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(),
                              dtype="bfloat16")
    lm = LM(cfg)
    params = lm.init(6, device="cuda")
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32),
             int(new)) for i, (n, new) in enumerate(
                 zip(rng.integers(3, 30, 8), rng.integers(4, 12, 8)))]
    runs = []
    for graph in (True, False):
        eng = ServeEngine(lm, params, max_batch=4, max_seq=64, page_size=8,
                          device="cuda", cuda_graph=graph, kv_dtype=kv_dtype)
        assert (eng._graph is not None) == graph
        rows, name = [], "_replay" if graph else "_decode"

        def record(view, run=getattr(eng, name)):
            out = run(view)
            rows.append(out[0][torch.from_numpy(eng.active).cuda()].clone())
            return out
        setattr(eng, name, record)
        for it in range(200):
            for i, p, new in reqs:
                if i // 3 == it:
                    eng.submit(Request(i, p.copy(), max_new_tokens=new))
            if not eng.step() and it > len(reqs) // 3 and not eng.queue:
                break
        assert len(eng.finished) == len(reqs)
        runs.append((rows, sorted((r.id, r.out_tokens)
                                  for r in eng.finished)))
    (g_rows, g_out), (e_rows, e_out) = runs
    assert len(g_rows) == len(e_rows) > 0
    for k, (a, b) in enumerate(zip(g_rows, e_rows)):
        assert torch.equal(a, b), f"decode step {k} differs"
    assert g_out == e_out
