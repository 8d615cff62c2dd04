"""K1, paged flash-decode: one-token GQA attention per slot through a page
table.

Replaces the TPU kernel ``paged_flash_decode`` of
``src/repro/kernels/paged_decode.py`` in all its modes, four wrappers over
one CUDA source, ``src/repro_torch/csrc/paged_decode.cu``, which states what
bounds it on the card and what its design does about that:

* ``paged_flash_decode`` — native-dtype pools, normalized output;
* ``paged_flash_decode_int8`` — int8 pools and their per-row fp32 scales
  (the TPU kernel's ``k_scale``/``v_scale`` mode), normalized output;
* ``paged_flash_decode_partials`` and ``paged_flash_decode_partials_int8``
  — the TPU kernel's ``partials=True`` with ``page_offset``: the pool is
  one shard of a pool split over ranks, ``page_offset`` the GLOBAL id of
  its first page, and the table keeps global ids; entries outside
  ``[page_offset, page_offset + P_local)`` are skipped exactly like dead
  pages, and the raw fp32 online-softmax triple ``(acc, l, m)`` comes back
  for the cross-shard merge (``repro_torch.parallel.pagedkv``).  A slot
  with no live page in the shard gives exactly ``(0, 0, NEG_INF)``.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version, ``paged_decode_ref``, for CPU tensors; it never falls back.  On
meta tensors (the dry-run) it checks the operands and returns meta outputs
of the kernel's shapes and dtypes, computing nothing.  Each launch and
meta call reports its work to an active ``roofline.kernels`` counter, as
over the whole table (the live rows are on the card).  The kernels have no
backward, so they raise on a CUDA or meta input that requires a gradient
rather than return a tensor that cuts the graph.  Each counts its own
launches: one per call.

Every mode is one launch of one design: each slot's live pages split over
the ``splits`` blocks of a thread-block cluster, merged in distributed
shared memory.  ``plan`` is that launch's host side as a pure function of
the shapes and the SM count (never of ``positions``, so a call needs no
host sync and can be captured in a CUDA graph); ``paged_decode_split_ref``
is the plain version of its schedule (the splits' triples from
``paged_decode_ref`` merged in rank order), for the tests and the chip
smoke test only.

Layouts: q (B, KV, G, D); pools (P, page, KV, D), global page 0 the scratch
page; int8 scales (P, page, KV) fp32; page_table (B, M) int32; positions
(B,) int32; out (B, KV, G, D) like q; partials acc (B, KV, G, D), l and m
(B, KV, G), fp32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import kernels as work

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The running max a shard with no live row reports (the TPU kernel's).
NEG_INF = -1e30

MAX_D = 256                   # 32 lanes of 8 elements hold a row
MAX_MMA_D = 128               # 8 k-steps of 16 on the tensor cores
MAX_SPLITS = 8                # the portable cluster size
MIN_BLOCKS_PER_SM = 3         # __launch_bounds__: registers allow 3
BLOCKS_PER_SM = 2             # the blocks a launch aims to put on an SM
MIN_PAGES_PER_SPLIT = 8       # a split's share of the table, at least
SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
SM_SMEM = 233_472             # shared memory of an SM (228 KB)
SMEM_RESERVED = 1_024         # the runtime's share of each resident block


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of K1 (csrc ``paged_decode_split_kernel``)."""
    splits: int                # blocks of a cluster, sharing a slot's pages
    pages_per_split: int       # the most a split takes: ceil(M / splits)
    group: int                 # GB, query rows a block holds (G <= GB ...)
    g_blocks: int              # ... or G over ceil(G / GB) clusters
    grid: Tuple[int, int]      # (splits, B * KV * g_blocks)
    cluster: int               # cluster size, = splits
    tensor_cores: bool         # mma.sync (bf16 q) or CUDA cores
    smem: int                  # dynamic shared memory of a block
    blocks_per_sm: int         # blocks of the launch one SM holds


def uses_tensor_cores(dtype, d: int) -> bool:
    """bf16 q with D a multiple of 16 up to ``MAX_MMA_D`` runs on the tensor
    cores (8 query rows a block); anything else on the CUDA cores."""
    return dtype == torch.bfloat16 and d % 16 == 0 and d <= MAX_MMA_D


def smem_bytes(psize: int, quant: bool, mma: bool, gb: int, d: int,
               m: int) -> int:
    """Dynamic shared memory of a block for pool elements of ``psize``
    bytes (csrc ``make_layout``): 4 warps' rings of stages (K rows, V rows,
    int8 scales, a row mask; on the tensor cores bf16 rows padded by 16
    bytes, int8 K or V rows converted beside them), large enough to take
    the cluster's 8 triples in rank 0, the block's merged triple, and the
    page lists of M entries."""
    lpr = -(-d // 8)
    rpw = 32 // (1 << (lpr - 1).bit_length())
    rows = 16 if mma else min(32, (2 if gb == 8 else 4) * rpw)
    pitch = d * psize + (16 if mma and psize == 2 else 0)
    stage = 2 * rows * pitch + (8 * rows if quant else 0) + 16
    conv = rows * (2 * d + 16) if mma and quant else 0
    stages = 2 if mma or psize == 4 else 4
    blk = _align16(4 * (gb * d + 2 * gb))
    slots = _align16(-(-MAX_SPLITS * blk // 4))
    return 4 * max(stages * stage + conv, slots) + blk + 8 * m


def plan(b: int, kv: int, g: int, d: int, page: int, m: int, dtype,
         quant: bool, partials: bool, n_sms: int) -> Plan:
    """The launch for these shapes on a card of ``n_sms`` SMs, from shapes
    alone.  ``splits`` aims at ``BLOCKS_PER_SM`` blocks on every SM in one
    wave, but gives a split at least ``MIN_PAGES_PER_SPLIT`` of the table's
    M pages (a block's fixed cost, ~7 us of listing, barriers and merge on
    the H100, outweighs a few pages' loads); at most 8, at least 1.  The
    normalized and partials modes launch alike.  Raises
    ``ValueError`` for what the kernel does not take: D past ``MAX_D`` or not
    a whole number of 16-byte pieces, or shared memory past the card's."""
    del partials                  # both outputs come from the same merge
    psize = 1 if quant else torch.empty((), dtype=dtype).element_size()
    if d < 1 or d > MAX_D or d * psize % 16:
        raise ValueError(f"paged_decode: rows of {d} "
                         f"{'int8' if quant else dtype} are not a whole "
                         f"number of 16-byte loads of at most {MAX_D} "
                         "elements")
    mma = uses_tensor_cores(dtype, d)
    gb = 8 if mma or g > 4 else 4
    g_blocks = -(-g // gb)
    smem = smem_bytes(psize, quant, mma, gb, d, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_decode: {smem} B of shared memory for "
                         f"D={d}, M={m} exceeds {SMEM_LIMIT}")
    static = 4 * (MAX_SPLITS * gb + gb + 1)
    per_sm = min(MIN_BLOCKS_PER_SM,
                 SM_SMEM // (smem + static + SMEM_RESERVED))
    clusters = b * kv * g_blocks
    splits = max(1, min(MAX_SPLITS, -(-BLOCKS_PER_SM * n_sms // clusters),
                        n_sms * per_sm // clusters,
                        -(-m // MIN_PAGES_PER_SPLIT)))
    return Plan(splits=splits, pages_per_split=-(-m // splits), group=gb,
                g_blocks=g_blocks, grid=(splits, clusters), cluster=splits,
                tensor_cores=mma, smem=smem, blocks_per_sm=per_sm)


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_decode_ref(q, k_pool, v_pool, page_table, positions, k_scale=None,
                     v_scale=None, page_offset: int = 0,
                     partials: bool = False):
    """Plain version: gather each slot's pages into a dense view and take the
    masked softmax in fp32.  Table entries past a slot's live pages, and
    outside the pool's window ``[page_offset, page_offset + P)``, are
    redirected to the pool's first page, and the rows they give are masked
    and zeroed, so what such a page holds (even NaN) never reaches the
    result, as the kernel never reads it.  With ``k_scale``/``v_scale`` the
    int8 rows dequantize through the same redirected table, so a row and
    its scale come from one page.  With ``partials`` returns the raw fp32
    triple ``(acc, l, m)``; the explicit zero on masked probabilities makes
    a slot with no live row in the window ``(0, 0, NEG_INF)``."""
    b, kv, g, d = q.shape
    p_local, page = k_pool.shape[:2]
    m = page_table.shape[1]
    local = page_table.long() - page_offset
    ok = ((torch.arange(m, device=q.device)[None, :]
           <= (positions.long() // page)[:, None])
          & (local >= 0) & (local < p_local))
    pt = torch.where(ok, local, torch.zeros_like(local))
    valid = ((torch.arange(m * page, device=q.device)[None, :]
              <= positions.long()[:, None])
             & ok[:, :, None].expand(b, m, page).reshape(b, m * page))
    kg = k_pool[pt].reshape(b, m * page, kv, d).float()
    vg = v_pool[pt].reshape(b, m * page, kv, d).float()
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_ref: k_scale and v_scale go together")
    if k_scale is not None:
        kg = kg * k_scale[pt].reshape(b, m * page, kv, 1)
        vg = vg * v_scale[pt].reshape(b, m * page, kv, 1)
    vg = torch.where(valid[:, :, None, None], vg, torch.zeros_like(vg))
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), kg) / d ** 0.5
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    if not partials:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgs,bskd->bkgd", p, vg).to(q.dtype)
    mx = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - mx[..., None]), torch.zeros_like(s))
    return torch.einsum("bkgs,bskd->bkgd", p, vg), p.sum(dim=-1), mx


def paged_decode_split_ref(q, k_pool, v_pool, page_table, positions,
                           k_scale=None, v_scale=None, page_offset: int = 0,
                           partials: bool = False, *, splits: int):
    """Plain version of the kernel's schedule: each slot's live pages in the
    window, listed in logical order, cut into ``splits`` ranges of
    ceil(n / splits) pages (n the slot's count; a range may be empty); each
    range's triple from ``paged_decode_ref(..., partials=True)`` on a table
    that keeps only that range's pages (the rest point outside the window);
    the triples merged in rank order: ``w = exp(m - max m)``, ``sum acc *
    w``, ``sum l * w``.  Normalized, ``acc / max(l, 1e-30)`` in q's dtype;
    with ``partials``, the fp32 triple (a slot with no live row in the
    window: exactly ``(0, 0, NEG_INF)``)."""
    p_local, page = k_pool.shape[:2]
    m = page_table.shape[1]
    local = page_table.long() - page_offset
    ok = ((torch.arange(m, device=q.device)[None, :]
           <= (positions.long() // page)[:, None])
          & (local >= 0) & (local < p_local))
    idx = torch.cumsum(ok.long(), dim=1) - 1        # rank in the live list
    per = (ok.sum(dim=1, keepdim=True) + splits - 1) // splits
    rank = torch.where(ok, idx // per.clamp(min=1), -1)
    outside = torch.full_like(page_table, page_offset - 1)
    triples = [paged_decode_ref(q, k_pool, v_pool,
                                torch.where(rank == r, page_table, outside),
                                positions, k_scale, v_scale, page_offset,
                                partials=True)
               for r in range(splits)]
    mx = torch.stack([t[2] for t in triples]).amax(dim=0)
    acc = l = 0
    for a, s, mr in triples:
        w = torch.exp(mr - mx)
        acc = acc + a * w[..., None]
        l = l + s * w
    if partials:
        return acc, l, mx
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _check(what, q, operands):
    """Device, dtype, shape and contiguity of every operand; q's dtype."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {q.dtype}")
    for name, t, shape, dtype in operands:
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} not contiguous")


def _launch(fn, q, k_pool, v_pool, scales, page_table, positions,
            page_offset: int, partials: bool):
    """Every mode's launch: the plain version for CPU tensors, else check the
    operands, allocate the outputs and launch ``fn``'s kernel mode, counting
    the launch on ``fn``."""
    what = fn.__name__
    ks, vs = scales
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, positions, ks,
                                vs, page_offset, partials)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: no kernel for {q.device}")
    _build.refuse_autograd(what, q, k_pool, v_pool,
                           *(s for s in scales if s is not None))
    b, kv, g, d = q.shape
    n_pages, page = k_pool.shape[:2]
    m = page_table.shape[1]
    quant = ks is not None
    pool_dtype = torch.int8 if quant else q.dtype
    operands = [("k_pool", k_pool, (n_pages, page, kv, d), pool_dtype),
                ("v_pool", v_pool, (n_pages, page, kv, d), pool_dtype),
                ("page_table", page_table, (b, m), torch.int32),
                ("positions", positions, (b,), torch.int32)]
    if quant:
        operands += [("k_scale", ks, (n_pages, page, kv), torch.float32),
                     ("v_scale", vs, (n_pages, page, kv), torch.float32)]
    _check(what, q, operands)
    work.report(what, work.paged_decode, q, page_table, b * m * page, quant,
                partials)
    if q.device.type == "meta":
        if partials:
            l = torch.empty(b, kv, g, dtype=torch.float32, device="meta")
            return (torch.empty(b, kv, g, d, dtype=torch.float32,
                                device="meta"), l, torch.empty_like(l))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if d * k_pool.element_size() % 16 or k_pool.data_ptr() % 16 \
            or v_pool.data_ptr() % 16:
        raise ValueError(f"{what}: rows of {d} {k_pool.dtype} are not a "
                         "whole number of 16-byte loads")
    if not 0 <= page_offset < 2 ** 31 - n_pages:
        raise ValueError(f"{what}: page_offset {page_offset} out of range")
    pl = plan(b, kv, g, d, page, m, q.dtype, quant, partials,
              _n_sms(q.device.index if q.device.index is not None
                     else torch.cuda.current_device()))
    q = q.contiguous()
    if partials:
        out = None
        acc = torch.empty(b, kv, g, d, dtype=torch.float32, device=q.device)
        l = torch.empty(b, kv, g, dtype=torch.float32, device=q.device)
        mx = torch.empty_like(l)
    else:
        out, acc, l, mx = torch.empty_like(q), None, None, None

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        rc = _build.entry("paged_decode_launch")(
            _DTYPES[q.dtype], int(quant), int(partials), q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), ptr(ks), ptr(vs),
            page_table.data_ptr(), positions.data_ptr(), ptr(out), ptr(acc),
            ptr(l), ptr(mx), b, kv, g, d, page, m, page_offset, n_pages,
            pl.splits, stream)
    _build.check(rc, what)
    fn.launches += 1
    return (acc, l, mx) if partials else out


def paged_flash_decode(q, k_pool, v_pool, page_table, positions):
    """Paged decode attention over native-dtype pools; see the module
    docstring for layouts."""
    return _launch(paged_flash_decode, q, k_pool, v_pool, (None, None),
                   page_table, positions, 0, False)


def paged_flash_decode_int8(q, k_pool, v_pool, k_scale, v_scale, page_table,
                            positions):
    """Paged decode attention over int8 pools: each staged K/V element is
    ``int8 -> fp32 * scale[page_id, row, head]``, in registers.  q is fp32
    or bf16 and the output has its dtype."""
    return _launch(paged_flash_decode_int8, q, k_pool, v_pool,
                   (k_scale, v_scale), page_table, positions, 0, False)


def paged_flash_decode_partials(q, k_pool, v_pool, page_table, positions,
                                page_offset: int):
    """The raw fp32 ``(acc, l, m)`` of one native-dtype pool shard whose
    first page has global id ``page_offset``; the table keeps global ids."""
    return _launch(paged_flash_decode_partials, q, k_pool, v_pool,
                   (None, None), page_table, positions, page_offset, True)


def paged_flash_decode_partials_int8(q, k_pool, v_pool, k_scale, v_scale,
                                     page_table, positions,
                                     page_offset: int):
    """``paged_flash_decode_partials`` over an int8 pool shard and its
    ``(P_local, page, KV)`` fp32 scale shards."""
    return _launch(paged_flash_decode_partials_int8, q, k_pool, v_pool,
                   (k_scale, v_scale), page_table, positions, page_offset,
                   True)


paged_flash_decode.launches = 0
paged_flash_decode_int8.launches = 0
paged_flash_decode_partials.launches = 0
paged_flash_decode_partials_int8.launches = 0
