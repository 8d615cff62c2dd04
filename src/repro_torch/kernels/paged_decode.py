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
version, ``paged_decode_ref``, for CPU tensors; it never falls back.  The
kernels have no backward, so they raise on a CUDA input that requires a
gradient rather than return a tensor that cuts the graph.  Each counts its
own launches.

Layouts: q (B, KV, G, D); pools (P, page, KV, D), global page 0 the scratch
page; int8 scales (P, page, KV) fp32; page_table (B, M) int32; positions
(B,) int32; out (B, KV, G, D) like q; partials acc (B, KV, G, D), l and m
(B, KV, G), fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The running max a shard with no live row reports (the TPU kernel's).
NEG_INF = -1e30


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
    if q.device.type != "cuda":
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
    if d * k_pool.element_size() % 16 or k_pool.data_ptr() % 16 \
            or v_pool.data_ptr() % 16:
        raise ValueError(f"{what}: rows of {d} {k_pool.dtype} are not a "
                         "whole number of 16-byte loads")
    if not 0 <= page_offset < 2 ** 31 - n_pages:
        raise ValueError(f"{what}: page_offset {page_offset} out of range")
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
            stream)
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
