"""K1, paged flash-decode: one-token GQA attention per slot through a page
table.

Replaces the TPU kernel ``paged_flash_decode`` of
``src/repro/kernels/paged_decode.py`` in its normalized-output,
page-offset-0 mode, with native-dtype pools (``paged_flash_decode``) and
with int8 pools and their per-row fp32 scales (``paged_flash_decode_int8``,
the TPU kernel's ``k_scale``/``v_scale`` mode).  Both are one CUDA source,
``src/repro_torch/csrc/paged_decode.cu``, which states what bounds it on
the card and what its design does about that.  The ``partials`` mode is
later work.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version, ``paged_decode_ref``, for CPU tensors; it never falls back.  The
kernels have no backward, so they raise on a CUDA input that requires a
gradient rather than return a tensor that cuts the graph.  Each counts its
own launches.

Layouts: q (B, KV, G, D); pools (P, page, KV, D), page 0 the scratch page;
int8 scales (P, page, KV) fp32; page_table (B, M) int32; positions (B,)
int32; out (B, KV, G, D) like q.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_ref(q, k_pool, v_pool, page_table, positions, k_scale=None,
                     v_scale=None):
    """Plain version: gather each slot's pages into a dense view and take the
    masked softmax in fp32.  Table entries past a slot's live pages are
    redirected to the scratch page first, as the JAX ``gather_pages`` does:
    those rows are masked, but a NaN there would leak through ``0 * NaN``.
    With ``k_scale``/``v_scale`` the int8 rows dequantize through the same
    redirected table, so a row and its scale come from one page."""
    b, kv, g, d = q.shape
    page = k_pool.shape[1]
    m = page_table.shape[1]
    pt = page_table.long()
    live = (torch.arange(m, device=q.device)[None, :]
            <= (positions.long() // page)[:, None])
    pt = torch.where(live, pt, torch.zeros_like(pt))
    kg = k_pool[pt].reshape(b, m * page, kv, d).float()
    vg = v_pool[pt].reshape(b, m * page, kv, d).float()
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_ref: k_scale and v_scale go together")
    if k_scale is not None:
        kg = kg * k_scale[pt].reshape(b, m * page, kv, 1)
        vg = vg * v_scale[pt].reshape(b, m * page, kv, 1)
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), kg) / d ** 0.5
    valid = (torch.arange(m * page, device=q.device)[None, :]
             <= positions.long()[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, vg).to(q.dtype)


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


def paged_flash_decode(q, k_pool, v_pool, page_table, positions):
    """Paged decode attention over native-dtype pools; see the module
    docstring for layouts."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for {q.device}")
    _build.refuse_autograd("paged_flash_decode", q, k_pool, v_pool)
    b, kv, g, d = q.shape
    n_pages, page = k_pool.shape[:2]
    m = page_table.shape[1]
    _check("paged_flash_decode", q, (
        ("k_pool", k_pool, (n_pages, page, kv, d), q.dtype),
        ("v_pool", v_pool, (n_pages, page, kv, d), q.dtype),
        ("page_table", page_table, (b, m), torch.int32),
        ("positions", positions, (b,), torch.int32)))
    if d * q.element_size() % 16:
        raise ValueError(f"paged_flash_decode: rows of {d} {q.dtype} are "
                         "not a whole number of 16-byte loads")
    q = q.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        rc = _build.entry("paged_decode_launch")(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
            out.data_ptr(), b, kv, g, d, page, m, stream)
    _build.check(rc, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


def paged_flash_decode_int8(q, k_pool, v_pool, k_scale, v_scale, page_table,
                            positions):
    """Paged decode attention over int8 pools: each staged K/V element is
    ``int8 -> fp32 * scale[page_id, row, head]``, in registers.  q is fp32
    or bf16 and the output has its dtype."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, positions,
                                k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_int8: no kernel for {q.device}")
    _build.refuse_autograd("paged_flash_decode_int8", q, k_scale, v_scale)
    b, kv, g, d = q.shape
    n_pages, page = k_pool.shape[:2]
    m = page_table.shape[1]
    _check("paged_flash_decode_int8", q, (
        ("k_pool", k_pool, (n_pages, page, kv, d), torch.int8),
        ("v_pool", v_pool, (n_pages, page, kv, d), torch.int8),
        ("k_scale", k_scale, (n_pages, page, kv), torch.float32),
        ("v_scale", v_scale, (n_pages, page, kv), torch.float32),
        ("page_table", page_table, (b, m), torch.int32),
        ("positions", positions, (b,), torch.int32)))
    if d % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"paged_flash_decode_int8: rows of {d} int8 are "
                         "not a whole number of 16-byte loads")
    q = q.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        rc = _build.entry("paged_decode_int8_launch")(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            page_table.data_ptr(), positions.data_ptr(), out.data_ptr(), b,
            kv, g, d, page, m, stream)
    _build.check(rc, "paged_flash_decode_int8")
    paged_flash_decode_int8.launches += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode_int8.launches = 0
