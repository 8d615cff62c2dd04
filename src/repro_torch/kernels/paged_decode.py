"""K1, paged flash-decode: one-token GQA attention per slot through a page
table.

Replaces the TPU kernel ``paged_flash_decode`` of
``src/repro/kernels/paged_decode.py`` in its native-dtype, normalized-output,
page-offset-0 mode; the CUDA source is ``src/repro_torch/csrc/
paged_decode.cu``, which states what bounds it on the card and what its
design does about that.  Its int8 pools and ``partials`` mode are later work.

``paged_flash_decode`` launches the kernel for CUDA tensors and runs the
plain version, ``paged_decode_ref``, for CPU tensors; it never falls back.
The kernel has no backward, so it raises on a CUDA input that requires a
gradient rather than return a tensor that cuts the graph.

Layouts: q (B, KV, G, D); pools (P, page, KV, D), page 0 the scratch page;
page_table (B, M) int32; positions (B,) int32; out (B, KV, G, D) like q.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_ref(q, k_pool, v_pool, page_table, positions):
    """Plain version: gather each slot's pages into a dense view and take the
    masked softmax in fp32.  Table entries past a slot's live pages are
    redirected to the scratch page first, as the JAX ``gather_pages`` does:
    those rows are masked, but a NaN there would leak through ``0 * NaN``."""
    b, kv, g, d = q.shape
    page = k_pool.shape[1]
    m = page_table.shape[1]
    pt = page_table.long()
    live = (torch.arange(m, device=q.device)[None, :]
            <= (positions.long() // page)[:, None])
    pt = torch.where(live, pt, torch.zeros_like(pt))
    kg = k_pool[pt].reshape(b, m * page, kv, d).float()
    vg = v_pool[pt].reshape(b, m * page, kv, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), kg) / d ** 0.5
    valid = (torch.arange(m * page, device=q.device)[None, :]
             <= positions.long()[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, vg).to(q.dtype)


def paged_flash_decode(q, k_pool, v_pool, page_table, positions):
    """Paged decode attention; see the module docstring for layouts."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for {q.device}")
    _build.refuse_autograd("paged_flash_decode", q, k_pool, v_pool)
    b, kv, g, d = q.shape
    n_pages, page = k_pool.shape[:2]
    m = page_table.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_flash_decode: unsupported dtype {q.dtype}")
    if d * q.element_size() % 16:
        raise ValueError(f"paged_flash_decode: rows of {d} {q.dtype} are "
                         "not a whole number of 16-byte loads")
    for name, t, shape, dtype in (
            ("k_pool", k_pool, (n_pages, page, kv, d), q.dtype),
            ("v_pool", v_pool, (n_pages, page, kv, d), q.dtype),
            ("page_table", page_table, (b, m), torch.int32),
            ("positions", positions, (b,), torch.int32)):
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"paged_flash_decode: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {name} not contiguous")
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


paged_flash_decode.launches = 0
