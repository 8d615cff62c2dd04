"""GQA attention of the port: full-sequence prefill and one-token decode over
a paged KV cache (counterpart of the dense and decode pieces of the JAX
``repro.models.attention``).

Prefill (``attention_block``) runs ``impl="flash"`` (K2) or ``"dense"`` (the
JAX engine's default, kept as the reference); training runs
``impl="blockwise"``, the JAX trainer's online-softmax attention in plain
torch, which autograd differentiates (K2 has no backward).  Weights are
cast to the activations' dtype at each use, as JAX does, so fp32 master
weights train in bf16 compute and bf16 serving weights are used as they
are.  Decode
(``attention_decode_block``) writes the new token's K/V into the
(P, page, KV, D) pools in place, then attends through the (B, M) page table
with ``impl="kernel"`` (K1) or ``"gather"`` (dense gathered view, the JAX
engine's default).  Physical page 0 is the scratch page: freed slots' table
rows point at it, so masked writes of inactive slots land there.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import P, apply_rope, depth_scale, norm_spec, \
    rms_norm

NEG_INF = -1e30


def attention_spec(cfg):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    assert not cfg.use_bias, "the port's dense configs have no biases"
    spec = {"wq": {"kernel": P((d, h, hd))},
            "wk": {"kernel": P((d, kv, hd))},
            "wv": {"kernel": P((d, kv, hd))},
            "wo": {"kernel": P((h, hd, d), scale=depth_scale(cfg))}}
    if cfg.qk_norm:
        spec["q_norm"] = norm_spec(cfg, hd)
        spec["k_norm"] = norm_spec(cfg, hd)
    return spec


def _proj(w, x):
    """x (B, S, d) @ w (d, H, D) -> (B, S, H, D), in x's dtype."""
    w2 = w.reshape(w.shape[0], -1).to(x.dtype)
    return (x @ w2).reshape(*x.shape[:2], *w.shape[1:])


def project_qkv(p, cfg, x, positions, norm_impl: str = "kernel"):
    """Returns q (B, S, KV, G, D) grouped for GQA and k, v (B, S, KV, D).
    qwen3's q/k norms come before RoPE."""
    q = _proj(p["wq"]["kernel"], x)
    k = _proj(p["wk"]["kernel"], x)
    v = _proj(p["wv"]["kernel"], x)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps, norm_impl)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps, norm_impl)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    b, s, h, hd = q.shape
    kv = cfg.num_kv_heads
    return q.reshape(b, s, kv, h // kv, hd), k, v


def output_proj(p, cfg, y):
    """y (B, S, KV, G, D) -> (B, S, d)."""
    b, s = y.shape[:2]
    wo = p["wo"]["kernel"]
    return y.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1]).to(y.dtype)


def dense_attention(q, k, v, causal: bool):
    """q (B, Sq, KV, G, D); k, v (B, Skv, KV, D).  Scores in fp32; the
    probabilities are cast to q's dtype before PV, as the JAX reference."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() / math.sqrt(hd)
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def blockwise_attention(q, k, v, causal: bool, q_chunk: int = 1024,
                        kv_chunk: int = 1024):
    """Flash attention in plain torch (counterpart of the JAX
    ``blockwise_attention``): a loop over query chunks and, inside, over the
    KV chunks the causal mask needs, with an fp32 online softmax.  The
    softmax scale is folded into q, masking is an additive bias on the
    diagonal chunks only, and probabilities are cast to v's dtype before
    PV.  q (B, Sq, KV, G, D); k, v (B, Skv, KV, D); returns like q."""
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"blockwise_attention: chunks ({q_chunk}, "
                         f"{kv_chunk}) do not divide ({sq}, {skv})")
    q = q * (1.0 / math.sqrt(hd))
    outs = []
    for i in range(sq // q_chunk):
        q_blk = q[:, i * q_chunk:(i + 1) * q_chunk]
        q_end = (i + 1) * q_chunk if causal else skv
        n_kv = -(-min(q_end, skv) // kv_chunk)
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, q_chunk), device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), device=q.device)
        for j in range(n_kv):
            k_blk = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            v_blk = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk).float()
            if causal and (j + 1) * kv_chunk - 1 > i * q_chunk:
                kpos = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
                s = s + torch.where(qpos[:, None] >= kpos[None, :], 0.0,
                                    NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_blk.dtype), v_blk)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention_block(p, cfg, x, *, impl: str = "flash", causal: bool = True,
                    norm_impl: str = "kernel", q_chunk: int = 1024,
                    kv_chunk: int = 1024):
    """Self-attention over a full sequence (prefill, or training with
    ``impl="blockwise"``).  Returns (y, (k, v))."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(p, cfg, x, positions, norm_impl)
    if impl == "flash":
        y = ops.flash_attention(q, k, v, causal=causal)
    elif impl == "dense":
        y = dense_attention(q, k, v, causal)
    elif impl == "blockwise":
        y = blockwise_attention(q, k, v, causal, q_chunk, kv_chunk)
    else:
        raise ValueError(impl)
    return output_proj(p, cfg, y), (k, v)


# ----------------------------------------------------------------- decode ----

def gather_pages(pool, page_table, positions=None):
    """(P, page, KV, D) pool -> (B, M*page, KV, D) per-slot logical rows.
    With ``positions``, table entries past each slot's live pages are
    redirected to the scratch page: their rows are masked anyway, and the
    redirect keeps a dead page's content (even NaN) out of the result."""
    b, m = page_table.shape
    page = pool.shape[1]
    pt = page_table.long()
    if positions is not None:
        live = (torch.arange(m, device=pool.device)[None, :]
                <= (positions.long() // page)[:, None])
        pt = torch.where(live, pt, torch.zeros_like(pt))
    return pool[pt].reshape(b, m * page, *pool.shape[2:])


def decode_attention(q, k_pool, v_pool, positions, page_table,
                     impl: str = "kernel"):
    """q (B, 1, KV, G, D) attends to each slot's rows 0..pos through the
    page table: ``"kernel"`` walks the table in K1, ``"gather"`` builds the
    dense gathered view (the JAX engine's default path)."""
    if impl == "kernel":
        return ops.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          positions)
    assert impl == "gather", impl
    kg = gather_pages(k_pool, page_table, positions)
    vg = gather_pages(v_pool, page_table, positions)
    s = torch.einsum("bqkgd,bskd->bkgqs", q, kg).float() / math.sqrt(
        q.shape[-1])
    valid = (torch.arange(kg.shape[1], device=q.device)[None, :]
             <= positions.long()[:, None])
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, vg)


def _scatter_paged_kv(pool, new, page_table, positions):
    """In-place paged write: slot b's token (B, 1, KV, D) lands at
    ``pool[page_table[b, pos // page], pos % page]``.  Inactive slots (all
    at position 0 behind all-zero table rows) all write row 0 of scratch
    page 0; on CUDA those duplicate writes race, which is harmless because
    no live slot ever maps page 0."""
    n_pages, page = pool.shape[:2]
    flat = pool.view(n_pages * page, *pool.shape[2:])
    pos = positions.long()
    page_ids = page_table.long().gather(1, (pos // page)[:, None])[:, 0]
    flat[page_ids * page + pos % page] = new[:, 0].to(pool.dtype)


def attention_decode_block(p, cfg, x, k_pool, v_pool, positions, page_table,
                           decode_impl: str = "kernel",
                           norm_impl: str = "kernel"):
    """One-token decode at per-slot (B,) positions.  x (B, 1, d).  The new
    K/V row is written into the pools (in place) before attending, and the
    slot attends to its own position too."""
    q, k, v = project_qkv(p, cfg, x, positions[:, None], norm_impl)
    _scatter_paged_kv(k_pool, k, page_table, positions)
    _scatter_paged_kv(v_pool, v, page_table, positions)
    y = decode_attention(q, k_pool, v_pool, positions, page_table,
                         decode_impl)
    return output_proj(p, cfg, y)
