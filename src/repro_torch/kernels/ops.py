"""Model-layout wrappers around the port's kernels, and their launch counts.

Model code calls these; each reshapes to its kernel's layout and back
(K2, K6 and K7 read and write the model layout themselves, through
strides).
On a CPU tensor the kernel module runs its plain version, on a meta tensor
(the dry-run) its meta path, on a CUDA tensor it launches the kernel
(``repro_torch.kernels.{flash_attention,paged_decode,
rmsnorm,softmax_xent,adamw_update,mamba2_ssd,rwkv6_wkv}``).  ``launch_counts()`` reads how often
each kernel was launched; a launch is counted only where a kernel actually
runs, never for a plain version.  K2 counts its two modes apart:
``flash_attention_bhsd`` (bf16, tensor cores) and ``flash_attention_bhsd_fp32``
(fp32, CUDA cores).  A CUDA graph keeps the meaning: the wrapper calls made
while it is captured launch nothing and are taken back out
(``launches_recorded``), and each replay adds the counts recorded at
capture (``count_replay``).
"""
from __future__ import annotations

import contextlib
from typing import Dict

from repro_torch.kernels.adamw_update import adamw_fused
from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                 flash_attention_model,
                                                 fp32_mode)
from repro_torch.kernels.mamba2_ssd import ssd_scan_bhsd, ssd_scan_model
from repro_torch.kernels.paged_decode import (
    paged_flash_decode, paged_flash_decode_int8, paged_flash_decode_partials,
    paged_flash_decode_partials_int8)
from repro_torch.kernels.rmsnorm import rmsnorm_rows
from repro_torch.kernels.rwkv6_wkv import wkv6_scan_bhsd, wkv6_scan_model
from repro_torch.kernels.softmax_xent import (SoftmaxXent, softmax_xent_bwd,
                                              softmax_xent_fwd)

KERNELS = {"paged_flash_decode": paged_flash_decode,
           "paged_flash_decode_int8": paged_flash_decode_int8,
           "paged_flash_decode_partials": paged_flash_decode_partials,
           "paged_flash_decode_partials_int8":
               paged_flash_decode_partials_int8,
           "flash_attention_bhsd": flash_attention_bhsd,
           "flash_attention_bhsd_fp32": fp32_mode,
           "rmsnorm_rows": rmsnorm_rows,
           "softmax_xent_fwd": softmax_xent_fwd,
           "softmax_xent_bwd": softmax_xent_bwd,
           "adamw_fused": adamw_fused,
           "ssd_scan_bhsd": ssd_scan_bhsd,
           "wkv6_scan_bhsd": wkv6_scan_bhsd}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


@contextlib.contextmanager
def launches_recorded():
    """Yield a dict that receives, when the block ends, the launches counted
    inside it, which are then taken back out of the counts: wrap a CUDA
    graph's capture, which launches nothing."""
    before = launch_counts()
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name, fn in KERNELS.items():
            if fn.launches != before[name]:
                recorded[name] = fn.launches - before[name]
            fn.launches = before[name]


def count_replay(recorded: Dict[str, int]) -> None:
    """Count the kernels one replay of a CUDA graph ran: ``recorded`` from
    ``launches_recorded`` around its capture."""
    for name, n in recorded.items():
        KERNELS[name].launches += n


# q (B, S, KV, G, D); k, v (B, S, KV, D) -> (B, S, KV, G, D), contiguous on
# the card, so ``output_proj`` reshapes it as a view: K2 takes the model
# layout as it is
flash_attention = flash_attention_model


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


def paged_decode_partials(q, k_pool, v_pool, page_table, positions,
                          page_offset: int, k_scale=None, v_scale=None):
    """One pool shard's share of a sharded paged decode: q (B, 1, KV, G, D);
    pools the shard's (P_local, page, KV, D) pages, ``page_offset`` the
    global id of its first page; page_table (B, M) of GLOBAL ids, entries
    outside the shard skipped like dead pages; with int8 pools, the shard's
    ``k_scale``/``v_scale`` (P_local, page, KV) fp32.  Returns the raw fp32
    triple ``(acc (B, 1, KV, G, D), l (B, KV, G), m (B, KV, G))``, merged
    across shards by ``attention.merge_paged_partials``."""
    assert q.shape[1] == 1, q.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_partials: k_scale and v_scale go "
                         "together")
    q = q[:, 0].contiguous()
    if k_scale is None:
        acc, l, m = paged_flash_decode_partials(q, k_pool, v_pool, page_table,
                                                positions, page_offset)
    else:
        acc, l, m = paged_flash_decode_partials_int8(
            q, k_pool, v_pool, k_scale, v_scale, page_table, positions,
            page_offset)
    return acc[:, None], l, m


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


# x (B, S, H, P) pre-scaled by dt; da (B, S, H) fp32; b, c (B, S, N) ->
# (B, S, H, P), contiguous on the card, so ``mamba_block`` reshapes it as a
# view: K6 takes the model layout as it is.  Both of K6's modes count in
# ``ssd_scan_bhsd``.
mamba2_ssd = ssd_scan_model


# r, k, lw (B, S, H, K), v (B, S, H, V); lw fp32, u (H, K) fp32 -> (B, S,
# H, V) like r, contiguous on the card, so ``tmix_block`` reshapes it as a
# view: K7 takes the model layout as it is.  Both of K7's modes count in
# ``wkv6_scan_bhsd``.
rwkv6_wkv = wkv6_scan_model
