"""K7, the RWKV6 WKV chunked recurrence: ``S_t = diag(w_t) S_{t-1} + k_t
v_t^T``, ``o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)`` with a (K, V) fp32
state per (batch, head) row and ``lw = log w``.

Replaces the TPU kernel ``wkv6_scan_bhsd`` of ``src/repro/kernels/
rwkv6_wkv.py``; the CUDA source is ``src/repro_torch/csrc/rwkv6_wkv.cu``,
which states what bounds it on the card and what its design does about
that.  Both keep the TPU kernel's rank-1 split of the intra-chunk decay
around the chunk midpoint, each factor clipped to [-40, 40]: exact only
because the model floors the per-step log decay at -2.5 and a chunk is at
most ``MAX_CHUNK`` = 32 steps, so a longer chunk is refused.  Unlike the TPU
kernel, any S is taken: the ragged tail is masked inside the kernel.

``wkv6_scan_bhsd`` launches the kernel for CUDA tensors and runs the plain
version, ``wkv6_scan_ref``, for CPU tensors; it never falls back.  Neither
package has a backward for this recurrence, so it raises on a CUDA input
that requires a gradient rather than return a tensor that cuts the graph.

Layouts: r, k (BH, S, K) and v (BH, S, V) in the model dtype; lw (BH, S, K)
fp32 in [-2.5, 0]; u (H, K) fp32, row bh reads u[bh % H]; y (BH, S, V)
like r.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 32         # 32 steps x 2.5 / 2 = 40, the clip of the split
MAX_DIM = 128          # K and V: the state and tiles must fit shared memory


def _chunk(chunk: int, s: int) -> int:
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6 chunk {chunk}: the rank-1 decay split is "
                         f"exact only for chunks of 1..{MAX_CHUNK} steps")
    return min(chunk, s)


def wkv6_scan_ref(r, k, v, lw, u, *, chunk: int = MAX_CHUNK):
    """Plain version: the TPU kernel's chunk loop, all in fp32, over chunks
    of ``min(chunk, S)`` steps; a ragged tail is padded with steps that do
    nothing (lw = 0, r = k = v = 0)."""
    bh, s, kd = r.shape
    vd = v.shape[-1]
    q = _chunk(chunk, s)
    pad = -s % q
    rf, kf, lwf = (F.pad(t.float(), (0, 0, 0, pad)) for t in (r, k, lw))
    vf = F.pad(v.float(), (0, 0, 0, pad))
    uf = u.float().repeat(bh // u.shape[0], 1)[:, None, :]     # (bh, 1, K)
    state = r.new_zeros((bh, kd, vd), dtype=torch.float32)
    lower = torch.ones(q, q, dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for t0 in range(0, s + pad, q):
        rc, kc, vc = rf[:, t0:t0 + q], kf[:, t0:t0 + q], vf[:, t0:t0 + q]
        lwc = lwf[:, t0:t0 + q]
        cs = lwc.cumsum(dim=1)
        ce = cs - lwc
        mid = cs[:, -1:] * 0.5
        qf = rc * torch.exp(torch.clamp(ce - mid, -40.0, 40.0))
        kfac = kc * torch.exp(torch.clamp(mid - cs, -40.0, 40.0))
        a = torch.where(lower, qf @ kfac.transpose(1, 2), 0.0)
        diag = (rc * uf * kc).sum(dim=-1, keepdim=True)
        y = a @ vc + diag * vc + (rc * torch.exp(ce)) @ state
        ys.append(y)
        state = (state * torch.exp(cs[:, -1])[..., None]
                 + (kc * torch.exp(cs[:, -1:] - cs)).transpose(1, 2) @ vc)
    return torch.cat(ys, dim=1)[:, :s].to(r.dtype)


def wkv6_scan_bhsd(r, k, v, lw, u, *, chunk: int = MAX_CHUNK):
    """The WKV recurrence; see the module docstring for layouts."""
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, lw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan_bhsd: no kernel for {r.device}")
    _build.refuse_autograd("wkv6_scan_bhsd", r, k, v, lw, u)
    bh, s, kd = r.shape
    vd, h = v.shape[-1], u.shape[0]
    if r.dtype not in _DTYPES:
        raise TypeError(f"wkv6_scan_bhsd: unsupported dtype {r.dtype}")
    if not (0 < kd <= MAX_DIM and 0 < vd <= MAX_DIM and s > 0):
        raise ValueError(f"wkv6_scan_bhsd: K={kd}, V={vd}, S={s}; K and V "
                         f"must be in [1, {MAX_DIM}] and S positive")
    if bh % h:
        raise ValueError(f"wkv6_scan_bhsd: {bh} rows are not a multiple of "
                         f"{h} heads of u")
    q = _chunk(chunk, s)
    want = {"k": (k, r.dtype, (bh, s, kd)), "v": (v, r.dtype, (bh, s, vd)),
            "lw": (lw, torch.float32, (bh, s, kd)),
            "u": (u, torch.float32, (h, kd))}
    for name, (t, dtype, shape) in want.items():
        if t.device != r.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"wkv6_scan_bhsd: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {r.device}")
    r, k, v, lw, u = (t.contiguous() for t in (r, k, v, lw, u))
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with _build.on_device(r.device):
        rc = _build.entry("rwkv6_wkv_launch")(
            _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), u.data_ptr(), out.data_ptr(), bh, h, s, kd, vd, q,
            stream)
    _build.check(rc, "wkv6_scan_bhsd")
    wkv6_scan_bhsd.launches += 1
    return out


wkv6_scan_bhsd.launches = 0
