"""Mamba2 block of the port, forward only (counterpart of the JAX
``repro.models.mamba2`` without its decode step and final states).

The SSD scan runs ``impl="kernel"`` (K6; its plain version on CPU tensors)
or ``"plain"``: ``ssd_chunked``, the JAX model's chunked form, which rounds
the intra-chunk mixing matrix, the decays and the chunk start states to the
model dtype where JAX does.  In bf16 the two are therefore different
functions, as JAX's ``"pallas"`` and ``"xla"`` paths are: the TPU kernel
keeps every intermediate in fp32, and K6's bf16 mode rounds three of them
(the decayed scores, the state as an operand of C S^T, X o w) to bf16 for
the tensor cores, which moves the fp32 scan's output by ~7e-3 at zamba2's
eval shape before its own rounding (``kernels/mamba2_ssd.py``).  K6
returns Y in the model layout, contiguous on the card, so the reshape
after it is a view.  The depthwise conv is
shift-and-add in the model dtype, as in JAX (an fp32 ``F.conv1d`` on the
card would go through cuDNN in TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import P, rms_norm


def mamba_spec(cfg):
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_dim
    return {
        "wz": {"kernel": P((d, din))},
        "wx": {"kernel": P((d, din))},
        "wB": {"kernel": P((d, n))},
        "wC": {"kernel": P((d, n))},
        "wdt": {"kernel": P((d, h))},
        "conv_x": P((w, din), init="uniform_conv"),
        "conv_B": P((w, n), init="uniform_conv"),
        "conv_C": P((w, n), init="uniform_conv"),
        "A_log": P((h,), init="a_log", fp32=True),
        "D": P((h,), init="ones", fp32=True),
        "dt_bias": P((h,), init="dt_bias", fp32=True),
        "norm": {"scale": P((din,), init="ones", fp32=True)},
        "wo": {"kernel": P((din, d))},
    }


def _causal_conv(x, kernel):
    """Depthwise causal conv by shift-and-add in x's dtype.  x (B, S, C);
    kernel (w, C)."""
    w = kernel.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    kernel = kernel.to(x.dtype)
    y = xp[:, 0:s] * kernel[0]
    for i in range(1, w):
        y = y + xp[:, i:i + s] * kernel[i]
    return y


def _segsum_decay(dac):
    """dac (B, NC, Q, H) fp32 -> (pairwise decay exp(cs_i - cs_j) for
    j <= i, else 0, as (B, NC, Q_i, Q_j, H); cs).  Every kept exponent is
    <= 0."""
    cs = dac.cumsum(dim=2)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    q = dac.shape[2]
    mask = torch.ones(q, q, dtype=torch.bool, device=dac.device).tril()
    return torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0), cs


def ssd_chunked(X, dA, Bm, Cm, chunk: int):
    """The JAX ``ssd_chunked`` (no initial or final state).  X (B, S, H, P)
    dt-scaled; dA (B, S, H) = dt * A <= 0; Bm, Cm (B, S, N).  A ragged tail
    is padded with steps that do nothing.  Returns Y (B, S, H, P)."""
    b, s, h, p = X.shape
    n = Bm.shape[-1]
    dtype = X.dtype
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        X = F.pad(X, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        s += pad
    nc = s // chunk
    Xc = X.reshape(b, nc, chunk, h, p)
    dAc = dA.float().reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    L, cs = _segsum_decay(dAc)                                 # (b,c,i,j,h)
    att = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = att[..., None] * L
    Ydiag = torch.einsum("bcijh,bcjhp->bcihp", M.to(dtype), Xc)

    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)            # (b,c,j,h)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc,
                          decay_to_end.to(dtype), Xc)          # (b,c,h,p,n)
    chunk_decay = torch.exp(cs[:, :, -1, :])                   # (b,c,h)
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32, device=X.device)
    starts = []
    for c in range(nc):
        starts.append(hprev)
        hprev = (hprev * chunk_decay[:, c, :, None, None]
                 + states[:, c].float())
    h_starts = torch.stack(starts, dim=1)                      # (b,c,h,p,n)

    Yoff = torch.einsum("bcin,bcih,bchpn->bcihp", Cc,
                        torch.exp(cs).to(dtype), h_starts.to(dtype))
    return (Ydiag + Yoff).reshape(b, s, h, p)[:, :s_orig]


def mamba_block(p, cfg, x, *, impl: str = "kernel", norm_impl: str = "kernel"):
    """x (B, S, d) -> (B, S, d), the full-sequence forward.  ``impl`` picks
    the SSD scan (``"kernel"``: K6; ``"plain"``: ``ssd_chunked``),
    ``norm_impl`` the gated RMSNorm (K3 or its plain version).  Weights are
    cast to x's dtype at each use, as JAX casts its fp32 masters."""
    b, s, d = x.shape
    din, h, pdim = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    dtype = x.dtype

    def proj(name):
        return x @ p[name]["kernel"].to(dtype)

    z, xs, Bm, Cm, dt = (proj(k) for k in ("wz", "wx", "wB", "wC", "wdt"))
    xs = F.silu(_causal_conv(xs, p["conv_x"]))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"]))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"]))

    dt = F.softplus(dt.float() + p["dt_bias"].float())         # (B, S, H)
    dA = dt * -torch.exp(p["A_log"].float())                   # <= 0
    X = xs.reshape(b, s, h, pdim)
    Xdt = X * dt[..., None].to(dtype)
    if impl == "kernel":
        Y = ops.mamba2_ssd(Xdt, dA, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        assert impl == "plain", impl
        Y = ssd_chunked(Xdt, dA, Bm, Cm, cfg.ssm_chunk)
    Y = Y + p["D"].to(dtype)[None, None, :, None] * X
    Y = Y.reshape(b, s, din)
    Y = rms_norm(Y * F.silu(z), p["norm"]["scale"], cfg.norm_eps, norm_impl)
    return Y @ p["wo"]["kernel"].to(dtype)
