"""Mamba2 block of the port (counterpart of the JAX ``repro.models.mamba2``):
the full-sequence forward, its final conv and SSM states, and the exact
single-step decode recurrence.

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
after it is a view.  K6 has no initial or final state (nor has the TPU
kernel): a prefill that keeps its states runs ``ssd_chunked``.  The
depthwise conv is shift-and-add in the model dtype, as in JAX (an fp32
``F.conv1d`` on the card would go through cuDNN in TF32).

Under a sharding context whose model axis splits ``mamba_inner`` and
``mamba_heads`` (JAX's ``mamba_spec`` rules), a rank holds its d_inner/n
channels of ``wz``, ``wx``, ``conv_x`` and the norm scale, its H/n heads
of ``wdt``, ``A_log``, ``D`` and ``dt_bias``, and its rows of ``wo``; the
B/C path (``wB``, ``wC``, ``conv_B``, ``conv_C``) is whole on every rank.
The in-projections read x through one ``copy_to``, B and C enter the
split heads through one ``copy_to`` (every head reads them), the scan runs
on this rank's heads, the gated RMSNorm reduces each row's sum of squares
over the group (``tpmm.split_rms_norm``: K3 never runs on a part of a
row), and ``wo`` is row parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import P, rms_norm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.tpmm import down_proj_tp, split_rms_norm, tp_group


def mamba_spec(cfg):
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_dim
    return {
        "wz": {"kernel": P((d, din), axes=("embed", "mamba_inner"))},
        "wx": {"kernel": P((d, din), axes=("embed", "mamba_inner"))},
        "wB": {"kernel": P((d, n), axes=("embed", "state"))},
        "wC": {"kernel": P((d, n), axes=("embed", "state"))},
        "wdt": {"kernel": P((d, h), axes=("embed", "mamba_heads"))},
        "conv_x": P((w, din), init="uniform_conv",
                    axes=("conv", "mamba_inner")),
        "conv_B": P((w, n), init="uniform_conv", axes=("conv", "state")),
        "conv_C": P((w, n), init="uniform_conv", axes=("conv", "state")),
        "A_log": P((h,), init="a_log", fp32=True, axes=("mamba_heads",)),
        "D": P((h,), init="ones", fp32=True, axes=("mamba_heads",)),
        "dt_bias": P((h,), init="dt_bias", fp32=True,
                     axes=("mamba_heads",)),
        "norm": {"scale": P((din,), init="ones", fp32=True,
                            axes=("mamba_inner",))},
        "wo": {"kernel": P((din, d), axes=("mamba_inner", "embed"))},
    }


def _causal_conv(x, kernel, state=None):
    """Depthwise causal conv by shift-and-add in x's dtype.  x (B, S, C);
    kernel (w, C); ``state`` (B, w-1, C), the previous segment's last
    inputs (zeros when None).  Returns (y, the new state: the last w-1
    rows of the padded input)."""
    w = kernel.shape[0]
    s = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, w - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    kernel = kernel.to(x.dtype)
    y = xp[:, 0:s] * kernel[0]
    for i in range(1, w):
        y = y + xp[:, i:i + s] * kernel[i]
    return y, xp[:, xp.shape[1] - (w - 1):]


def _segsum_decay(dac):
    """dac (B, NC, Q, H) fp32 -> (pairwise decay exp(cs_i - cs_j) for
    j <= i, else 0, as (B, NC, Q_i, Q_j, H); cs).  Every kept exponent is
    <= 0.  The mask is applied before the exponential (-inf above the
    diagonal, whose exp is 0): JAX exponentiates the whole square and masks
    after, which gives the same values, but above the diagonal cs_i - cs_j
    > 0 overflows fp32 at full width (|dA| summed over a 256-step chunk
    passes 88), and exp's backward then multiplies the mask's zero gradient
    by inf: NaN gradients."""
    cs = dac.cumsum(dim=2)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    q = dac.shape[2]
    mask = torch.ones(q, q, dtype=torch.bool, device=dac.device).tril()
    return torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                 -torch.inf)), cs


def ssd_chunked(X, dA, Bm, Cm, chunk: int, initial_state=None,
                return_final: bool = False):
    """The JAX ``ssd_chunked``.  X (B, S, H, P) dt-scaled; dA (B, S, H) =
    dt * A <= 0; Bm, Cm (B, S, N); ``initial_state`` (B, H, P, N) fp32
    (zeros when None).  A ragged tail is padded with steps that do nothing
    (decay 1, no update), so the final state is the last real step's.
    Returns Y (B, S, H, P) [, the final state (B, H, P, N) fp32]."""
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
    hprev = (initial_state if initial_state is not None else
             torch.zeros((b, h, p, n), dtype=torch.float32, device=X.device))
    starts = []
    for c in range(nc):
        starts.append(hprev)
        hprev = (hprev * chunk_decay[:, c, :, None, None]
                 + states[:, c].float())
    h_starts = torch.stack(starts, dim=1)                      # (b,c,h,p,n)

    Yoff = torch.einsum("bcin,bcih,bchpn->bcihp", Cc,
                        torch.exp(cs).to(dtype), h_starts.to(dtype))
    Y = (Ydiag + Yoff).reshape(b, s, h, p)[:, :s_orig]
    return (Y, hprev) if return_final else Y


def mamba_block(p, cfg, x, *, impl: str = "kernel", norm_impl: str = "kernel",
                conv_state=None, ssm_state=None, decode: bool = False,
                tp_shardmap: bool = False):
    """x (B, S, d) -> (y (B, S, d), (conv state, SSM state)), as JAX's.
    The conv state (B, w-1, d_inner + 2N) comes in concatenated, as a
    cache holds it, and goes out as its three slices (x, B, C) in x's
    dtype, concatenated by the caller that keeps it; the SSM state is
    (B, H, P, N) fp32.  ``impl`` picks the SSD scan of the full-sequence forward
    (``"kernel"``: K6, which has no state, so its SSM state is None;
    ``"plain"``: ``ssd_chunked`` from ``ssm_state``), ``norm_impl`` the
    gated RMSNorm (K3 or its plain version).  ``decode`` (S = 1) runs
    JAX's exact single-step recurrence from ``conv_state``/``ssm_state``
    (zeros when None): the state update and readout in fp32, Y cast to the
    model dtype.  Weights are cast to x's dtype at each use, as JAX casts
    its fp32 masters.

    Under a model split (see the module) d_inner and H are this rank's
    (the states too: the conv state's x slice and the SSM state hold its
    channels and heads), and the tensor-parallel reductions run in fp32,
    or with ``tp_shardmap`` in the compute dtype (``parallel.tpmm``)."""
    b, s, d = x.shape
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    din, h = p["wx"]["kernel"].shape[1], p["A_log"].shape[0]
    if din != h * pdim:
        raise ValueError(
            f"{cfg.name}: the model axis splits d_inner ({cfg.d_inner} -> "
            f"{din} a rank) but not the {cfg.ssm_heads} SSM heads, so a "
            "rank's channels are not whole heads")
    dtype = x.dtype
    psum = None if tp_shardmap else torch.float32
    g = tp_group(p["wx"]["kernel"], 1)
    xt = coll.copy_to(x, g, psum)

    def proj(t, name):
        return t @ p[name]["kernel"].to(dtype)

    z, xs, dt = (proj(xt, k) for k in ("wz", "wx", "wdt"))
    Bm, Cm = proj(x, "wB"), proj(x, "wC")
    cs = ((None,) * 3 if conv_state is None else
          (conv_state[..., :din], conv_state[..., din:din + n],
           conv_state[..., din + n:]))
    xs, cs_x = _causal_conv(xs, p["conv_x"], cs[0])
    Bm, cs_b = _causal_conv(Bm, p["conv_B"], cs[1])
    Cm, cs_c = _causal_conv(Cm, p["conv_C"], cs[2])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)
    if g is not None:
        # whole on every rank and read by each rank's heads
        bc = coll.copy_to(torch.cat([Bm, Cm], dim=-1), g, psum)
        Bm, Cm = bc[..., :n], bc[..., n:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())         # (B, S, H)
    dA = dt * -torch.exp(p["A_log"].float())                   # <= 0
    X = xs.reshape(b, s, h, pdim)
    Xdt = X * dt[..., None].to(dtype)
    final = None
    if decode:
        assert s == 1, "a decode step takes one token"
        st = ssm_state if ssm_state is not None else torch.zeros(
            (b, h, pdim, n), dtype=torch.float32, device=x.device)
        upd = torch.einsum("bn,bhp->bhpn", Bm[:, 0].float(),
                           Xdt[:, 0].float())
        final = st * torch.exp(dA[:, 0])[:, :, None, None] + upd
        Y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(),
                         final)[:, None].to(dtype)
    elif impl == "kernel":
        if ssm_state is not None:
            raise ValueError("K6 has no initial state: a prefill from a "
                             "state runs impl='plain'")
        Y = ops.mamba2_ssd(Xdt, dA, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        assert impl == "plain", impl
        Y, final = ssd_chunked(Xdt, dA, Bm, Cm, cfg.ssm_chunk,
                               initial_state=ssm_state, return_final=True)
    Y = Y + p["D"].to(dtype)[None, None, :, None] * X
    Y = Y.reshape(b, s, din) * F.silu(z)
    if g is None:
        Y = rms_norm(Y, p["norm"]["scale"], cfg.norm_eps, norm_impl)
    else:
        Y = split_rms_norm(Y, p["norm"]["scale"], cfg.norm_eps, g)
    out = down_proj_tp(Y, p["wo"]["kernel"], psum_dtype=psum)
    return out, ((cs_x, cs_b, cs_c), final)
