"""RWKV6 ("Finch") blocks of the port (counterpart of the JAX
``repro.models.rwkv6``): token shift with data-dependent mixing, the WKV6
recurrence with per-channel data-dependent decay, the channel-mix FFN, and
their final states and single-step decode.

The recurrence runs ``impl="kernel"`` (K7; its plain version on CPU
tensors) or ``"plain"``: ``wkv6_chunked``, the JAX model's chunked form.
Both floor the per-step log decay at ``LOG_DECAY_FLOOR`` and split the
intra-chunk decay around the chunk midpoint, exact for chunks of at most
``CHUNK`` steps.  K7 has no initial or final state (nor has the TPU
kernel): a prefill that keeps its states runs ``wkv6_chunked``, a decode
step ``wkv6_decode``.  Two places keep JAX's mixed precision: the decay
LoRA's second matrix ``wB`` multiplies in fp32 (so it is stored fp32, see
``repro_torch.models.params``), and the ``ln_x`` group norm takes its mean
in the model dtype and its variance in fp32.  The shift states are the
last row of each block's input, the normed residual.

Under a sharding context whose model axis splits ``rwkv_heads`` (JAX's
rules), a rank holds its d/n columns of the time mix's ``wr``, ``wk``,
``wv``, ``wg`` and of ``u``'s heads, and its rows of ``wo``; the channel
mix splits ``wk`` by ``mlp`` (column parallel), ``wv`` row parallel, and
``wr`` by ``rwkv_heads``.  The token-shift mixing, the decay LoRA and
``ln_x`` stay whole on every rank: the four projections' inputs enter the
split through one ``copy_to``, and the log decay and ``ln_x``'s scale and
bias through ``tpmm.local_part`` (each rank takes its heads' columns, the
gradients summed over the group).  The recurrence runs on this rank's
heads.  The channel mix's receptance is this rank's columns, gathered
whole over the group (one all-gather; its backward takes this rank's
slice), and multiplies the reduced value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import P
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.tpmm import (col_proj_tp, down_proj_tp, local_part,
                                       tp_group)

LORA_MIX = 32
LORA_DECAY = 64
LOG_DECAY_FLOOR = -2.5     # per-step log-decay floor (w >= e^-2.5 ~ 0.082)
CHUNK = 32


def tmix_spec(cfg):
    d = cfg.d_model
    h, k = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {
        "mu_x": P((d,), init="zeros", fp32=True, axes=("embed",)),
        "mu": P((5, d), init="zeros", fp32=True, axes=(None, "embed")),
        "W1": {"kernel": P((d, 5 * LORA_MIX), axes=("embed", "lora"))},
        "W2": {"kernel": P((5, LORA_MIX, d), axes=(None, "lora", "embed"))},
        "wr": {"kernel": P((d, d), axes=("embed", "rwkv_heads"))},
        "wk": {"kernel": P((d, d), axes=("embed", "rwkv_heads"))},
        "wv": {"kernel": P((d, d), axes=("embed", "rwkv_heads"))},
        "wg": {"kernel": P((d, d), axes=("embed", "rwkv_heads"))},
        "w0": P((d,), init="rwkv_decay", fp32=True, axes=("embed",)),
        "wA": {"kernel": P((d, LORA_DECAY), axes=("embed", "lora"))},
        # JAX multiplies by wB in fp32: kept fp32 under bf16 compute
        "wB": {"kernel": P((LORA_DECAY, d), fp32=True,
                           axes=("lora", "embed"))},
        "u": P((h, k), init="normal", scale=0.3, fp32=True,
               axes=("rwkv_heads", None)),
        "ln_x": {"scale": P((d,), init="ones", fp32=True, axes=("embed",)),
                 "bias": P((d,), init="zeros", fp32=True, axes=("embed",))},
        "wo": {"kernel": P((d, d), axes=("rwkv_heads", "embed"))},
    }


def cmix_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": P((d,), init="zeros", fp32=True, axes=("embed",)),
        "mu_r": P((d,), init="zeros", fp32=True, axes=("embed",)),
        "wk": {"kernel": P((d, f), axes=("embed", "mlp"))},
        "wv": {"kernel": P((f, d), axes=("mlp", "embed"))},
        "wr": {"kernel": P((d, d), axes=("embed", "rwkv_heads"))},
    }


def _shift(x, shift_state=None):
    """The previous token's embedding: ``shift_state`` (B, 1, d), the
    previous segment's last row, at t = 0 (zeros when None)."""
    if shift_state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([shift_state.to(x.dtype), x[:, :-1]], dim=1)


def wkv6_chunked(r, k, v, lw, u, chunk: int = CHUNK, initial_state=None,
                 return_final: bool = False):
    """The JAX ``wkv6_chunked``.  r, k, lw (B, S, H, K); v (B, S, H, V);
    u (H, K); lw <= 0, floored; ``initial_state`` (B, H, K, V) fp32 (zeros
    when None).  A ragged tail is padded with steps that do nothing (decay
    1, no update).  Returns fp32 (B, S, H, V) [, the final state (B, H, K,
    V) fp32]."""
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
        s += pad
    nc = s // chunk
    rc = r.float().reshape(b, nc, chunk, h, kd)
    kc = k.float().reshape(b, nc, chunk, h, kd)
    vc = v.float().reshape(b, nc, chunk, h, vd)
    lwc = lw.float().reshape(b, nc, chunk, h, kd)

    cs = lwc.cumsum(dim=2)                  # inclusive: sum_{l<=i} lw_l
    ce = cs - lwc                           # exclusive
    mid = cs[:, :, -1:] * 0.5               # per-chunk midpoint
    qf = rc * torch.exp(torch.clamp(ce - mid, -40.0, 40.0))
    kf = kc * torch.exp(torch.clamp(mid - cs, -40.0, 40.0))
    A = torch.einsum("bcihk,bcjhk->bchij", qf, kf)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=r.device).tril(-1)
    A = torch.where(tri, A, 0.0)
    diag = torch.einsum("bcihk,hk,bcihk->bcih", rc, u.float(), kc)
    Yintra = torch.einsum("bchij,bcjhv->bcihv", A, vc) + diag[..., None] * vc

    dte = torch.exp(cs[:, :, -1:] - cs)     # decay j -> chunk end, <= 1
    chunk_kv = torch.einsum("bcjhk,bcjhv->bchkv", kc * dte, vc)
    chunk_decay = torch.exp(cs[:, :, -1])   # (b, c, h, k)
    sprev = (initial_state if initial_state is not None else
             torch.zeros((b, h, kd, vd), dtype=torch.float32,
                         device=r.device))
    starts = []
    for c in range(nc):
        starts.append(sprev)
        sprev = sprev * chunk_decay[:, c, ..., None] + chunk_kv[:, c]
    s_starts = torch.stack(starts, dim=1)   # (b, c, h, k, v)

    Yinter = torch.einsum("bcihk,bchkv->bcihv", rc * torch.exp(ce), s_starts)
    Y = (Yintra + Yinter).reshape(b, s, h, vd)[:, :s_orig]
    return (Y, sprev) if return_final else Y


def wkv6_decode(r, k, v, lw, u, state):
    """One step of the recurrence, fp32 (the JAX ``wkv6_decode``): r, k, lw
    (B, H, K); v (B, H, V); state (B, H, K, V).  Returns (out (B, H, V),
    the new state)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    a = kf[..., :, None] * vf[..., None, :]                # (B, H, K, V)
    out = torch.einsum("bhk,bhkv->bhv", rf,
                       state + u.float()[None, :, :, None] * a)
    return out, state * torch.exp(lw.float())[..., None] + a


def _mix_inputs(p, x, sx):
    """Data-dependent token-shift mixing -> inputs for [r, w, k, v, g]."""
    dtype = x.dtype
    xxx = x + sx * p["mu_x"].to(dtype)
    m = torch.tanh(xxx @ p["W1"]["kernel"].to(dtype))
    m = m.reshape(*m.shape[:-1], 5, LORA_MIX)
    m = torch.einsum("bstl,tld->bstd", m, p["W2"]["kernel"].to(dtype))
    mix = p["mu"].to(dtype)[None, None] + m              # (B, S, 5, d)
    return [x + sx * mix[:, :, t] for t in range(5)]


def log_decay(p, xw):
    """Per-channel log decay from the w-mixed input, floored: the decay
    LoRA's first product in xw's dtype, its second in fp32, as JAX."""
    dec_in = (p["w0"].float()
              + (xw @ p["wA"]["kernel"].to(xw.dtype)).float()
              @ p["wB"]["kernel"].float())
    lw = -torch.exp(torch.clamp(dec_in, -12.0, 0.0))
    return torch.clamp(lw, min=LOG_DECAY_FLOOR)


def tmix_block(p, cfg, x, *, impl: str = "kernel", shift_state=None,
               wkv_state=None, decode: bool = False,
               tp_shardmap: bool = False):
    """Time mix, x (B, S, d) -> (y (B, S, d), (the shift state x[:, -1:],
    the WKV state (B, H, K, V) fp32)), as JAX's.  ``impl``
    picks the recurrence of the full-sequence forward (``"kernel"``: K7,
    which has no state, so its WKV state is None; ``"plain"``:
    ``wkv6_chunked`` from ``wkv_state``); ``decode`` (S = 1) runs
    ``wkv6_decode`` from ``wkv_state`` (zeros when None).  ``shift_state``
    seeds the token shift.  Under a model split (see the module) H is this
    rank's heads, the WKV state's too, and the tensor-parallel reductions
    run in fp32, or with ``tp_shardmap`` in the compute dtype."""
    b, s, d = x.shape
    kd = cfg.rwkv_head_dim
    h, dl = p["u"].shape[0], p["wr"]["kernel"].shape[1]
    if dl != h * kd:
        raise ValueError(
            f"{cfg.name}: the model axis splits the {d} time-mix channels "
            f"({dl} a rank) but not the {cfg.rwkv_heads} heads, so a rank's "
            "channels are not whole heads")
    dtype = x.dtype
    psum = None if tp_shardmap else torch.float32
    g = tp_group(p["wr"]["kernel"], 1)
    sx = _shift(x, shift_state) - x
    xr, xw, xk, xv, xg = _mix_inputs(p, x, sx)
    if g is not None:
        xr, xk, xv, xg = coll.copy_to(torch.stack([xr, xk, xv, xg]), g,
                                      psum).unbind(0)

    r = xr @ p["wr"]["kernel"].to(dtype)
    kk = xk @ p["wk"]["kernel"].to(dtype)
    vv = xv @ p["wv"]["kernel"].to(dtype)
    gate = F.silu(xg @ p["wg"]["kernel"].to(dtype))
    lw = local_part(log_decay(p, xw), -1, g, psum)

    rh, kh, vh, lwh = (t.reshape(b, s, h, kd) for t in (r, kk, vv, lw))
    state = None
    if decode:
        assert s == 1, "a decode step takes one token"
        st = wkv_state if wkv_state is not None else torch.zeros(
            (b, h, kd, kd), dtype=torch.float32, device=x.device)
        out, state = wkv6_decode(rh[:, 0], kh[:, 0], vh[:, 0], lwh[:, 0],
                                 p["u"], st)
        out = out[:, None]
    elif impl == "kernel":
        if wkv_state is not None:
            raise ValueError("K7 has no initial state: a prefill from a "
                             "state runs impl='plain'")
        out = ops.rwkv6_wkv(rh, kh, vh, lwh, p["u"], chunk=CHUNK)
    else:
        assert impl == "plain", impl
        out, state = wkv6_chunked(rh, kh, vh, lwh, p["u"],
                                  initial_state=wkv_state, return_final=True)
    out = out.to(dtype)
    # per-head group norm (ln_x): mean in the model dtype, variance in fp32
    mu = out.float().mean(dim=-1, keepdim=True).to(dtype)
    var = out.float().var(dim=-1, unbiased=False, keepdim=True)
    out = ((out - mu) * torch.rsqrt(var + 64e-5).to(dtype)).reshape(b, s, dl)
    ln = p["ln_x"]
    scale, bias = (ln["scale"], ln["bias"]) if g is None else local_part(
        torch.stack([ln["scale"], ln["bias"]]), -1, g, psum).unbind(0)
    out = (out * scale.to(dtype) + bias.to(dtype)) * gate
    return (down_proj_tp(out, p["wo"]["kernel"], psum_dtype=psum),
            (x[:, -1:], state))


def cmix_block(p, cfg, x, *, shift_state=None, tp_shardmap: bool = False):
    """Channel mix, x (B, S, d) -> (y (B, S, d), the shift state
    x[:, -1:]), as JAX's.  ``shift_state`` seeds the token shift.  Under a
    model split (see the module) the key is column and the value row
    parallel, and the receptance's columns are gathered whole."""
    dtype = x.dtype
    psum = None if tp_shardmap else torch.float32
    sx = _shift(x, shift_state) - x
    xk = x + sx * p["mu_k"].to(dtype)
    xr = x + sx * p["mu_r"].to(dtype)
    kk = torch.square(F.relu(col_proj_tp(xk, p["wk"]["kernel"],
                                         psum_dtype=psum)))
    vv = down_proj_tp(kk, p["wv"]["kernel"], psum_dtype=psum)
    wr = p["wr"]["kernel"]
    rr = torch.sigmoid(col_proj_tp(xr, wr, psum_dtype=psum))
    return coll.gather_from(rr, -1, tp_group(wr, 1)) * vv, x[:, -1:]
