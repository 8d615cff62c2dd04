"""K6, the Mamba2 SSD chunked scan: ``h_t = exp(da_t) h_{t-1} + x_t b_t^T``,
``y_t = h_t c_t`` with a (P, N) fp32 state per (batch, head) row, B and C
shared by the H heads of a batch row.

Replaces the TPU kernel ``ssd_scan_bhsd`` of ``src/repro/kernels/
mamba2_ssd.py``; the CUDA source is ``src/repro_torch/csrc/mamba2_ssd.cu``,
which states what bounds it on the card and what its design does about
that.  The kernel walks 64-step tiles whatever ``chunk`` is: every exponent
is <= 0, so the tile length does not change the function.  Unlike the TPU
kernel, any S is taken: the ragged tail is masked inside the kernel.

``ssd_scan_bhsd`` launches the kernel for CUDA tensors and runs the plain
version, ``ssd_scan_ref``, for CPU tensors; it never falls back.  Neither
package has a backward for this scan, so it raises on a CUDA input that
requires a gradient rather than return a tensor that cuts the graph.

Layouts: x (BH, S, P) in the model dtype, pre-scaled by dt; da (BH, S) fp32
(dt * A, <= 0); b, c (B, S, N), row bh reads b[bh // H]; y (BH, S, P) like x.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128          # P and N: the state and tiles must fit shared memory


def ssd_scan_ref(x, da, b, c, *, chunk: int = 128):
    """Plain version: the TPU kernel's chunk loop, all in fp32, over chunks
    of ``min(chunk, S)`` steps; a ragged tail is padded with steps that do
    nothing (da = 0, x = b = c = 0)."""
    bh, s, p = x.shape
    h = bh // b.shape[0]
    q = min(chunk, s)
    pad = -s % q
    xf = F.pad(x.float(), (0, 0, 0, pad))
    daf = F.pad(da.float(), (0, pad))
    bf = F.pad(b.float(), (0, 0, 0, pad)).repeat_interleave(h, dim=0)
    cf = F.pad(c.float(), (0, 0, 0, pad)).repeat_interleave(h, dim=0)
    state = x.new_zeros((bh, p, b.shape[-1]), dtype=torch.float32)
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, s + pad, q):
        xc, dac = xf[:, t0:t0 + q], daf[:, t0:t0 + q]
        bc, cc = bf[:, t0:t0 + q], cf[:, t0:t0 + q]
        cs = dac.cumsum(dim=1)                                  # (bh, q)
        decay = torch.where(tri, torch.exp(cs[:, :, None] - cs[:, None, :]),
                            0.0)
        y = (cc @ bc.transpose(1, 2) * decay) @ xc
        y = y + (cc * torch.exp(cs)[..., None]) @ state.transpose(1, 2)
        ys.append(y)
        d2e = torch.exp(cs[:, -1:] - cs)
        state = (state * torch.exp(cs[:, -1])[:, None, None]
                 + xc.transpose(1, 2) @ (bc * d2e[..., None]))
    return torch.cat(ys, dim=1)[:, :s].to(x.dtype)


def ssd_scan_bhsd(x, da, b, c, *, chunk: int = 128):
    """The SSD scan; see the module docstring for layouts."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, da, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bhsd: no kernel for {x.device}")
    _build.refuse_autograd("ssd_scan_bhsd", x, da, b, c)
    bh, s, p = x.shape
    bb, _, n = b.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan_bhsd: unsupported dtype {x.dtype}")
    if bh % bb:
        raise ValueError(f"ssd_scan_bhsd: {bh} rows are not a multiple of "
                         f"{bb} batch rows of B/C")
    if not (0 < p <= MAX_DIM and 0 < n <= MAX_DIM and s > 0):
        raise ValueError(f"ssd_scan_bhsd: P={p}, N={n}, S={s}; P and N must "
                         f"be in [1, {MAX_DIM}] and S positive")
    want = {"da": (da, torch.float32, (bh, s)), "b": (b, x.dtype, (bb, s, n)),
            "c": (c, x.dtype, (bb, s, n))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan_bhsd: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {x.device}")
    x, da, b, c = (t.contiguous() for t in (x, da, b, c))
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with _build.on_device(x.device):
        rc = _build.entry("mamba2_ssd_launch")(
            _DTYPES[x.dtype], x.data_ptr(), da.data_ptr(), b.data_ptr(),
            c.data_ptr(), out.data_ptr(), bh, bh // bb, s, p, n, stream)
    _build.check(rc, "ssd_scan_bhsd")
    ssd_scan_bhsd.launches += 1
    return out


ssd_scan_bhsd.launches = 0
