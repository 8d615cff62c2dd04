"""K6, the Mamba2 SSD chunked scan: ``h_t = exp(da_t) h_{t-1} + x_t b_t^T``,
``y_t = h_t c_t`` with a (P, N) fp32 state per (batch, head) row, B and C
shared by the H heads of a batch row.

Replaces the TPU kernel ``ssd_scan_bhsd`` of ``src/repro/kernels/
mamba2_ssd.py``; the CUDA source is ``src/repro_torch/csrc/mamba2_ssd.cu``,
which states what bounds it on the card and what its design does about
that.  Two modes, by dtype: bf16 on the tensor cores (``mma.sync``; P and
N multiples of 8 up to ``MAX_DIM["bf16"]``), fp32 on the CUDA cores.  The
kernel walks 64-step tiles whatever ``chunk`` is: every exponent is <= 0,
so the tile length does not change the function.  Unlike the TPU kernel,
any S is taken: the ragged tail is masked inside the kernel.

Precision: the plain version keeps every intermediate in fp32, as the TPU
kernel does.  The fp32 mode does too.  The bf16 mode rounds three fp32
intermediates to the nearest bf16 for the tensor cores: the decayed scores
G = (C B^T) o L (the operand of G X), the state S (the operand of C S^T)
and X o w (the operand of the state update); ``ssd_scan_mma_emu`` is the
plain emulation of those rounding points.

Two entry points share one launch: ``ssd_scan_bhsd`` on the public layout
x (BH, S, P), da (BH, S); and ``ssd_scan_model`` on the model layout x
(B, S, H, P), da (B, S, H), which the kernel reads and writes through
element strides, with no permute or copy.  Each launches the kernel for
CUDA tensors and runs the plain version, ``ssd_scan_ref``, for CPU
tensors; it never falls back.  On meta tensors (the dry-run) it checks
the operands as ``plan`` does and returns a meta output, computing
nothing.  Each launch and meta call reports its work to an active
``roofline.kernels`` counter.  Neither package has a backward for this
scan, so it raises on a CUDA or meta input that requires a gradient rather
than return a tensor that cuts the graph.  ``plan`` is the launch's host side as
a pure function of the tensors (tested on CPU tensors).  Both modes count
their launches in ``ssd_scan_bhsd.launches``, whichever entry launched.

Layouts: x in the model dtype, pre-scaled by dt; da fp32 (dt * A, <= 0);
b, c (B, S, N), row (b, h) reads b[b]; y like x.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.roofline import kernels as work

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# P and N: the bf16 mode pads both to 64 in shared memory; the fp32 mode's
# state and tiles must fit shared memory
MAX_DIM = {"bf16": 64, "fp32": 128}
SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
SM_SMEM = 233_472             # shared memory of an SM (228 KB)
SMEM_RESERVED = 1_024         # the runtime's share of each resident block
TILE = 64                     # steps a tile, both modes
BF16_STAGES = 3               # tiles of x, B, C, da in flight
BF16_THREADS, FP32_THREADS = 128, 256


def smem_bytes(mode: str, p: int, n: int) -> int:
    """Dynamic shared memory a launch requests (csrc
    ``mamba2_ssd_smem_bytes``)."""
    if mode == "bf16":
        mat = TILE * MAX_DIM["bf16"] * 2          # one padded bf16 tile
        stage = 3 * mat + TILE * 4                # x, B, C, da
        return BF16_STAGES * stage + 2 * mat      # + the state, twice
    return 4 * (p * (n + 1) + TILE * p + TILE * (n + 1) + TILE * n
                + TILE * TILE + 2 * TILE)


def blocks_per_sm(mode: str, p: int, n: int) -> int:
    """Blocks of a launch that shared memory lets one SM hold."""
    return SM_SMEM // (smem_bytes(mode, p, n) + SMEM_RESERVED)


@dataclasses.dataclass(slots=True)
class Plan:
    mode: str                  # "bf16" (tensor cores) or "fp32" (CUDA cores)
    b: int
    h: int
    s: int
    p: int
    n: int
    threads: int
    smem: int
    # element strides: x, y (batch, step, head); da (batch, step, head);
    # b, c (batch, step)
    x_strides: Tuple[int, ...]
    da_strides: Tuple[int, ...]
    b_strides: Tuple[int, ...]
    c_strides: Tuple[int, ...]
    y_strides: Tuple[int, ...]

    @property
    def grid(self) -> int:
        """One block per (batch, head) row, block = batch * H + head."""
        return self.b * self.h

    def strides(self) -> Tuple[int, ...]:
        return (*self.x_strides, *self.da_strides, *self.b_strides,
                *self.c_strides, *self.y_strides)


def plan(x, da, b, c, out) -> Plan:
    """The launch of the model layout x, out (B, S, H, P), da (B, S, H),
    b, c (B, S, N), any strides with the last dim of x, b, c, out
    contiguous.  Raises for what the kernel does not take: a dtype other
    than fp32 or bf16 (``TypeError``), P or N beyond ``MAX_DIM`` of the
    mode, shapes or dtypes that do not match, a last dim that is not
    contiguous, and in the bf16 mode (which loads rows in 16-byte chunks) a
    stride or row of x, b, c or out that is not a multiple of 16 bytes or a
    base that is not 16-byte aligned (``ValueError``; it never copies to fix
    one).  The fp32 mode reads scalars and takes any such layout."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"mamba2_ssd: unsupported dtype {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"mamba2_ssd: x {tuple(x.shape)} must be "
                         "(B, S, H, P)")
    bb, s, h, p = x.shape
    n = b.shape[-1]
    mode = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    if not (0 < p <= MAX_DIM[mode] and 0 < n <= MAX_DIM[mode] and s > 0):
        raise ValueError(f"mamba2_ssd: P={p}, N={n}, S={s}; the {mode} mode "
                         f"takes P and N in [1, {MAX_DIM[mode]}] and S "
                         "positive")
    want = {"da": (da, torch.float32, (bb, s, h)),
            "b": (b, x.dtype, (bb, s, n)), "c": (c, x.dtype, (bb, s, n)),
            "out": (out, x.dtype, (bb, s, h, p))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"mamba2_ssd: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {x.device}")

    def strides(t, dims, rows=True):
        shape, stride = t.shape, t.stride()
        # a dim of size 1 is never stepped
        st = tuple(stride[i] if shape[i] > 1 else 0 for i in dims)
        if not rows:
            return st
        if shape[-1] > 1 and stride[-1] != 1:
            raise ValueError("mamba2_ssd: the last dim of x, b, c and out "
                             "must be contiguous")
        size = t.element_size()
        if mode == "bf16" and (any(v * size % 16 for v in st)
                               or t.data_ptr() % 16 or shape[-1] * size % 16):
            raise ValueError(f"mamba2_ssd: shape {tuple(shape)}, strides "
                             f"{stride} or base {t.data_ptr():#x} not "
                             f"16-byte aligned ({t.dtype}); the kernel "
                             "loads rows in 16-byte chunks")
        return st

    return Plan(mode=mode, b=bb, h=h, s=s, p=p, n=n,
                threads=BF16_THREADS if mode == "bf16" else FP32_THREADS,
                smem=smem_bytes(mode, p, n),
                x_strides=strides(x, (0, 1, 2)),
                da_strides=strides(da, (0, 1, 2), rows=False),
                b_strides=strides(b, (0, 1)), c_strides=strides(c, (0, 1)),
                y_strides=strides(out, (0, 1, 2)))


def ssd_scan_ref(x, da, b, c, *, chunk: int = 128):
    """Plain version: the TPU kernel's chunk loop, all in fp32, over chunks
    of ``min(chunk, S)`` steps; a ragged tail is padded with steps that do
    nothing (da = 0, x = b = c = 0).  Public layout x (BH, S, P)."""
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


def _bf16(v):
    return v.to(torch.bfloat16).float()


def ssd_scan_mma_emu(x, da, b, c):
    """Plain emulation of the bf16 mode's rounding points, in fp32 over the
    kernel's 64-step tiles (public layout; returns fp32 y before its own
    bf16 rounding): G into G X, the state into C S^T and X o w into the
    state update each rounded to the nearest bf16; C, B and X go in as they
    are; exp(cs) scales the fp32 product C S^T.  The tests hold it to
    ``ssd_scan_ref`` with the bound ``csrc/mamba2_ssd.cu`` states, and on
    the card hold the kernel's y to it (``tests/test_torch_gpu.py``)."""
    bh, s, p = x.shape
    h = bh // b.shape[0]
    pad = -s % TILE
    xf = F.pad(x.float(), (0, 0, 0, pad))
    daf = F.pad(da.float(), (0, pad))
    bf = F.pad(b.float(), (0, 0, 0, pad)).repeat_interleave(h, dim=0)
    cf = F.pad(c.float(), (0, 0, 0, pad)).repeat_interleave(h, dim=0)
    state = x.new_zeros((bh, p, b.shape[-1]), dtype=torch.float32)
    tri = torch.ones(TILE, TILE, dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, s + pad, TILE):
        xc, dac = xf[:, t0:t0 + TILE], daf[:, t0:t0 + TILE]
        bc, cc = bf[:, t0:t0 + TILE], cf[:, t0:t0 + TILE]
        cs = dac.cumsum(dim=1)
        g = torch.where(tri, cc @ bc.transpose(1, 2)
                        * torch.exp(cs[:, :, None] - cs[:, None, :]), 0.0)
        y = cc @ _bf16(state).transpose(1, 2) * torch.exp(cs)[..., None]
        ys.append(y + _bf16(g) @ xc)
        xw = _bf16(xc * torch.exp(cs[:, -1:] - cs)[..., None])
        state = (state * torch.exp(cs[:, -1])[:, None, None]
                 + xw.transpose(1, 2) @ bc)
    return torch.cat(ys, dim=1)[:, :s]


def _launch(x, da, b, c, out) -> None:
    """Launch K6 on model-layout views (see ``plan``) into ``out``."""
    _build.refuse_autograd("ssd_scan_bhsd", x, da, b, c)
    p = plan(x, da, b, c, out)
    work.report("ssd_scan_bhsd", work.ssd_scan, x, da, b, c)
    if x.device.type == "meta":
        return
    strides = (ctypes.c_longlong * 13)(*p.strides())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with _build.on_device(x.device):
        rc = _build.entry("mamba2_ssd_launch")(
            _DTYPES[x.dtype], x.data_ptr(), da.data_ptr(), b.data_ptr(),
            c.data_ptr(), out.data_ptr(), p.b, p.h, p.s, p.p, p.n, strides,
            stream)
    _build.check(rc, f"ssd_scan ({p.mode} mode)")
    ssd_scan_bhsd.launches += 1


def _device(x) -> str:
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan_bhsd: no kernel for {x.device}")
    return x.device.type


def bhsd_views(x, da, out, h: int):
    """The public layout as model-layout views, no copy: x, out (B*H, S, P)
    -> (B, S, H, P); da (B*H, S) -> (B, S, H)."""
    def view(t):
        return t.unflatten(0, (t.shape[0] // h, h)).transpose(1, 2)

    return view(x), view(da), view(out)


def ssd_scan_bhsd(x, da, b, c, *, chunk: int = 128):
    """The SSD scan on the public layout x (BH, S, P), da (BH, S), b, c
    (B, S, N); returns y (BH, S, P)."""
    if _device(x) == "cpu":
        return ssd_scan_ref(x, da, b, c, chunk=chunk)
    bh, bb = x.shape[0], b.shape[0]
    if bh % bb:
        raise ValueError(f"ssd_scan_bhsd: {bh} rows are not a multiple of "
                         f"{bb} batch rows of B/C")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    xv, dv, ov = bhsd_views(x, da, out, bh // bb)
    _launch(xv, dv, b, c, ov)
    return out


def ssd_scan_model(x, da, b, c, *, chunk: int = 128):
    """The SSD scan on the model layout x (B, S, H, P), da (B, S, H), b, c
    (B, S, N); returns y (B, S, H, P), contiguous on the card."""
    if _device(x) == "cpu":
        bb, s, h, p = x.shape
        y = ssd_scan_ref(x.permute(0, 2, 1, 3).reshape(bb * h, s, p),
                         da.permute(0, 2, 1).reshape(bb * h, s), b, c,
                         chunk=chunk)
        return y.reshape(bb, h, s, p).permute(0, 2, 1, 3)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(x, da, b, c, out)
    return out


ssd_scan_bhsd.launches = 0
