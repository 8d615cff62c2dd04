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

Two modes, by dtype: bf16 on the tensor cores (``mma.sync``; K and V
multiples of 8 up to 128), fp32 on the CUDA cores (K and V in 1..128).
Both split the state over V: a block owns ``Plan.vs`` columns of one
row's state, chosen from the shapes alone.  The bf16 mode walks 32-step
tiles whatever ``chunk`` (<= 32) is: at the -2.5 floor every factor stays
inside the clip, so the tile length does not change the function; the
fp32 mode walks chunks of ``min(chunk, S)`` steps, as the plain version.

Precision: the plain version keeps every intermediate in fp32, as the TPU
kernel does.  The fp32 mode does too.  The bf16 mode rounds six fp32
intermediates to the nearest bf16 for the tensor cores: qf = r e^(ce - M)
and kf = k e^(M - cs) (the operands of the scores A), A itself (strictly
lower, with the u-bonus diagonal; the operand of A v), r e^ce and the state
S (the operands of (r e^ce) S), and k e^(cs_end - cs) (the operand of the
state update); ``wkv6_scan_mma_emu`` is the plain emulation of those
rounding points and of the tile walk.

Two entry points share one launch: ``wkv6_scan_bhsd`` on the public layout
r, k, lw (BH, S, K), v (BH, S, V); and ``wkv6_scan_model`` on the model
layout r, k, lw (B, S, H, K), v (B, S, H, V), which the kernel reads and
writes through element strides, with no permute or copy.  Each launches the
kernel for CUDA tensors and runs the plain version, ``wkv6_scan_ref``, for
CPU tensors; it never falls back.  On meta tensors (the dry-run) it checks
the operands as ``plan`` does and returns a meta output, computing
nothing.  Each launch and meta call reports its work to an active
``roofline.kernels`` counter.  Neither package has a backward for this
recurrence, so it raises on a CUDA or meta input that requires a gradient
rather than return a tensor that cuts the graph.  ``plan`` is the launch's host
side as a pure function of the tensors (tested on CPU tensors).  Both modes
count their launches in ``wkv6_scan_bhsd.launches``, whichever entry
launched.

Layouts: r, k, v in the model dtype; lw fp32 in [-2.5, 0]; u (H, K) fp32,
row (b, h) reads u[h]; y like v.
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
MAX_CHUNK = 32         # 32 steps x 2.5 / 2 = 40, the clip of the split
MAX_DIM = 128          # K and V, both modes
TILE = 32              # steps a tile of the bf16 mode
SMEM_LIMIT = 232_448   # dynamic shared memory a block may use (H100)
SM_SMEM = 233_472      # shared memory of an SM (228 KB)
SMEM_RESERVED = 1_024  # the runtime's share of each resident block
SM_THREADS = 2_048     # resident threads an SM holds
SM_REGS = 65_536       # registers of an SM
BF16_STAGES = 3        # tiles of r, k, lw, v in flight
PREP_WARPS = 4         # bf16: the warps that prepare a tile
FP32_THREADS = 256
FP32_REGS = 64         # registers a thread of the fp32 kernel (ptxas -v;
                       # a cap of 64 by launch bounds measured 3% slower)


def vs_for(mode: str, vd: int) -> int:
    """State columns a block owns: bf16 16 for V <= 16, else 32 (a chain
    warp owns 16); fp32 up to 32.  From the shape alone, never the data."""
    if mode == "bf16":
        return 16 if vd <= 16 else 32
    return min(vd, 32)


def smem_bytes(mode: str, kd: int, vs: int) -> int:
    """Dynamic shared memory a launch requests (csrc
    ``rwkv6_wkv_smem_bytes``)."""
    if mode == "bf16":
        kp = 64 if kd <= 64 else 128                 # K padded
        mat = TILE * 2 * kp                          # 32 x KP bf16
        stage = 2 * mat + TILE * 4 * kp + TILE * 2 * vs   # r, k, lw, v
        fbuf = 2 * mat + TILE * TILE * 2 + 4 * kp    # rec, kw, A, dec
        return (BF16_STAGES * stage + 2 * fbuf + 2 * mat
                + 4 * PREP_WARPS * TILE)             # + qf, kf, diagonal
    return 4 * (kd * vs + 4 * TILE * kd + TILE * vs + 2 * TILE * (kd + 1)
                + TILE * TILE + TILE)


def threads(mode: str, vs: int) -> int:
    """bf16: the prep warps and one chain warp per 16 state columns."""
    return 32 * (PREP_WARPS + vs // 16) if mode == "bf16" else FP32_THREADS


def blocks_per_sm(mode: str, kd: int, vs: int) -> int:
    """Blocks of a launch that one SM holds: by shared memory, or by
    threads or (fp32) registers where those run out first.  The bf16
    kernel's launch bounds leave registers for as many blocks as its
    shared memory allows."""
    n = min(SM_SMEM // (smem_bytes(mode, kd, vs) + SMEM_RESERVED),
            SM_THREADS // threads(mode, vs))
    if mode == "fp32":
        n = min(n, SM_REGS // (FP32_REGS * FP32_THREADS))
    return n


@dataclasses.dataclass(slots=True)
class Plan:
    mode: str                  # "bf16" (tensor cores) or "fp32" (CUDA cores)
    b: int
    h: int
    s: int
    kd: int
    vd: int
    q: int                     # the chunk (the fp32 mode walks it)
    vs: int                    # state columns a block
    threads: int
    stages: int                # ring stages (the fp32 mode has no ring)
    smem: int
    blocks_per_sm: int
    # element strides (batch, step, head) of r, k, v, lw, y
    r_strides: Tuple[int, ...]
    k_strides: Tuple[int, ...]
    v_strides: Tuple[int, ...]
    lw_strides: Tuple[int, ...]
    y_strides: Tuple[int, ...]

    @property
    def slices(self) -> int:
        """Blocks a row: V split into ``vs`` columns, the last may be
        narrower."""
        return -(-self.vd // self.vs)

    @property
    def grid(self) -> int:
        """Block = (batch * H + head) * slices + slice."""
        return self.b * self.h * self.slices

    def strides(self) -> Tuple[int, ...]:
        return (*self.r_strides, *self.k_strides, *self.v_strides,
                *self.lw_strides, *self.y_strides)


def _chunk(chunk: int, s: int) -> int:
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6 chunk {chunk}: the rank-1 decay split is "
                         f"exact only for chunks of 1..{MAX_CHUNK} steps")
    return min(chunk, s)


def plan(r, k, v, lw, u, out, *, chunk: int = MAX_CHUNK) -> Plan:
    """The launch of the model layout r, k, lw (B, S, H, K), v, out
    (B, S, H, V), u (H, K), any strides with the last dim contiguous.
    Raises for what the kernel does not take: a dtype other than fp32 or
    bf16 (``TypeError``), a chunk over 32 steps, K or V outside the mode's
    range (bf16: multiples of 8 up to 128; fp32: 1..128), shapes or dtypes
    that do not match, a last dim that is not contiguous, and in the bf16
    mode (which loads rows in 16-byte chunks) a stride of r, k, v, lw or out
    that is not a multiple of 16 bytes or a base that is not 16-byte
    aligned (``ValueError``; it never copies to fix one).  The fp32 mode
    reads scalars and takes any such layout."""
    if r.dtype not in _DTYPES:
        raise TypeError(f"rwkv6_wkv: unsupported dtype {r.dtype}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv: r {tuple(r.shape)} must be "
                         "(B, S, H, K)")
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    mode = "bf16" if r.dtype == torch.bfloat16 else "fp32"
    q = _chunk(chunk, max(s, 1))
    if mode == "bf16":
        ok = all(8 <= n <= MAX_DIM and n % 8 == 0 for n in (kd, vd))
        rule = f"multiples of 8 up to {MAX_DIM}"
    else:
        ok = all(0 < n <= MAX_DIM for n in (kd, vd))
        rule = f"in [1, {MAX_DIM}]"
    if not ok or s <= 0:
        raise ValueError(f"rwkv6_wkv: K={kd}, V={vd}, S={s}; the {mode} mode "
                         f"takes K and V {rule} and S positive")
    want = {"k": (k, r.dtype, (b, s, h, kd)), "v": (v, r.dtype, (b, s, h, vd)),
            "lw": (lw, torch.float32, (b, s, h, kd)),
            "u": (u, torch.float32, (h, kd)),
            "out": (out, r.dtype, (b, s, h, vd))}
    for name, (t, dtype, shape) in want.items():
        if t.device != r.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"rwkv6_wkv: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {r.device}")

    def strides(t):
        shape, stride = t.shape, t.stride()
        # a dim of size 1 is never stepped
        st = tuple(stride[i] if shape[i] > 1 else 0 for i in range(3))
        if shape[-1] > 1 and stride[-1] != 1:
            raise ValueError("rwkv6_wkv: the last dim of r, k, v, lw and out "
                             "must be contiguous")
        size = t.element_size()
        if mode == "bf16" and (any(x * size % 16 for x in st)
                               or t.data_ptr() % 16):
            raise ValueError(f"rwkv6_wkv: shape {tuple(shape)}, strides "
                             f"{stride} or base {t.data_ptr():#x} not "
                             f"16-byte aligned ({t.dtype}); the kernel "
                             "loads rows in 16-byte chunks")
        return st

    vs = vs_for(mode, vd)
    return Plan(mode=mode, b=b, h=h, s=s, kd=kd, vd=vd, q=q, vs=vs,
                threads=threads(mode, vs),
                stages=BF16_STAGES if mode == "bf16" else 1,
                smem=smem_bytes(mode, kd, vs),
                blocks_per_sm=blocks_per_sm(mode, kd, vs),
                r_strides=strides(r), k_strides=strides(k),
                v_strides=strides(v), lw_strides=strides(lw),
                y_strides=strides(out))


def wkv6_scan_ref(r, k, v, lw, u, *, chunk: int = MAX_CHUNK):
    """Plain version: the TPU kernel's chunk loop, all in fp32, over chunks
    of ``min(chunk, S)`` steps; a ragged tail is padded with steps that do
    nothing (lw = 0, r = k = v = 0).  Public layout r (BH, S, K)."""
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


def _bf16(x):
    return x.to(torch.bfloat16).float()


LOG2E = 1.4426950408889634


def _exp(x):
    """e^x as the kernel takes it: 2^(x log2 e), in fp32."""
    return torch.exp2(x * LOG2E)


def _tile_cumsum(lwc, kd: int):
    """The inclusive cumsum of a tile's lw (bh, 32, K) in the kernel's fp32
    order, and the tile's midpoint M: each prep thread scans a segment of 8
    steps (16 where K > 64) serially, the segments' totals are scanned by
    doubling offsets, and each segment adds its exclusive prefix (the
    inclusive one less its own total)."""
    sl = (64 if kd <= 64 else 128) // (2 * PREP_WARPS)
    x = lwc.unflatten(1, (TILE // sl, sl))                # (bh, segs, sl, K)
    run, loc = torch.zeros_like(x[:, :, 0]), []
    for j in range(sl):
        run = run + x[:, :, j]
        loc.append(run)
    loc = torch.stack(loc, dim=2)
    tot = loc[:, :, -1]
    inc, off = tot, 1
    while off < TILE // sl:
        inc = torch.cat([inc[:, :off], inc[:, off:] + inc[:, :-off]], dim=1)
        off *= 2
    cs = ((inc - tot)[:, :, None] + loc).flatten(1, 2)
    return cs, 0.5 * inc[:, -1:]


def wkv6_scan_mma_emu(r, k, v, lw, u):
    """Plain emulation of the bf16 mode's rounding points and its 32-step
    tile walk, in fp32 (public layout; returns fp32 y before its own bf16
    rounding): qf and kf into A, A (masked, with the u-bonus diagonal) into
    A v, r e^ce and the state into (r e^ce) S, and k e^(cs_end - cs) into
    the state update, each rounded to the nearest bf16; r, k, v go in as
    they are; e^M scales qf and kf in fp32 into r e^ce and k e^(cs_end -
    cs), and (e^M)^2 is the state's decay.  The cumsums follow the kernel's
    order of additions and the exponentials its 2^(x log2 e): at |cs| up to
    80 an fp32 unit of cs moves a factor by ~8e-6 of itself, which flips
    its bf16 rounding often enough to show in y.  The tests hold it to
    ``wkv6_scan_ref``, and on the card hold the kernel's y to it
    (``tests/test_torch_gpu.py``)."""
    bh, s, kd = r.shape
    vd = v.shape[-1]
    pad = -s % TILE
    rf, kf, lwf = (F.pad(t.float(), (0, 0, 0, pad)) for t in (r, k, lw))
    vf = F.pad(v.float(), (0, 0, 0, pad))
    uf = u.float().repeat(bh // u.shape[0], 1)[:, None, :]
    state = r.new_zeros((bh, kd, vd), dtype=torch.float32)
    lower = torch.ones(TILE, TILE, dtype=torch.bool,
                       device=r.device).tril(-1)
    ys = []
    for t0 in range(0, s + pad, TILE):
        rc, kc, vc = rf[:, t0:t0 + TILE], kf[:, t0:t0 + TILE], \
            vf[:, t0:t0 + TILE]
        lwc = lwf[:, t0:t0 + TILE]
        cs, mid = _tile_cumsum(lwc, kd)
        ce = cs - lwc
        em = _exp(mid)                                        # (bh, 1, K)
        qf = rc * _exp(torch.clamp(ce - mid, -40.0, 40.0))
        kfac = kc * _exp(torch.clamp(mid - cs, -40.0, 40.0))
        diag = (rc * uf * kc).sum(dim=-1)
        a = torch.where(lower, _bf16(qf) @ _bf16(kfac).transpose(1, 2), 0.0)
        a = _bf16(a + torch.diag_embed(diag))
        ys.append(a @ vc + _bf16(qf * em) @ _bf16(state))
        state = (state * (em * em).transpose(1, 2)
                 + _bf16(kfac * em).transpose(1, 2) @ vc)
    return torch.cat(ys, dim=1)[:, :s]


def _launch(p: Plan, r, k, v, lw, u, out) -> None:
    """Launch K7 as ``p`` says on model-layout views (see ``plan``)."""
    work.report("wkv6_scan_bhsd", work.wkv6_scan, r, k, v, lw, u)
    if r.device.type == "meta":
        return
    strides = (ctypes.c_longlong * 15)(*p.strides())
    u = u.contiguous()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with _build.on_device(r.device):
        rc = _build.entry("rwkv6_wkv_launch")(
            _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), u.data_ptr(), out.data_ptr(), p.b, p.h, p.s, p.kd,
            p.vd, p.q, p.vs, strides, stream)
    _build.check(rc, f"wkv6_scan ({p.mode} mode)")
    wkv6_scan_bhsd.launches += 1


def _device(r) -> str:
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"wkv6_scan_bhsd: no kernel for {r.device}")
    return r.device.type


def bhsd_views(h: int, *ts):
    """The public layout as model-layout views, no copy: (B*H, S, D) ->
    (B, S, H, D)."""
    return [t.unflatten(0, (t.shape[0] // h, h)).transpose(1, 2) for t in ts]


def wkv6_scan_bhsd(r, k, v, lw, u, *, chunk: int = MAX_CHUNK):
    """The WKV recurrence on the public layout r, k, lw (BH, S, K), v
    (BH, S, V); returns y (BH, S, V)."""
    if _device(r) == "cpu":
        return wkv6_scan_ref(r, k, v, lw, u, chunk=chunk)
    _build.refuse_autograd("wkv6_scan_bhsd", r, k, v, lw, u)
    h = u.shape[0]
    if r.shape[0] % h:
        raise ValueError(f"wkv6_scan_bhsd: {r.shape[0]} rows are not a "
                         f"multiple of {h} heads of u")
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rv, kv, vv, lv, ov = bhsd_views(h, r, k, v, lw, out)
    _launch(plan(rv, kv, vv, lv, u, ov, chunk=chunk), rv, kv, vv, lv, u, ov)
    return out


def wkv6_scan_model(r, k, v, lw, u, *, chunk: int = MAX_CHUNK):
    """The WKV recurrence on the model layout r, k, lw (B, S, H, K), v
    (B, S, H, V); returns y (B, S, H, V), contiguous on the card."""
    if _device(r) == "cpu":
        b, s, h, kd = r.shape

        def fold(t):
            return t.permute(0, 2, 1, 3).reshape(b * h, s, t.shape[-1])

        y = wkv6_scan_ref(fold(r), fold(k), fold(v), fold(lw), u, chunk=chunk)
        return y.reshape(b, h, s, v.shape[-1]).permute(0, 2, 1, 3)
    _build.refuse_autograd("wkv6_scan_bhsd", r, k, v, lw, u)
    out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(plan(r, k, v, lw, u, out, chunk=chunk), r, k, v, lw, u, out)
    return out


wkv6_scan_bhsd.launches = 0
