"""K4, fused softmax cross-entropy over a vocab-padded logits matrix: the
per-row NLL and log-sum-exp (forward) and the gradient to the logits
(backward).

Replaces the TPU kernel ``softmax_xent`` of ``src/repro/kernels/
softmax_xent.py``; the CUDA source is ``src/repro_torch/csrc/
softmax_xent.cu``, which states what bounds it on the card and what its
design does about that.  The TPU kernel returns only ``nll``; the forward
here also returns ``lse``, because the z-loss and the backward need it and
recomputing it would read the (N, Vp) logits a second time (620 MB of bf16
logits at full qwen3-4b width and 2048 tokens).  The TPU kernel has no
backward (JAX differentiates the jnp loss); the port's loss is
differentiated through ``SoftmaxXent``, whose backward is the second kernel.

``softmax_xent_fwd`` and ``softmax_xent_bwd`` launch their kernels for CUDA
tensors and run the plain versions, ``softmax_xent_ref`` and
``softmax_xent_bwd_ref``, for CPU tensors; they never fall back.

Layouts: logits (N, Vp) float32 or bfloat16; labels (N,) int32 or int64,
each < vocab; nll, lse (N,) float32; dlogits like logits.  Columns >= vocab
are masked: they add nothing to the sum and get a zero gradient.  On the
card every row must start on a 16-byte boundary (the kernels move 16-byte
packs); the wrappers raise otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30


def _masked_f32(logits, vocab: int):
    lf = logits.float()
    if vocab != lf.shape[-1]:
        col = torch.arange(lf.shape[-1], device=lf.device)
        lf = torch.where(col < vocab, lf, torch.full_like(lf, NEG_INF))
    return lf


def softmax_xent_ref(logits, labels, vocab: int):
    """Plain forward (the JAX ``ref.softmax_xent_ref`` arithmetic): returns
    (nll, lse), fp32, over the leading dims of ``logits``."""
    lf = _masked_f32(logits, vocab)
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, labels.long()[..., None])[..., 0]
    return lse - picked, lse


def softmax_xent_bwd_ref(logits, labels, lse, g_nll, g_lse, vocab: int):
    """Plain backward: ``(g_nll + g_lse) * softmax - g_nll * onehot(label)``,
    zero on the padded tail, in the logits' dtype."""
    p = torch.exp(_masked_f32(logits, vocab) - lse[..., None])
    d = (g_nll + g_lse)[..., None] * p
    d.scatter_add_(-1, labels.long()[..., None], -g_nll[..., None].float())
    return d.to(logits.dtype)


def _check(what, logits, labels, vocab):
    n, vp = logits.shape
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {logits.dtype}")
    if not 0 < vocab <= vp:
        raise ValueError(f"{what}: vocab {vocab} outside (0, {vp}]")
    if (labels.device != logits.device or tuple(labels.shape) != (n,)
            or labels.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"{what}: labels are {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}, "
                         f"expected int32 or int64 ({n},) on {logits.device}")


def _check_aligned(what, t):
    """The kernels read and write rows of the contiguous (N, Vp) ``t`` as
    16-byte packs, so every row must start on a 16-byte boundary.  A vocab
    padded to a multiple of 128 (``padded_vocab``) always is."""
    if t.data_ptr() % 16 or t.shape[-1] * t.element_size() % 16:
        raise ValueError(
            f"{what}: rows of {t.shape[-1]} {t.dtype} values at offset "
            f"{t.data_ptr() % 16} do not start on 16-byte boundaries; pad "
            "the vocab to a multiple of 16 bytes per row")


def softmax_xent_fwd(logits, labels, vocab: int):
    """logits (N, Vp); labels (N,).  Returns (nll, lse), (N,) fp32 each."""
    if logits.device.type == "cpu":
        return softmax_xent_ref(logits, labels, vocab)
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_xent_fwd: no kernel for {logits.device}")
    _check("softmax_xent_fwd", logits, labels, vocab)
    n, vp = logits.shape
    logits = logits.contiguous()
    _check_aligned("softmax_xent_fwd", logits)
    labels = labels.to(torch.int32).contiguous()
    nll = torch.empty(n, device=logits.device, dtype=torch.float32)
    lse = torch.empty_like(nll)
    if n:
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        with _build.on_device(logits.device):
            rc = _build.entry("softmax_xent_fwd_launch")(
                _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
                nll.data_ptr(), lse.data_ptr(), n, vp, vocab, stream)
        _build.check(rc, "softmax_xent_fwd")
        softmax_xent_fwd.launches += 1
    return nll, lse


def softmax_xent_bwd(logits, labels, lse, g_nll, g_lse, vocab: int):
    """The gradient to (N, Vp) ``logits`` of ``sum(g_nll * nll + g_lse *
    lse)``; ``lse`` is the forward's.  Returns dlogits like logits."""
    if logits.device.type == "cpu":
        return softmax_xent_bwd_ref(logits, labels, lse, g_nll, g_lse, vocab)
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_xent_bwd: no kernel for {logits.device}")
    _check("softmax_xent_bwd", logits, labels, vocab)
    n, vp = logits.shape
    for name, t in (("lse", lse), ("g_nll", g_nll), ("g_lse", g_lse)):
        if t.device != logits.device or tuple(t.shape) != (n,):
            raise ValueError(f"softmax_xent_bwd: {name} is "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"({n},) on {logits.device}")
    logits = logits.contiguous()
    _check_aligned("softmax_xent_bwd", logits)
    labels = labels.to(torch.int32).contiguous()
    lse, g_nll, g_lse = (t.float().contiguous() for t in (lse, g_nll, g_lse))
    out = torch.empty_like(logits)
    if n:
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        with _build.on_device(logits.device):
            rc = _build.entry("softmax_xent_bwd_launch")(
                _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
                lse.data_ptr(), g_nll.data_ptr(), g_lse.data_ptr(),
                out.data_ptr(), n, vp, vocab, stream)
        _build.check(rc, "softmax_xent_bwd")
        softmax_xent_bwd.launches += 1
    return out


softmax_xent_fwd.launches = 0
softmax_xent_bwd.launches = 0


class SoftmaxXent(torch.autograd.Function):
    """(nll, lse) of (N, Vp) logits with K4's backward bound into the graph;
    labels and vocab get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, vocab: int):
        nll, lse = softmax_xent_fwd(logits, labels, vocab)
        ctx.save_for_backward(logits, labels, lse)
        ctx.vocab = vocab
        return nll, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        logits, labels, lse = ctx.saved_tensors
        return (softmax_xent_bwd(logits, labels, lse, g_nll, g_lse,
                                 ctx.vocab), None, None)
