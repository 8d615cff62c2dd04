"""Collectives of the port's parallel training, and their autograd.

Every collective goes through ``torch.ops._c10d_functional`` (the
functional collectives followed by ``wait_tensor``), so the selective
remat policy (``models.transformer._selective_policy``) sees each one as
an op and saves its output: a layer's backward recomputes its forward
without running a collective again.  Over ``gloo`` a CUDA tensor is staged
through the host (gloo reduces CUDA tensors but gathers, scatters and
exchanges only host ones); the compute stays on the card.  A group of
``None`` is a group of one rank: every collective is then the identity.

The autograd functions hold a model group's values to one convention:
a tensor computed the same on every rank of the group (replicated) gets
the same gradient on every rank, and a rank's share of a split
computation gets the gradient of its own share.  Hence:

* ``copy_to``     — identity; backward all-reduces (a replicated tensor
  entering a split computation: Megatron's f);
* ``reduce_from`` — all-reduce of partial sums; backward identity (a split
  computation's partial sums becoming replicated: Megatron's g);
* ``gather_from`` — all-gather along a dim; backward takes this rank's
  slice when what follows is replicated, or reduce-scatters when each
  rank goes on with its own data (the FSDP weight gather over ``data``);
* ``exchange``    — all-to-all of equal chunks of dim 0, its own inverse.

``send``/``recv`` are the point-to-point hops of the pipeline
(``parallel.pipeline``), which wraps them in its own autograd functions.

``CollectiveCounter`` counts the collectives that actually run, with their
bytes and the host seconds spent in them.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

_C = torch.ops._c10d_functional

#: The functional collectives' ops (``wait_tensor`` finishes each).
COLLECTIVE_OPS = (_C.all_reduce.default, _C.all_gather_into_tensor.default,
                  _C.reduce_scatter_tensor.default,
                  _C.all_to_all_single.default)
SAVED_OPS = COLLECTIVE_OPS + (_C.wait_tensor.default,)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(fn, t: torch.Tensor, group) -> torch.Tensor:
    """``fn`` on ``t``, through a host copy when gloo must take a CUDA
    tensor."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return fn(t.cpu()).to(t.device)
    return fn(t)


def all_reduce(t: torch.Tensor, group, dtype=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, reduced in ``dtype`` (default t's)
    and returned in t's dtype."""
    if group is None:
        return t
    src = t if dtype is None else t.to(dtype)
    name = group.group_name
    out = _staged(lambda x: _C.wait_tensor(_C.all_reduce(
        x.contiguous(), "sum", name)), src, group)
    return out.to(t.dtype)


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    name = group.group_name
    moved = t.movedim(dim, 0).contiguous()
    out = _staged(lambda x: _C.wait_tensor(_C.all_gather_into_tensor(
        x, n, name)), moved, group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n slice along ``dim`` of the sum of ``t`` over
    ``group``."""
    n = group_size(group)
    if n == 1:
        return t
    name = group.group_name
    moved = t.movedim(dim, 0).contiguous()
    out = _staged(lambda x: _C.wait_tensor(_C.reduce_scatter_tensor(
        x, "sum", n, name)), moved, group)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 goes to group rank i; chunk i of the result came
    from group rank i."""
    n = group_size(group)
    if n == 1:
        return t
    name = group.group_name
    split = [t.shape[0] // n] * n
    return _staged(lambda x: _C.wait_tensor(_C.all_to_all_single(
        x.contiguous(), split, split, name)), t, group)


def send(t: torch.Tensor, dst: int, group, tag: int) -> None:
    """Point-to-point send to group rank ``dst`` (through the host over
    gloo)."""
    src = t.detach().cpu() if dist.get_backend(group) == "gloo" else t
    dist.send(src.contiguous(), dist.get_global_rank(group, dst), group=group,
              tag=tag)


def recv(like: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
    """Point-to-point receive of a tensor shaped and typed as ``like``, on
    its device, from group rank ``src``."""
    host = dist.get_backend(group) == "gloo"
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group, tag=tag)
    return buf.to(like.device)


def _slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = t.shape[dim] // group_size(group)
    return t.narrow(dim, group_rank(group) * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.group, ctx.dtype = group, dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.dtype), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dtype):
        return all_reduce(x, group, dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, backward):
        ctx.dim, ctx.group, ctx.backward = dim, group, backward
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "slice":
            return _slice(g, ctx.dim, ctx.group), None, None, None
        return reduce_scatter(g, ctx.dim, ctx.group), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def copy_to(x, group, dtype=None):
    """Identity forward; the backward all-reduces the gradient over
    ``group`` in ``dtype`` (Megatron's f)."""
    return x if group is None else _CopyTo.apply(x, group, dtype)


def reduce_from(x, group, dtype=None):
    """All-reduce of partial sums over ``group`` in ``dtype``; identity
    backward (Megatron's g)."""
    return x if group is None else _ReduceFrom.apply(x, group, dtype)


def gather_from(x, dim: int, group, backward: str = "slice"):
    """All-gather along ``dim``.  ``backward="slice"`` when what follows
    is the same on every rank of ``group``; ``"sum"`` (reduce-scatter)
    when each rank goes on with its own data."""
    if group is None:
        return x
    if backward not in ("slice", "sum"):
        raise ValueError(backward)
    return _GatherFrom.apply(x, dim, group, backward)


def exchange(x, group):
    """``all_to_all`` of equal chunks of dim 0, differentiable."""
    return x if group is None else _Exchange.apply(x, group)


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives that run while it is active, and
    their bytes (input for all-reduce and reduce-scatter, output for
    all-gather, input for all-to-all) and the host seconds spent in them
    and in their waits.  Enter it around a whole step: a collective that
    selective remat replays from its saved output never reaches it."""

    def __init__(self):
        super().__init__()
        self.calls = {}
        self.bytes_by = {}
        self.seconds = 0.0

    @property
    def bytes(self) -> int:
        return sum(self.bytes_by.values())

    @property
    def total(self) -> int:
        return sum(self.calls.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in SAVED_OPS:
            return func(*args, **kwargs)
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        self.seconds += time.perf_counter() - t0
        if func in COLLECTIVE_OPS:
            name = func.overloadpacket.__name__
            self.calls[name] = self.calls.get(name, 0) + 1
            src = out if name == "all_gather_into_tensor" else args[0]
            self.bytes_by[name] = (self.bytes_by.get(name, 0)
                                   + src.numel() * src.element_size())
        return out
