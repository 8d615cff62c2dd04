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
bytes and the host seconds spent in them, and keeps a record of each (its
kind, its operand's and result's bytes, its group's size and ranks), which
``repro_torch.roofline.collectives`` reads; ``send``/``recv`` count there
as ``collective-permute``, the HLO's name for a pipeline hop.
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


def all_reduce(t: torch.Tensor, group, dtype=None,
               op: str = "sum") -> torch.Tensor:
    """The sum (or with ``op="max"`` the maximum) of ``t`` over ``group``,
    reduced in ``dtype`` (default t's) and returned in t's dtype."""
    if group is None:
        return t
    src = t if dtype is None else t.to(dtype)
    name = group.group_name
    out = _staged(lambda x: _C.wait_tensor(_C.all_reduce(
        x.contiguous(), op, name)), src, group)
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
    _count_p2p(t, group)
    dist.send(src.contiguous(), dist.get_global_rank(group, dst), group=group,
              tag=tag)


def recv(like: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
    """Point-to-point receive of a tensor shaped and typed as ``like``, on
    its device, from group rank ``src``."""
    host = dist.get_backend(group) == "gloo"
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group, tag=tag)
    _count_p2p(buf, group)
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


#: the HLO name of each functional collective (``roofline.collectives``)
HLO_KIND = {"all_reduce": "all-reduce",
            "all_gather_into_tensor": "all-gather",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_to_all_single": "all-to-all",
            "p2p": "collective-permute"}

_counters = []          # the active CollectiveCounters, innermost last


def _group_ranks(group) -> tuple:
    """The global ranks of ``group`` (a process group or its name)."""
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        group = _resolve_process_group(group)
    if group is None:
        return (dist.get_rank(),)
    return tuple(dist.get_process_group_ranks(group))


def _count_p2p(t: torch.Tensor, group) -> None:
    """One pipeline hop (a send or a receive) of ``t``, on every active
    counter."""
    for c in _counters:
        c.record("p2p", t, t, group)


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives that run while it is active, and
    their bytes (input for all-reduce and reduce-scatter, output for
    all-gather, input for all-to-all) and the host seconds spent in them
    and in their waits, and the point-to-point hops of ``send``/``recv``
    under ``"p2p"`` (each hop's tensor on both ends).  Enter it around a
    whole step: a collective that selective remat replays from its saved
    output never reaches it.  ``records`` holds each one as a dict: its
    HLO ``kind``, ``in_bytes``, ``out_bytes``, and its group's
    ``group_size`` and global ``ranks``."""

    def __init__(self):
        super().__init__()
        self.calls = {}
        self.bytes_by = {}
        self.seconds = 0.0
        self.records = []
        self._ranks = {}

    def __enter__(self):
        _counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _counters.remove(self)
        return super().__exit__(*exc)

    def record(self, name: str, src, out, group) -> None:
        key = group if isinstance(group, str) else id(group)
        if key not in self._ranks:
            self._ranks[key] = _group_ranks(group)
        ranks = self._ranks[key]
        self.calls[name] = self.calls.get(name, 0) + 1
        b = (out if name == "all_gather_into_tensor" else src)
        self.bytes_by[name] = (self.bytes_by.get(name, 0)
                               + b.numel() * b.element_size())
        self.records.append({
            "kind": HLO_KIND[name],
            "in_bytes": src.numel() * src.element_size(),
            "out_bytes": out.numel() * out.element_size(),
            "group_size": len(ranks), "ranks": ranks})

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
            # the group name is the last positional argument of every one
            self.record(func.overloadpacket.__name__, args[0], out,
                        args[-1] if isinstance(args[-1], str)
                        else kwargs["group_name"])
        return out
