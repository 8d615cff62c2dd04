"""Logical-axis sharding: MaxText-style rules mapping logical names to mesh
axes (counterpart of the JAX ``repro.parallel.sharding``).

The key robustness property: a rule is *dropped per tensor* when the
dimension is not divisible by the mapped mesh-axis extent, and no mesh axis
is used twice in one spec.  That lets one rule set serve every
architecture: ``heads -> model`` splits llama3-405b's 128 heads over 16
and leaves arctic's 56 whole, replicated over the model group.

A spec is a tuple with JAX's ``PartitionSpec`` entries: ``None``, an axis
name, or a tuple of names, trailing ``None``s dropped.  Where JAX's
``NamedSharding`` places a global array, the port keeps on each rank the
slice that the spec gives it (``shard``; ``unshard`` gathers it back).

Training under ``sharding_context(mesh, rules)`` on a mesh of processes
(``make_mesh``) runs the models SPMD (``ShardedForward``): a weight's
dims sharded over the batch axes (FSDP, ``embed -> data``) are gathered
over them just before the layer that uses it, whose backward
reduce-scatters the gradient; a leaf the batch axes replicate has its
gradient all-reduced over them; dims sharded over ``model`` stay this
rank's and the contractions run on them (``parallel.tpmm``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.parallel import collectives as coll

AxisVal = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, AxisVal]

# thread-local, as JAX's; autograd replays a checkpointed forward on its
# own thread for CUDA tensors, so the models' remat re-enters the context
# that was current in the forward (``models.transformer._remat``)
_ctx = threading.local()


def _axes_tuple(v: AxisVal) -> Tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


# ----------------------------------------------------------------- rule sets --

def default_rules(mesh_axes: Sequence[str], *, fsdp: bool = True,
                  shape_kind: str = "train", seq_sharded_cache: bool = False,
                  fsdp_over_pod: bool = False) -> Rules:
    """Baseline rules for the production mesh.

    - TP over ``model``: heads / mlp / experts / vocab.
    - FSDP (ZeRO-3) over ``data`` (optionally + ``pod``): the ``embed`` dim
      of every weight, and optimizer state.
    - DP over ``pod``+``data``: the batch dim.
    - decode: the KV-cache sequence dim is sharded over ``model``, and for
      long-context (``seq_sharded_cache``, batch=1) additionally over the
      DP axes with batch replicated.
    """
    has_pod = "pod" in mesh_axes
    dp: Tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    fsdp_ax: AxisVal = (dp if fsdp_over_pod else ("data",)) if fsdp else None
    rules: Rules = {
        # activations
        "batch": None if seq_sharded_cache else dp,
        "seq": None,
        "seq_sp": None,
        "kv_seq": (dp + ("model",)) if seq_sharded_cache else ("model",),
        "kv_pages": "model",
        "enc_seq": None,
        # weights
        "vocab": "model",
        "embed": fsdp_ax,
        "heads": "model",
        "kv_heads": "model",
        "q_group": None,
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "moe_group": None if seq_sharded_cache else dp,
        "mamba_inner": "model",
        "mamba_heads": "model",
        "mamba_conv": "model",
        "rwkv_heads": "model",
        "state": None,
        "conv": None,
        "lora": None,
        "norm": None,
        "layers": None,
        "stage": None,
        "img": None,
    }
    return rules


# --------------------------------------------------------------- resolution --

def spec_for(logical: Sequence[Optional[str]], shape: Sequence[int],
             rules: Rules, mesh) -> Tuple[AxisVal, ...]:
    """Resolve logical axes to a spec, dropping non-divisible rules and
    never using the same mesh axis twice in one spec.  ``mesh`` is anything
    whose ``shape`` maps axis names to sizes."""
    used: set = set()
    out: List[AxisVal] = []
    for dim, name in zip(shape, logical):
        val = rules.get(name) if name is not None else None
        axes = _axes_tuple(val)
        kept: List[str] = []
        extent = 1
        for a in axes:
            if a in mesh.shape and a not in used:
                if dim % (extent * mesh.shape[a]) == 0:
                    kept.append(a)
                    extent *= mesh.shape[a]
        for a in kept:
            used.add(a)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def logical_to_sharding(axes_tree, abstract_tree, mesh, rules: Rules):
    """The tree of specs for a tree of logical-axes tuples and a matching
    tree of (abstract) tensors."""
    if _is_axes(axes_tree):
        return spec_for(axes_tree, tuple(abstract_tree.shape), rules, mesh)
    return {k: logical_to_sharding(v, abstract_tree[k], mesh, rules)
            for k, v in axes_tree.items()}


def _entries(spec, ndim: int) -> Tuple[AxisVal, ...]:
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a contiguous copy):
    along a dim sharded over axes (a, b), block ``index(a, b)`` of
    ``size(a)·size(b)``."""
    out = full
    for dim, entry in enumerate(_entries(spec, full.dim())):
        axes = _axes_tuple(entry)
        if axes:
            n = out.shape[dim] // mesh.axis_size(axes)
            out = out.narrow(dim, mesh.index(axes) * n, n)
    return out.contiguous()


def unshard(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``shard`` (a collective over the
    spec's axes: every rank must call it)."""
    out = local
    for dim, entry in enumerate(_entries(spec, local.dim())):
        for a in reversed(_axes_tuple(entry)):
            out = coll.all_gather(out, dim, mesh.group(a))
    return out


def shard_tree(tree, specs, mesh):
    """``shard`` of every tensor leaf of a nested dict (other leaves, such
    as the step count, as they are)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard(tree, specs, mesh) if isinstance(tree, torch.Tensor) else tree


def unshard_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: unshard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return (unshard(tree, specs, mesh) if isinstance(tree, torch.Tensor)
            else tree)


# ----------------------------------------------------------------- context ---

@contextmanager
def sharding_context(mesh, rules: Optional[Rules]):
    """Makes ``mesh`` and ``rules`` current.  On a mesh of processes the
    models' forward and ``make_train_step`` run sharded inside it; with no
    context they run on one rank."""
    prev = getattr(_ctx, "val", None)
    _ctx.val = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _ctx.val = prev


def current_context():
    return getattr(_ctx, "val", None)


def constrain(x, logical: Sequence[Optional[str]]):
    """The identity.  JAX's ``constrain`` is a layout hint to XLA; the
    port's layouts are explicit (each rank holds its shards and the models'
    collectives are written out), so there is nothing to hint."""
    del logical
    return x


def active_mesh():
    """(mesh, rules) of a current context whose mesh has processes, else
    ``None``."""
    ctx = current_context()
    if ctx is None or ctx[0].is_abstract:
        return None
    return ctx


def batch_axes(mesh, rules: Rules) -> Tuple[str, ...]:
    return tuple(a for a in _axes_tuple(rules.get("batch"))
                 if a in mesh.shape)


def batch_rows(mesh, rules: Rules, batch: int) -> slice:
    """The rows of a global batch of ``batch`` this rank takes: the batch
    dim is split over the rules' ``batch`` axes."""
    axes = batch_axes(mesh, rules)
    n = mesh.axis_size(axes) if axes else 1
    if batch % n:
        raise ValueError(f"global batch {batch} does not split over the "
                         f"{n} ranks of the batch axes {axes}")
    rows = batch // n
    i = mesh.index(axes) if axes else 0
    return slice(i * rows, (i + 1) * rows)


# -------------------------------------------------------- sharded forward ---

class ShardedForward:
    """A model forward on this rank of ``mesh`` under ``rules``: the spec of
    every parameter of ``spec_tree`` (a model's ``build_spec``) and the
    gather that ``use`` makes of a weight before it is used.

    ``use`` returns each leaf with its dims split over the batch axes or
    the FSDP axes (the rules' ``embed`` axes) gathered (in ``dtype``, the
    compute dtype, or fp32 for an ``fp32`` leaf: gathering in the compute
    dtype gives the values that a cast after the gather would), and sets
    on it ``mesh_axes``, the model-axis entry of each dim that stays this
    rank's, which ``parallel.tpmm`` reads.  A gather over a batch axis
    reduce-scatters its backward (each rank computes its own rows); over
    an FSDP axis the batch does not split (long-context decode's rules
    replicate the batch), the computation is the same on every rank of it
    and the backward takes this rank's slice."""

    def __init__(self, mesh, rules: Rules, spec_tree, dtype):
        self.mesh, self.rules, self.dtype = mesh, rules, dtype
        self.batch_axes = batch_axes(mesh, rules)
        self.gather_axes = self.batch_axes + tuple(
            a for a in _axes_tuple(rules.get("embed"))
            if a in mesh.shape and a not in self.batch_axes)
        self.specs = self._resolve(spec_tree)

    def _resolve(self, spec):
        if isinstance(spec, dict):
            return {k: self._resolve(v) for k, v in spec.items()}
        entries = _entries(spec_for(spec.axes, spec.shape, self.rules,
                                    self.mesh), len(spec.shape))
        return entries, spec.fp32

    def use(self, tree, specs, stacked: bool = False):
        """``tree``'s leaves, ready for the compute (see the class).  With
        ``stacked``, ``tree`` is one layer of a stacked subtree and its
        specs lose their leading ``layers`` entry."""
        if isinstance(tree, dict):
            return {k: self.use(v, specs[k], stacked) for k, v in
                    tree.items()}
        entries, fp32 = specs
        if stacked:
            entries = entries[1:]
        t = tree.to(torch.float32 if fp32 else self.dtype)
        used = set()
        for dim, entry in enumerate(entries):
            axes = _axes_tuple(entry)
            dp_axes = [a for a in axes if a in self.gather_axes]
            if dp_axes and len(dp_axes) != len(axes):
                raise NotImplementedError(
                    f"a dim sharded over batch and other axes ({axes})")
            for a in reversed(dp_axes):
                t = coll.gather_from(t, dim, self.mesh.group(a),
                                     "sum" if a in self.batch_axes
                                     else "slice")
            used.update(dp_axes)
        rest = tuple(a for a in self.batch_axes if a not in used)
        if rest:
            t = coll.copy_to(t, self.mesh.group(rest))
        if t is tree:                  # a fresh tensor to carry mesh_axes
            t = t.view_as(t)
        t.mesh_axes = tuple(None if entry is None or _axes_tuple(entry)[0]
                            in self.gather_axes else entry
                            for entry in entries)
        return t


def sharded_forward(cfg, spec_fn) -> Optional[ShardedForward]:
    """The ``ShardedForward`` of ``cfg``'s model under the current context
    (cached on the mesh), or ``None`` outside a context on a mesh of
    processes.  ``spec_fn(cfg)`` builds the model's spec tree."""
    ctx = active_mesh()
    if ctx is None:
        return None
    mesh, rules = ctx
    key = (cfg, tuple(sorted((k, _axes_tuple(v)) for k, v in rules.items())))
    if key not in mesh.cache:
        from repro_torch.models.common import DTYPES
        mesh.cache[key] = ShardedForward(mesh, rules, spec_fn(cfg),
                                         DTYPES[cfg.dtype])
    return mesh.cache[key]


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in the spec's order."""
    return tuple(a for e in spec for a in _axes_tuple(e))
