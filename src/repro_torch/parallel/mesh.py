"""Named meshes over ``torch.distributed`` ranks (counterpart of the JAX
``repro.parallel.mesh``).

Where a JAX mesh is one controller's array of devices, the port is SPMD:
one process per mesh position.  Ranks lie on the mesh row-major, the last
axis fastest, as ``jax.make_mesh`` lays devices out: on a (data, model)
mesh of shape (D, M), rank r sits at (r // M, r % M).  A ``Mesh`` knows
this rank's coordinates and holds one process group for every set of its
axes (``group``): the ranks that differ from this one only along those
axes.  A mesh built with ``Mesh(shape, axes)`` and no processes is
abstract, like JAX's ``AbstractMesh``: ``shape`` is all ``spec_for``
reads.  Importing this module touches no process group."""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist


class Mesh:
    """``shape``: axis name -> size, in mesh order; ``axis_names``; and,
    when built by ``make_mesh``, ``rank``, ``coords`` (axis name -> this
    rank's index) and the process groups (``group``)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} do not pair up")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank: Optional[int] = None
        self.coords: Dict[str, int] = {}
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.cache: dict = {}

    @property
    def is_abstract(self) -> bool:
        return self.rank is None

    def _ordered(self, axes) -> Tuple[str, ...]:
        if isinstance(axes, str):
            axes = (axes,)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise KeyError(f"axes {sorted(unknown)} not in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._ordered(axes))

    def index(self, axes) -> int:
        """This rank's index along ``axes`` taken together, the first
        named axis major."""
        if isinstance(axes, str):
            axes = (axes,)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (a name or a tuple of names), ordered by global rank
        (row-major over ``axes`` in mesh order); ``None`` when that group
        has one rank."""
        if self.is_abstract:
            raise RuntimeError("an abstract mesh has no process groups")
        key = self._ordered(axes)
        return self._groups.get(key)

    def place(self, rank: int) -> "Mesh":
        """Sets this mesh's rank and its coordinates (row-major, the last
        axis fastest), without process groups: enough for ``shard``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on a mesh of {self.size}")
        self.rank = rank
        for a in reversed(self.axis_names):
            self.coords[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return self

    def __repr__(self):
        where = "abstract" if self.is_abstract else f"rank {self.rank}"
        return f"Mesh({self.shape}, {where})"


def _rank_of(coords: Dict[str, int], shape: Dict[str, int]) -> int:
    r = 0
    for a, n in shape.items():
        r = r * n + coords[a]
    return r


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """This process's place on a mesh of ``torch.distributed``'s ranks.
    The default process group must hold ``prod(shape)`` ranks (a mesh of
    one position needs none).  Every rank must call this with the same
    arguments, in the same order as any other group creation: it creates
    one group per set of axes and coset, on every rank."""
    mesh = Mesh(shape, axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size != world:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {mesh.size} ranks, the process "
            f"group has {world}; launch one process per mesh position")
    mesh.place(dist.get_rank() if dist.is_initialized() else 0)
    names = mesh.axis_names
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            if mesh.axis_size(sub) == 1:
                continue
            others = [a for a in names if a not in sub]
            for fixed in itertools.product(
                    *(range(mesh.shape[a]) for a in others)):
                base = dict(zip(others, fixed))
                ranks = sorted(
                    _rank_of({**base, **dict(zip(sub, free))}, mesh.shape)
                    for free in itertools.product(
                        *(range(mesh.shape[a]) for a in sub)))
                g = dist.new_group(ranks)
                if mesh.rank in ranks:
                    mesh._groups[sub] = g
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The target deployment mesh: one 256-chip pod (16×16) or two pods
    (2×16×16); ``pod`` is the slow axis, ``data`` and ``model`` the fast
    ones."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (pod is an outer DP axis by
    default)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
