"""Checkpointing of the port, in the JAX package's on-disk format
(counterpart of ``repro.core.checkpoint``; the port imports nothing of it).

Layout (one directory per step):
    <dir>/step_00000100/
        manifest.json            # leaf paths, shapes, dtypes, shard hashes
        shard_<i>.npz            # leaf groups of SHARD_LEAVES
    <dir>/LATEST                 # atomic pointer, written last

Leaf paths are the ``/``-joined dict keys in sorted order, as JAX flattens
a dict, so a checkpoint that the JAX trainer writes restores in the port and
the other way round.  Restores verify each shard's sha256.  Tensors are
copied to the host for the write; a restore places each leaf on the device
and in the dtype of the template's leaf.

A state sharded over a mesh (``parallel.sharding``) is saved whole: with
``shardings`` the ranks gather every leaf and rank 0 writes the usual
format.  It restores onto any mesh, or onto one rank (elastic restart):
with ``shardings`` each rank reads the whole leaves and keeps its slice.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.youngs import checkpoint_every_n_steps

SHARD_LEAVES = 64     # leaves per npz shard file


def _flatten_with_paths(tree, prefix=""):
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; the port's "
                            "train state keeps fp32 parameters")
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):            # the host step count
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def save_checkpoint(directory: str, state, step: int,
                    uploader: Optional[Callable[[str, int], Any]] = None,
                    keep_last: int = 3, shardings=None, mesh=None) -> Dict:
    """Blocking local write; optional async upload callback(key, nbytes).
    With ``shardings`` (the specs of a state sharded over ``mesh``) every
    rank must call it: the leaves are gathered whole, rank 0 writes, and
    the other ranks return None once the write is done."""
    if shardings is not None:
        from repro_torch.parallel.sharding import unshard_tree
        state = unshard_tree(state, shardings, mesh)
        if mesh.rank != 0:
            _barrier()
            return None
        try:
            return save_checkpoint(directory, state, step, uploader,
                                   keep_last)
        finally:
            _barrier()
    d = Path(directory) / f"step_{step:08d}"
    tmp = Path(directory) / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    items = _flatten_with_paths(state)
    manifest = {"step": step, "format": 1, "leaves": [], "shards": []}
    t0 = time.perf_counter()
    total = 0
    for si in range(0, len(items), SHARD_LEAVES):
        group = items[si:si + SHARD_LEAVES]
        shard_name = f"shard_{si // SHARD_LEAVES:05d}.npz"
        arrays = {}
        for j, (path, leaf) in enumerate(group):
            arr = _to_numpy(leaf)
            arrays[f"a{j}"] = arr
            manifest["leaves"].append({
                "path": path, "shard": shard_name, "key": f"a{j}",
                "shape": list(arr.shape), "dtype": str(arr.dtype)})
            total += arr.nbytes
        with open(tmp / shard_name, "wb") as f:
            np.savez(f, **arrays)
        digest = hashlib.sha256((tmp / shard_name).read_bytes()).hexdigest()
        manifest["shards"].append({"name": shard_name, "sha256": digest})
    manifest["nbytes"] = total
    manifest["write_seconds"] = time.perf_counter() - t0
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if d.exists():
        shutil.rmtree(d)
    os.replace(tmp, d)
    # LATEST pointer written last => crash-consistent
    latest = Path(directory) / "LATEST"
    latest_tmp = Path(directory) / ".LATEST.tmp"
    latest_tmp.write_text(d.name)
    os.replace(latest_tmp, latest)

    if uploader is not None:
        threading.Thread(target=uploader, args=(d.name, total),
                         daemon=True).start()
    _gc(directory, keep_last)
    return manifest


def _barrier():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _gc(directory: str, keep_last: int):
    steps = sorted(p for p in Path(directory).glob("step_*") if p.is_dir())
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    latest = Path(directory) / "LATEST"
    if not latest.exists():
        return None
    name = latest.read_text().strip()
    if not (Path(directory) / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def _restore_leaf(path, arr, like):
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(like.shape)}")
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, int):
        return int(arr)
    return arr


def load_checkpoint(directory: str, step: Optional[int] = None,
                    template=None, shardings=None, verify: bool = True,
                    mesh=None):
    """Restore a state.  Without ``template`` returns ({path: array}, step);
    with one (a state of the same structure) returns (state, step), each
    tensor leaf on the template leaf's device and in its dtype, each int
    leaf an int.  With ``shardings`` (a tree of specs congruent with the
    template) and ``mesh``, each leaf is this rank's slice of the saved
    one (``sharding.shard``), and the template holds this rank's shards."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if verify:
        for sh in manifest["shards"]:
            digest = hashlib.sha256((d / sh["name"]).read_bytes()).hexdigest()
            if digest != sh["sha256"]:
                raise IOError(f"checkpoint corruption in {sh['name']}")
    leaves: Dict[str, np.ndarray] = {}
    for sh in manifest["shards"]:
        with np.load(d / sh["name"]) as npz:
            for entry in manifest["leaves"]:
                if entry["shard"] == sh["name"]:
                    leaves[entry["path"]] = npz[entry["key"]]
    if template is None:
        return leaves, step
    specs = dict(_flatten_with_paths(shardings)) if shardings is not None \
        else {}

    def mine(path, arr):
        if path not in specs or not arr.ndim:
            return arr
        from repro_torch.parallel.sharding import shard
        return shard(torch.from_numpy(arr), specs[path], mesh).numpy()
    restored = {path: _restore_leaf(path, mine(path, leaves[path]), like)
                for path, like in _flatten_with_paths(template)}

    def build(node, prefix):
        if not isinstance(node, dict):
            return restored[prefix]
        return {k: build(v, f"{prefix}/{k}" if prefix else k)
                for k, v in node.items()}
    return build(template, ""), step


class CheckpointManager:
    """Young's-interval checkpoint policy + async upload accounting."""

    def __init__(self, directory: str, delta_seconds: float,
                 mtbf_seconds: float, step_time: float,
                 uploader: Optional[Callable] = None, keep_last: int = 3):
        self.directory = directory
        self.every = checkpoint_every_n_steps(delta_seconds, mtbf_seconds,
                                              step_time)
        self.uploader = uploader
        self.keep_last = keep_last
        self.saves: List[int] = []

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, state, step: int):
        m = save_checkpoint(self.directory, state, step,
                            uploader=self.uploader, keep_last=self.keep_last)
        self.saves.append(step)
        return m
