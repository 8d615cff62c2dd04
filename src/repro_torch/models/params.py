"""Weight bridge: the JAX parameter tree, as nested dicts of numpy arrays,
into the port's parameters.

``from_jax`` takes what ``jax.tree.map(np.asarray, params)`` gives for a
dense ``LM`` and returns torch tensors in the same layouts.  Matrix weights
are cast once, to the compute dtype: the JAX model casts its fp32 masters at
every use, which is numerically the same.  Norm scales stay fp32, as the
norm multiplies in fp32.  No JAX is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import DTYPES, P, resolve_device
from repro_torch.models.transformer import build_spec


def from_jax(tree, cfg, device="cuda", dtype=None):
    dev = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]

    def convert(spec, node, path):
        if isinstance(spec, P):
            arr = np.asarray(node)
            if arr.shape != spec.shape:
                raise ValueError(f"{path}: shape {arr.shape}, expected "
                                 f"{spec.shape}")
            t = torch.from_numpy(np.array(arr, np.float32))
            return t.to(device=dev,
                        dtype=torch.float32 if spec.fp32 else dtype)
        missing = set(spec) - set(node)
        if missing:
            raise KeyError(f"{path}: missing {sorted(missing)}")
        return {k: convert(v, node[k], f"{path}/{k}")
                for k, v in spec.items()}

    return convert(build_spec(cfg), tree, "params")
