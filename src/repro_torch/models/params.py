"""Weight bridge: the JAX parameter tree, as nested dicts of numpy arrays,
into the port's parameters.

``from_jax`` takes what ``jax.tree.map(np.asarray, params)`` gives for a
dense ``LM`` and returns torch tensors in the same layouts.  For serving,
matrix weights are cast once, to the compute dtype: the JAX model casts its
fp32 masters at every use, which is numerically the same.  For training,
``dtype=torch.float32`` keeps them fp32.  Norm scales stay fp32, as the
norm multiplies in fp32.  ``train_state_from_jax`` carries a whole JAX train
state across.  No JAX is imported here.
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


def train_state_from_jax(state, cfg, device="cuda"):
    """The JAX train state ``{"params", "opt": {"m", "v"[, "master"]},
    "step"}``, as numpy arrays, into the port's: parameters in
    ``cfg.param_dtype``, moments (and masters) fp32, the step a host int.
    A JAX run can then go on in the port."""
    unknown = set(state["opt"]) - {"m", "v", "master"}
    if unknown:
        raise KeyError(f"opt: unexpected {sorted(unknown)}")
    return {"params": from_jax(state["params"], cfg, device,
                               DTYPES[cfg.param_dtype]),
            "opt": {k: from_jax(tree, cfg, device, torch.float32)
                    for k, tree in state["opt"].items()},
            "step": int(np.asarray(state["step"]))}
