"""Weight bridge: the JAX parameter tree, as nested dicts of numpy arrays,
into the port's parameters.

``from_jax`` takes what ``jax.tree.map(np.asarray, params)`` gives for an
``LM`` of any family (dense; vlm, internvl2; moe, moonshot and arctic with
its ``dense`` residual subtree; hybrid, zamba2; ssm, rwkv6; encdec,
seamless) and returns torch tensors in the same layouts.  For serving
and eval, matrix weights are cast once, to the compute dtype: the JAX
model casts its fp32 masters at every use, which is numerically the
same.  For training, ``dtype=torch.float32`` keeps them
fp32.  The leaves marked ``fp32`` in the port's spec stay fp32 whatever the
compute dtype:
- norm scales and LayerNorm biases, because the norms multiply in fp32;
- the leaves JAX pins to fp32 (``pin_dtype``): the vlm ``img_pos``;
  mamba2's ``A_log``, ``D``,
  ``dt_bias`` and gated-norm scale; rwkv6's ``mu_x``, ``mu``, ``w0``, ``u``,
  ``ln_x`` and the channel mix's ``mu_k``, ``mu_r``;
- matrices JAX multiplies in fp32: rwkv6's ``tmix.wB``, the decay LoRA's
  second matrix (``x @ wA`` is cast to fp32 and multiplied by the fp32
  master), whose bf16 rounding would move every channel's decay; the MoE
  ``router``, whose bf16 rounding would pick other experts.
``train_state_from_jax`` carries a whole JAX train state across.  No JAX is
imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import DTYPES, P, resolve_device
from repro_torch.models.lm import LM


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

    return convert(LM(cfg).spec(), tree, "params")


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


def cache_from_jax(view, device="cuda"):
    """A JAX paged cache view ``{"layers": {"k", "v"[, "k_scale",
    "v_scale"]}, "page_table"}``, as numpy arrays, into the port's decode
    view.  Every array keeps its dtype (int8 pools, fp32 scales, int32
    table); a bf16 pool, which numpy holds as an extension type, goes
    through fp32, exactly."""
    dev = resolve_device(device)

    def convert(arr):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(dev)

    return {"layers": {k: convert(v) for k, v in view["layers"].items()},
            "page_table": convert(view["page_table"])}
