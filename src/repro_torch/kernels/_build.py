"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/`` at the root of the
checkout (listed in ``.gitignore``).  A library's file name carries a hash
of its sources and flags, so an edited kernel rebuilds and an unchanged one
is reused.  All missing libraries compile together, one ``nvcc`` process per
source, when the first one is needed.  Nothing is built at import time: this
module only runs where a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("paged_decode", "flash_attention", "softmax_xent")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: name -> (library, argument types).  Every entry returns
# the cudaError_t of its launch (0 = success).
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    "paged_decode_launch": ("paged_decode", [_I] + [_P] * 6 + [_I] * 6 + [_P]),
    "flash_attention_launch": ("flash_attention",
                               [_I] + [_P] * 4 + [_I] * 5 + [_P]),
    "softmax_xent_fwd_launch": ("softmax_xent",
                                [_I] + [_P] * 4 + [_I] * 3 + [_P]),
    "softmax_xent_bwd_launch": ("softmax_xent",
                                [_I] + [_P] * 6 + [_I] * 3 + [_P]),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card, from csrc/")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all at
    once.  Returns the compiler output (``-Xptxas -v``: registers, shared
    memory, spills) of each library built by this call."""
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def entry(symbol: str):
    """The ctypes function ``symbol``, building its library if needed."""
    fn = _entries.get(symbol)
    if fn is None:
        name, argtypes = ENTRIES[symbol]
        lib = _loaded.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _entries[symbol] = fn
    return fn


def on_device(device):
    """Context that makes ``device`` current for a launch; a no-op (no
    device switch) when it already is, the one-card case."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if a CUDA input of a forward-only kernel needs a gradient: the
    kernel's output would carry no graph and silently cut the gradient to
    everything upstream.  Such callers use the plain version (or
    ``torch.no_grad()``) until the kernel has a backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires a gradient, but this kernel has no "
            "backward; call it under torch.no_grad() or use the plain path")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
