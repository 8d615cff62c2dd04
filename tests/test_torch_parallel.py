"""Parallel training of the port on gloo rank processes, against the JAX
package's own parallel code and against the single-rank port.

One JAX subprocess (4 host devices, a mesh of ``Auto`` axes: jax 0.9's
``jax.make_mesh`` makes ``Explicit`` axes by default, which its
``with_sharding_constraint`` refuses) writes the oracle's results; four
port ranks (a 2×2 ``data × model`` mesh, then a 4-rank ``data`` mesh, a
4-stage pipeline and a 2×2 ``pod × data`` mesh) and two more (a 1×2 and a
2-rank ``data`` mesh) run at the same time on weights that this process
makes.  Held to JAX in fp32 at ``tests/test_torch_train.py``'s tolerances:
the three tensor-parallel contractions with and without bias,
``seq_sharded_attention``, ``compressed_allreduce_mean`` with its
residual, ``make_pipelined_apply`` (forward and gradients, also against
the sequential loop), ``moe_ffn_ep`` (y and aux) and the 2×2 sharded train
step of ``qwen3-4b.reduced()`` under the default opts, ``tp_shardmap``
and ``seqsp`` (loss and gradients at step 0; parameters after a step with
lr > 0, also against the single-rank port: JAX's ``lr_schedule`` gives lr
0 at step 0, so that step moves nothing).  Against the single-rank port:
splits where a rule drops (MQA's one K/V head over two ranks), the MoE
experts split over the model axis, the collective count of selective
remat against none's, the elastic restore both ways, ``build_pp_forward``,
zamba2's data-only step and a 1×2 train step of each of the hybrid, ssm
and enc-dec families (``tests/test_torch_tp_families.py`` holds those
three to JAX's sharded step)."""
import dataclasses
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import CONFIGS as TCONFIGS, TrainConfig
from repro_torch.models import LM, ForwardOpts, make_batch
from repro_torch.models.common import spec_leaves
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import default_rules, shard, spec_for
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.optimizer import lr_schedule, tree_leaves
from repro_torch.train.trainer import TRAIN_OPTS
from test_torch_tenancy import one_torch_thread  # noqa: F401
from test_torch_train import FWD, GRAD

ROOT = Path(__file__).resolve().parents[1]
TCFG = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
VARIANTS = {"default": {}, "tp_shardmap": {"tp_shardmap": True},
            "seqsp": {"attn_impl": "seqsp"}}
MESH22 = ((2, 2), ("data", "model"))
#: the families split over a 1×2 mesh's model axis by the PAIR ranks
SPLIT_FAMILIES = ("zamba2-1.2b", "rwkv6-1.6b", "seamless-m4t-large-v2")
# AdamW divides by sqrt(v): where a gradient is at the noise level of the
# reductions' summation order, its step carries that noise magnified, up
# to a full step of either sign.  Parameters after AdamW are held to GRAD
# but for at most this share of a leaf, each within two full steps (as
# tests/test_torch_train.py holds the recurrent families; seen here: at
# most 4 of 65,536 elements).
ADAM_OUTLIERS = 1e-3


def _cfg(name, **kw):
    return dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32",
                               **kw)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(devices=0):
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


# ------------------------------------------------------------ the oracle --

JAX_ORACLE = r"""
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import CONFIGS, TrainConfig
from repro.models import LM, ForwardOpts, make_batch
from repro.parallel.sharding import default_rules, logical_to_sharding, sharding_context
from repro.parallel import tpmm, seqattn, epmoe
from repro.parallel.compression import make_compressed_grad_sync
from repro.parallel.pipeline import make_pipelined_apply
from repro.train import make_train_step, train_state_logical_axes, abstract_train_state
from repro.train.optimizer import init_opt_state

work = sys.argv[1]
W = dict(np.load(f"{work}/weights.npz"))
out = {}
def tree(prefix):
    t = {}
    for k, v in W.items():
        if k.startswith(prefix + "/"):
            node = t
            parts = k[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(v)
    return t
def put(prefix, t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + "/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
def auto(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

mesh = auto((2, 2), ("data", "model"))
rules = default_rules(mesh.axis_names)

# --- the three TP contractions, with and without bias
rng = np.random.default_rng(1)
TP = {k: jnp.asarray(rng.normal(0, 1, s), jnp.float32) for k, s in
      [("y", (4, 8, 4, 8)), ("wo", (4, 8, 16)), ("bo", (16,)),
       ("x", (4, 8, 16)), ("w2", (16, 32)), ("b2", (32,)),
       ("w3", (16, 4, 8)), ("b3", (4, 8)), ("h", (4, 8, 32)),
       ("wd", (32, 16)), ("bd", (16,))]}
calls = {"o_proj": lambda b: tpmm.o_proj_tp(TP["y"], TP["wo"], TP["bo"] if b else None),
         "col2": lambda b: tpmm.col_proj_tp(TP["x"], TP["w2"], TP["b2"] if b else None),
         "col3": lambda b: tpmm.col_proj_tp(TP["x"], TP["w3"], TP["b3"] if b else None),
         "down": lambda b: tpmm.down_proj_tp(TP["h"], TP["wd"], TP["bd"] if b else None)}
with mesh:
    for name, f in calls.items():
        for b in (0, 1):
            def run(f=f, b=b):
                with sharding_context(mesh, rules):
                    return f(b)
            out[f"tp/{name}/{b}"] = np.asarray(jax.jit(run)())
    q = jnp.asarray(rng.normal(0, 1, (4, 16, 2, 2, 8)), jnp.float32)
    k = jnp.asarray(rng.normal(0, 1, (4, 16, 2, 8)), jnp.float32)
    v = jnp.asarray(rng.normal(0, 1, (4, 16, 2, 8)), jnp.float32)
    def sq():
        with sharding_context(mesh, rules):
            return seqattn.seq_sharded_attention(q, k, v, q_chunk=4, kv_chunk=4)
    out["seqattn/y"] = np.asarray(jax.jit(sq)())

# --- moe_ffn_ep on moonshot reduced
mcfg = dataclasses.replace(CONFIGS["moonshot-v1-16b-a3b"].reduced(), dtype="float32")
mp = jax.tree.map(lambda a: a[0], tree("moonshot")["layers"]["moe"])
xm = jnp.asarray(np.random.default_rng(2).normal(0, 1, (4, 32, mcfg.d_model)), jnp.float32)
def ep():
    with sharding_context(mesh, rules):
        return epmoe.moe_ffn_ep(mp, mcfg, xm)
with mesh:
    y, aux = jax.jit(ep)()
out["ep/y"], out["ep/aux"] = np.asarray(y), np.asarray(aux)

# --- the 2x2 sharded train step of qwen3 reduced
cfg = dataclasses.replace(CONFIGS["qwen3-4b"].reduced(), dtype="float32")
lm = LM(cfg)
tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
batch = make_batch(cfg, 4, 64, dtype=jnp.float32)
sh = logical_to_sharding(train_state_logical_axes(lm), abstract_train_state(lm), mesh, rules)
for variant, kw in {"default": {}, "tp_shardmap": {"tp_shardmap": True},
                    "seqsp": {"attn_impl": "seqsp"}}.items():
    opts = ForwardOpts(**{"attn_impl": "blockwise", "remat": "none", **kw})
    params = tree("qwen3")
    state = {"params": params, "opt": init_opt_state(params), "step": jnp.zeros((), jnp.int32)}
    def grads(p, b, opts=opts):
        with sharding_context(mesh, rules):
            return jax.value_and_grad(lambda p: lm.loss(p, b, opts, moe_aux_weight=tcfg.moe_aux_loss, z_loss=tcfg.z_loss), has_aux=True)(p)
    step = make_train_step(lm, tcfg, opts)
    def wrapped(s, b, step=step):
        with sharding_context(mesh, rules):
            return step(s, b)
    with mesh:
        (loss, m), g = jax.jit(grads, in_shardings=(sh["params"], None))(params, batch)
        fn = jax.jit(wrapped, in_shardings=(sh, None), out_shardings=(sh, None))
        for i in range(2):
            state, mm = fn(state, batch)
    out[f"train/{variant}/loss"] = np.asarray(loss)
    put(f"train/{variant}/grads", g)
    put(f"train/{variant}/params", state["params"])

# --- compressed sync on a 4-way data mesh, two rounds (the residual)
m4 = auto((4,), ("data",))
gs = jnp.asarray(np.random.default_rng(3).normal(0, 1, (2, 4, 128)), jnp.float32)
sync = make_compressed_grad_sync(m4, "data")
err = {"g": jnp.zeros((4, 128), jnp.float32)}
with m4:
    for r in range(2):
        mean, err = sync({"g": gs[r]}, err)
        out[f"comp/mean{r}"], out[f"comp/err{r}"] = np.asarray(mean["g"]), np.asarray(err["g"])

# --- the pipeline: 8 layers over 4 stages (the JAX test's case)
mp4 = auto((4,), ("pipe",))
rng = np.random.default_rng(0)
w = jnp.asarray(rng.normal(0, 0.5, (8, 16, 16)), jnp.float32)
x = jnp.asarray(rng.normal(0, 1, (8, 16)), jnp.float32)
apply = make_pipelined_apply(lambda lp, h: jnp.tanh(h @ lp["w"]), mp4, "pipe", n_microbatches=4)
with mp4:
    out["pipe/y"] = np.asarray(apply({"w": w}, x))
    out["pipe/g"] = np.asarray(jax.grad(lambda p: jnp.sum(apply({"w": p}, x) ** 2))(w))

# --- granite-20b-code reduced at 4 layers: the single-device forward
gcfg = dataclasses.replace(CONFIGS["granite-20b-code"].reduced(), dtype="float32", num_layers=4)
toks = jnp.asarray(np.random.default_rng(4).integers(0, gcfg.vocab_size, (8, 32)), jnp.int32)
logits, _, _ = LM(gcfg).forward(tree("granite"), {"tokens": toks}, ForwardOpts(attn_impl="dense", remat="none"))
out["pp/logits"] = np.asarray(logits)
np.savez(f"{work}/jax.npz", **out)
print("ORACLE OK")
"""


# ----------------------------------------------------------- port ranks --

RANKS = r"""
import dataclasses, sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
from repro_torch.configs import CONFIGS, TrainConfig
from repro_torch.core.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.launch.pp_dryrun import build_pp_forward
from repro_torch.models import LM, ForwardOpts, make_batch
from repro_torch.models import transformer as tfm
from repro_torch.parallel import epmoe, seqattn, tpmm
from repro_torch.parallel.collectives import CollectiveCounter
from repro_torch.parallel.compression import init_error_state, make_compressed_grad_sync
from repro_torch.parallel.mesh import make_mesh
from repro_torch.parallel.pipeline import make_pipelined_apply
from repro_torch.parallel.sharding import (batch_rows, default_rules, shard, shard_tree,
                                           sharded_forward, sharding_context)
from repro_torch.train import make_train_step, shard_train_state, unshard_train_state
from repro_torch.train.trainer import TRAIN_OPTS, train_state_specs
from repro_torch.train.optimizer import init_opt_state, tree_leaves

W = torch.load(f"{work}/weights.pt")
out = {}
def clone(t):
    return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()
def state_of(params):
    p = clone(params)
    return {"params": p, "opt": init_opt_state(p), "step": 0}

mesh = make_mesh((2, 2), ("data", "model"))
rules = default_rules(mesh.axis_names)
d, m = mesh.coords["data"], mesh.coords["model"]

# --- the TP contractions on this rank's rows and model shard
rng = np.random.default_rng(1)
TP = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for k, s in
      [("y", (4, 8, 4, 8)), ("wo", (4, 8, 16)), ("bo", (16,)),
       ("x", (4, 8, 16)), ("w2", (16, 32)), ("b2", (32,)),
       ("w3", (16, 4, 8)), ("b3", (4, 8)), ("h", (4, 8, 32)),
       ("wd", (32, 16)), ("bd", (16,))]}
rows = slice(2 * d, 2 * d + 2)
def split(t, dim, axes):
    t = t.narrow(dim, m * t.shape[dim] // 2, t.shape[dim] // 2).clone()
    t.mesh_axes = axes
    return t
with sharding_context(mesh, rules):
    for b in (0, 1):
        out[f"tp/o_proj/{b}"] = tpmm.o_proj_tp(
            split(TP["y"][rows], 2, None), split(TP["wo"], 0, ("model", None, None)),
            TP["bo"] if b else None)
        out[f"tp/col2/{b}"] = tpmm.col_proj_tp(
            TP["x"][rows], split(TP["w2"], 1, (None, "model")),
            split(TP["b2"], 0, ("model",)) if b else None)
        out[f"tp/col3/{b}"] = tpmm.col_proj_tp(
            TP["x"][rows], split(TP["w3"], 1, (None, "model", None)),
            split(TP["b3"], 0, ("model", None)) if b else None)
        out[f"tp/down/{b}"] = tpmm.down_proj_tp(
            split(TP["h"][rows], 2, None), split(TP["wd"], 0, ("model", None)),
            TP["bd"] if b else None)
    q = torch.from_numpy(rng.normal(0, 1, (4, 16, 2, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (4, 16, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (4, 16, 2, 8)).astype(np.float32))
    out["seqattn/y"] = seqattn.seq_sharded_attention(q[rows], k[rows], v[rows], q_chunk=4, kv_chunk=4)

# --- moe_ffn_ep on this rank's rows, the layer's shards gathered for use
mcfg = dataclasses.replace(CONFIGS["moonshot-v1-16b-a3b"].reduced(), dtype="float32")
mlm = LM(mcfg)
mspecs = train_state_specs(mlm, mesh, rules)["params"]
mparams = shard_tree(W["moonshot"], mspecs, mesh)
xm = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (4, 32, mcfg.d_model)).astype(np.float32))
with sharding_context(mesh, rules):
    sf = sharded_forward(mcfg, tfm.build_spec)
    mp = tfm.use(mparams, "layers", sf, 0)["moe"]
    y, aux = epmoe.moe_ffn_ep(mp, mcfg, xm[rows])
out["ep/y"], out["ep/aux"] = y, aux

# --- the sharded train step: grads at step 0, then two steps
def grads(lm, st, batch, opts, tcfg):
    leaves = tree_leaves(st["params"])
    for p in leaves:
        p.requires_grad_(True)
    r = batch_rows(mesh, rules, batch["tokens"].shape[0])
    loss, met = lm.loss(st["params"], {k: v[r] for k, v in batch.items()}, opts,
                        moe_aux_weight=tcfg.moe_aux_loss, z_loss=tcfg.z_loss)
    return met, torch.autograd.grad(loss, leaves)

tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
def train(name, params, opts, key, batch_kw={}, **cfg_kw):
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32", **cfg_kw)
    lm = LM(cfg)
    batch = make_batch(cfg, 4, 64, dtype=torch.float32)
    st = shard_train_state(state_of(params), lm, mesh, rules)
    cc = CollectiveCounter()
    with sharding_context(mesh, rules):
        with cc:
            met, g = grads(lm, st, batch, opts, tcfg)
        step = make_train_step(lm, tcfg, opts)
        for i in range(2):
            st, mm = step(st, batch)
    out[f"{key}/loss"] = met["loss"]
    out[f"{key}/grads"] = list(g)
    out[f"{key}/params"] = tree_leaves(st["params"])
    out[f"{key}/collectives"] = cc.total
    return st

VARIANTS = {"default": {}, "tp_shardmap": {"tp_shardmap": True}, "seqsp": {"attn_impl": "seqsp"}}
for variant, kw in VARIANTS.items():
    st = train("qwen3-4b", W["qwen3"], dataclasses.replace(TRAIN_OPTS, remat="none", **kw),
               f"train/{variant}")
train("qwen3-4b", W["qwen3"], dataclasses.replace(TRAIN_OPTS, remat="selective"), "train/selective")
train("qwen3-4b", W["mqa"], dataclasses.replace(TRAIN_OPTS, remat="none"), "train/mqa", num_kv_heads=1)
train("moonshot-v1-16b-a3b", W["moonshot"], dataclasses.replace(TRAIN_OPTS, remat="selective"), "train/moe")

# --- elastic restore: one rank's checkpoint onto the mesh, and back
qcfg = dataclasses.replace(CONFIGS["qwen3-4b"].reduced(), dtype="float32")
qlm = LM(qcfg)
specs = train_state_specs(qlm, mesh, rules)
ck1 = f"{work}/ckpt_single"
if rank == 0:
    save_checkpoint(ck1, state_of(W["qwen3"]), 4)
dist.barrier()
template = shard_train_state(state_of(W["qwen3"]), qlm, mesh, rules)
restored, step = load_checkpoint(ck1, template=template, shardings=specs, mesh=mesh)
def tensors(st):
    return tree_leaves({"params": st["params"], "opt": st["opt"]})
out["elastic/to_mesh"] = step == 4 and all(
    torch.equal(a, b) for a, b in zip(tensors(restored), tensors(template)))
with sharding_context(mesh, rules):
    restored, mm = make_train_step(qlm, tcfg, dataclasses.replace(TRAIN_OPTS, remat="none"))(
        restored, make_batch(qcfg, 4, 32, dtype=torch.float32))
out["elastic/loss"] = mm["loss"]
ck2 = f"{work}/ckpt_mesh"
save_checkpoint(ck2, restored, 5, shardings=specs, mesh=mesh)
whole = unshard_train_state(restored, qlm, mesh, rules)
if rank == 0:
    back, step = load_checkpoint(ck2, template=state_of(W["qwen3"]))
    out["elastic/to_single"] = step == 5 and all(
        torch.equal(a, b) for a, b in zip(tensors(back), tensors(whole)))

# --- compressed sync over a 4-way data mesh, two rounds
m4 = make_mesh((4,), ("data",))
gs = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 4, 128)).astype(np.float32))
sync = make_compressed_grad_sync(m4, "data")
err = init_error_state({"g": gs[0, rank]})
for r in range(2):
    mean, err = sync({"g": gs[r, rank]}, err)
    out[f"comp/mean{r}"], out[f"comp/err{r}"] = mean["g"], err["g"]

# --- the pipeline: 8 layers over 4 stages, this stage's two
p4 = make_mesh((4,), ("pipe",))
rng = np.random.default_rng(0)
w = torch.from_numpy(rng.normal(0, 0.5, (8, 16, 16)).astype(np.float32))
x = torch.from_numpy(rng.normal(0, 1, (8, 16)).astype(np.float32))
loc = w[2 * rank:2 * rank + 2].clone().requires_grad_(True)
apply = make_pipelined_apply(lambda lp, h: torch.tanh(h @ lp["w"]), p4, "pipe", 4)
yp = apply({"w": loc}, x)
out["pipe/y"] = yp.detach()
out["pipe/g"] = torch.autograd.grad((yp ** 2).sum(), [loc])[0]

# --- build_pp_forward: 4 layers over 2 pod stages, batch over data
gcfg = dataclasses.replace(CONFIGS["granite-20b-code"].reduced(), dtype="float32", num_layers=4)
pm = make_mesh((2, 2), ("pod", "data"))
prules = default_rules(pm.axis_names)
prules["batch"] = ("data",)
gp = dict(W["granite"])
s = pm.coords["pod"]
gp["layers"] = tfm.layer_params({"layers": W["granite"]["layers"]}, slice(2 * s, 2 * s + 2))
toks = torch.from_numpy(np.random.default_rng(4).integers(0, gcfg.vocab_size, (8, 32)).astype(np.int32))
opts = ForwardOpts(attn_impl="dense", norm_impl="plain", remat="none")
with torch.no_grad():
    out["pp/logits"] = build_pp_forward(LM(gcfg), gcfg, pm, prules, opts, 2)(gp, toks)
torch.save(out, f"{work}/rank{rank}.pt")
dist.destroy_process_group()
print("RANK OK")
"""

PAIR = r"""
import dataclasses, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
from repro_torch.configs import CONFIGS, TrainConfig
from repro_torch.models import LM, make_batch
from repro_torch.parallel.mesh import make_mesh
from repro_torch.parallel.sharding import default_rules, sharding_context
from repro_torch.train import make_train_step, shard_train_state
from repro_torch.train.trainer import TRAIN_OPTS
from repro_torch.train.optimizer import init_opt_state, tree_leaves

W = torch.load(f"{work}/weights.pt")
out = {}
tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
split = make_mesh((1, 2), ("data", "model"))
srules = default_rules(split.axis_names)
for name in SPLIT_FAMILIES:
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32")
    lm = LM(cfg)
    params = W[name]
    st = shard_train_state({"params": params, "opt": init_opt_state(params), "step": 0},
                           lm, split, srules)
    step = make_train_step(lm, tcfg, TRAIN_OPTS)
    losses = []
    with sharding_context(split, srules):
        for i in range(2):
            st, m = step(st, make_batch(cfg, 2, 32, dtype=torch.float32))
            losses.append(m["loss"])
    out[f"split/{name}/loss"] = losses
    out[f"split/{name}/params"] = tree_leaves(st["params"])
mesh = make_mesh((2,), ("data",))
rules = default_rules(mesh.axis_names)
cfg = dataclasses.replace(CONFIGS["zamba2-1.2b"].reduced(), dtype="float32")
lm = LM(cfg)
p = W["zamba2"]
st = shard_train_state({"params": p, "opt": init_opt_state(p), "step": 0}, lm, mesh, rules)
tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
step = make_train_step(lm, tcfg, dataclasses.replace(TRAIN_OPTS, remat="none"))
losses = []
with sharding_context(mesh, rules):
    for i in range(2):
        st, m = step(st, make_batch(cfg, 4, 32, dtype=torch.float32))
        losses.append(m["loss"])
out["zamba2/loss"] = losses
out["zamba2/params"] = tree_leaves(st["params"])
torch.save(out, f"{work}/pair{rank}.pt")
dist.destroy_process_group()
print("PAIR OK")
"""


def _redraw(lm, params, seed: int):
    """Every leaf that init sets to zeros or ones (biases, norms, rwkv6's
    mixing coefficients, mamba2's D), drawn around that value from
    ``seed``, in place.  A zero bias hides a dropped one, and AdamW's step
    on a leaf whose gradient is rounding noise (softmax makes K's bias
    gradient zero) moves a zero parameter past GRAD's atol, where a
    nonzero one stays inside its rtol."""
    gen = torch.Generator().manual_seed(seed)
    for path, p in spec_leaves(lm.spec()):
        if p.init in ("zeros", "ones"):
            *parents, last = path.split("/")
            node = params
            for k in parents:
                node = node[k]
            node[last] = (float(p.init == "ones")
                          + 0.2 * torch.randn(p.shape, generator=gen))
    return params


def _weights(work: Path):
    """The port's weights for each case (fp32, from seeds), saved for the
    ranks (torch) and the oracle (numpy, the JAX tree's paths)."""
    w = {}
    for key, name, kw in (("qwen3", "qwen3-4b", {}),
                          ("mqa", "qwen3-4b", {"num_kv_heads": 1}),
                          ("moonshot", "moonshot-v1-16b-a3b", {}),
                          ("zamba2", "zamba2-1.2b", {})):
        w[key] = LM(_cfg(name, **kw)).init(3, device="cpu",
                                           dtype=torch.float32)
    for i, name in enumerate(SPLIT_FAMILIES):
        lm = LM(_cfg(name))
        w[name] = _redraw(lm, lm.init(0, device="cpu", dtype=torch.float32),
                          21 + i)
    w["granite"] = LM(_cfg("granite-20b-code", num_layers=4)).init(
        5, device="cpu", dtype=torch.float32)
    torch.save(w, work / "weights.pt")
    np.savez(work / "weights.npz",
             **{f"{k}/{p}": v for k in ("qwen3", "moonshot", "granite")
                for p, v in _flat(_np_tree(w[k])).items()})
    return w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    weights = _weights(work)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_ORACLE, str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(devices=4), cwd=ROOT)]
    for script, n in ((RANKS, 4), (PAIR, 2)):
        port = _free_port()
        script = f"SPLIT_FAMILIES = {SPLIT_FAMILIES!r}\n" + script
        procs += [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(port), str(work)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=ROOT) for r in range(n)]
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-4000:]
    finally:
        for p in procs:
            p.kill()
    return {"jax": dict(np.load(work / "jax.npz")),
            "ranks": [torch.load(work / f"rank{r}.pt") for r in range(4)],
            "pair": [torch.load(work / f"pair{r}.pt") for r in range(2)],
            "weights": weights}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def _mesh(r):
    return Mesh(*MESH22).place(r)


def _rows(r):
    d = r // 2
    return slice(2 * d, 2 * d + 2)


@pytest.mark.parametrize("bias", [0, 1])
@pytest.mark.parametrize("name", ["o_proj", "col2", "col3", "down"])
def test_tp_contractions_match_jax(runs, name, bias):
    """Each rank's output rows of ``o_proj_tp``, ``col_proj_tp`` (a 2-D and
    a 3-D kernel) and ``down_proj_tp`` against JAX's shard_map forms on
    the 2×2 mesh; column-parallel outputs are this rank's columns."""
    want = runs["jax"][f"tp/{name}/{bias}"]
    for r, res in enumerate(runs["ranks"]):
        exp = want[_rows(r)]
        if name.startswith("col"):
            m = r % 2
            exp = np.split(exp, 2, axis=2)[m]
        _close(res[f"tp/{name}/{bias}"].numpy(), exp, FWD)


def test_seq_sharded_attention_matches_jax(runs):
    for r, res in enumerate(runs["ranks"]):
        _close(res["seqattn/y"].numpy(), runs["jax"]["seqattn/y"][_rows(r)],
               FWD)


def test_moe_ffn_ep_matches_jax(runs):
    """Per-rank capacity (JAX's EP, not the single-device groups): y rows
    and the aux loss averaged over the dp and model groups."""
    for r, res in enumerate(runs["ranks"]):
        _close(res["ep/y"].detach().numpy(), runs["jax"]["ep/y"][_rows(r)],
               FWD)
        _close(res["ep/aux"].detach().numpy(), runs["jax"]["ep/aux"], FWD)


def test_compressed_allreduce_mean_matches_jax(runs):
    """Two rounds, the second from the first's residual: the mean of the
    dequantized int8 values is JAX's to fp32 rounding (the mean's sum runs
    in another order), each rank's residual JAX's row exactly."""
    for r, res in enumerate(runs["ranks"]):
        for i in range(2):
            _close(res[f"comp/mean{i}"].numpy(),
                   runs["jax"][f"comp/mean{i}"][0], FWD)
            np.testing.assert_array_equal(res[f"comp/err{i}"].numpy(),
                                          runs["jax"][f"comp/err{i}"][r])


def test_pipelined_apply_matches_jax_and_the_sequential_loop(runs):
    """Forward and gradients of sum(y²) over 4 stages, 4 microbatches,
    against the port's sequential loop at GRAD and against JAX's pipeline
    at GRAD's rtol with an atol of 2e-5 of the largest gradient: XLA's and
    torch's tanh round differently and 8 chained layers carry it (JAX's
    own sequential loop and torch's differ by 7e-5 in gradients up to
    9)."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 0.5, (8, 16, 16)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (8, 16)).astype(np.float32))
    ws = w.clone().requires_grad_(True)
    h = x
    for i in range(8):
        h = torch.tanh(h @ ws[i])
    gseq = torch.autograd.grad((h ** 2).sum(), [ws])[0]
    for r, res in enumerate(runs["ranks"]):
        _close(res["pipe/y"].numpy(), runs["jax"]["pipe/y"], FWD)
        _close(res["pipe/y"].numpy(), h.detach().numpy(), FWD)
        sl = slice(2 * r, 2 * r + 2)
        jg = runs["jax"]["pipe/g"]
        _close(res["pipe/g"].numpy(), jg[sl],
               dict(rtol=GRAD["rtol"], atol=2e-5 * np.abs(jg).max()))
        _close(res["pipe/g"].numpy(), gseq[sl].numpy(), GRAD)


def _single_rank(runs, key, cfg, variant_kw=None, remat="none", seq=64):
    """The single-rank port on the ranks' weights and batch: the step-0
    loss and gradients, and the parameters after two steps."""
    lm = LM(cfg)
    tcfg = TrainConfig(**TCFG)
    opts = dataclasses.replace(TRAIN_OPTS, remat=remat, **(variant_kw or {}))
    batch = make_batch(cfg, 4, seq, dtype=torch.float32)
    state = init_train_state(lm, 0, tcfg, device="cpu")
    for t, w in zip(tree_leaves(state["params"]),
                    tree_leaves(runs["weights"][key])):
        t.copy_(w)
    leaves = tree_leaves(state["params"])
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss(state["params"], batch, opts,
                      moe_aux_weight=tcfg.moe_aux_loss, z_loss=tcfg.z_loss)
    grads = torch.autograd.grad(loss, leaves)
    step = make_train_step(lm, tcfg, opts)
    for _ in range(2):
        state, _ = step(state, batch)
    return lm, float(loss.detach()), grads, tree_leaves(state["params"])


def _lr_sum():
    return sum(lr_schedule(TrainConfig(**TCFG), i) for i in range(2))


def _assert_adam_close(ours, theirs, path):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    off = ~np.isclose(ours, theirs, **GRAD)
    assert off.mean() <= ADAM_OUTLIERS, (path, int(off.sum()))
    assert (np.abs(ours - theirs)[off] <= 2 * _lr_sum()).all(), path


def _shards(lm, full_leaves, mesh):
    """Each leaf of a whole parameter tree (in ``tree_leaves`` order) as
    ``mesh``'s rank holds it."""
    rules = default_rules(mesh.axis_names)
    return [shard(torch.as_tensor(np.asarray(f)),
                  spec_for(p.axes, p.shape, rules, mesh), mesh).numpy()
            for (_, p), f in zip(spec_leaves(lm.spec()), full_leaves)]


def _check_train(runs, key, lm, loss, grads, params, jax_key=None):
    for r, res in enumerate(runs["ranks"]):
        mesh = _mesh(r)
        _close(res[f"{key}/loss"], loss, FWD)
        for (path, _), got, want in zip(
                spec_leaves(lm.spec()), res[f"{key}/grads"],
                _shards(lm, [g.numpy() for g in grads], mesh)):
            _close(got.numpy(), want, GRAD)
        for (path, _), got, want in zip(
                spec_leaves(lm.spec()), res[f"{key}/params"],
                _shards(lm, [p.detach().numpy() for p in params], mesh)):
            _assert_adam_close(got.detach().numpy(), want, path)
        if jax_key is None:
            continue
        jax_out = runs["jax"]
        _close(res[f"{key}/loss"], jax_out[f"train/{jax_key}/loss"], FWD)
        paths = [path for path, _ in spec_leaves(lm.spec())]
        for path, got, want in zip(paths, res[f"{key}/grads"], _shards(
                lm, [jax_out[f"train/{jax_key}/grads/{p}"] for p in paths],
                mesh)):
            _close(got.numpy(), want, GRAD)
        for path, got, want in zip(paths, res[f"{key}/params"], _shards(
                lm, [jax_out[f"train/{jax_key}/params/{p}"] for p in paths],
                mesh)):
            _assert_adam_close(got.detach().numpy(), want, path)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_train_step_matches_jax_and_single_rank(runs, variant):
    """qwen3-4b.reduced() on the 2×2 mesh (every rule divides: heads,
    kv_heads, mlp, vocab over model, embed over data): each rank's loss,
    gradient shards at step 0 and parameter shards after a step with
    lr > 0 against JAX's sharded step (Auto axes) and the single-rank
    port."""
    lm, loss, grads, params = _single_rank(runs, "qwen3", _cfg("qwen3-4b"),
                                           VARIANTS[variant])
    _check_train(runs, f"train/{variant}", lm, loss, grads, params, variant)


def test_dropped_rule_and_expert_split_match_single_rank(runs):
    """MQA (one K/V head: ``kv_heads`` drops and K/V run whole on every
    rank while q heads split) and moonshot's experts split over the model
    axis (routing and dispatch on every rank, each rank's experts, the
    partial sums reduced; under selective remat) against the single-rank
    port."""
    lm, loss, grads, params = _single_rank(
        runs, "mqa", _cfg("qwen3-4b", num_kv_heads=1))
    _check_train(runs, "train/mqa", lm, loss, grads, params)
    lm, loss, grads, params = _single_rank(
        runs, "moonshot", _cfg("moonshot-v1-16b-a3b"))
    _check_train(runs, "train/moe", lm, loss, grads, params)


def test_selective_remat_runs_no_collective_again(runs):
    """A step's collectives under ``remat="selective"`` are those of
    ``"none"``: the policy saves each collective's output, so the backward's
    replay of a layer runs none again; gradients are the same."""
    for res in runs["ranks"]:
        assert res["train/selective/collectives"] > 0
        assert res["train/selective/collectives"] == \
            res["train/default/collectives"]
        for a, b in zip(res["train/selective/grads"],
                        res["train/default/grads"]):
            _close(a.numpy(), b.numpy(), GRAD)


def test_elastic_restore_both_ways(runs):
    """A checkpoint one rank wrote restores onto the 2×2 mesh bit for bit
    (each rank keeps its slices) and trains; the 2×2 mesh's checkpoint
    (gathered whole, written by rank 0) restores onto one rank bit for
    bit."""
    for res in runs["ranks"]:
        assert res["elastic/to_mesh"] is True
        assert np.isfinite(float(res["elastic/loss"]))
    assert runs["ranks"][0]["elastic/to_single"] is True


def test_pp_forward_matches_lm_forward(runs):
    """``build_pp_forward`` over 2 pod stages × 2 data ranks, 2
    microbatches: every rank's logits equal the port's ``LM.forward`` and
    JAX's on the same weights."""
    cfg = _cfg("granite-20b-code", num_layers=4)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))
    opts = ForwardOpts(attn_impl="dense", norm_impl="plain", remat="none")
    with torch.no_grad():
        want, _ = LM(cfg).forward(runs["weights"]["granite"], toks, opts)
    for res in runs["ranks"]:
        _close(res["pp/logits"].numpy(), want.numpy(), FWD)
        _close(res["pp/logits"].numpy(), runs["jax"]["pp/logits"], FWD)


@pytest.mark.parametrize("name", SPLIT_FAMILIES)
def test_model_split_train_step_matches_single_rank(runs, name):
    """zamba2, rwkv6 and seamless on a 1×2 ``data × model`` mesh (the
    mixers, attention and MLPs split over the model axis; the train step's
    own opts, selective remat; zero- and one-initialised leaves redrawn):
    the losses of two steps and every parameter shard after them against
    one rank."""
    cfg = _cfg(name)
    lm = LM(cfg)
    tcfg = TrainConfig(**TCFG)
    state = init_train_state(lm, 0, tcfg, device="cpu")
    for t, w in zip(tree_leaves(state["params"]),
                    tree_leaves(runs["weights"][name])):
        t.copy_(w)
    step = make_train_step(lm, tcfg, TRAIN_OPTS)
    losses = []
    for _ in range(2):
        state, m = step(state, make_batch(cfg, 2, 32, dtype=torch.float32))
        losses.append(float(m["loss"]))
    whole = [p.detach().numpy() for p in tree_leaves(state["params"])]
    for r, res in enumerate(runs["pair"]):
        mesh = Mesh((1, 2), ("data", "model")).place(r)
        _close([float(x) for x in res[f"split/{name}/loss"]], losses, FWD)
        for (path, _), got, want in zip(spec_leaves(lm.spec()),
                                        res[f"split/{name}/params"],
                                        _shards(lm, whole, mesh)):
            assert got.shape == want.shape, path
            _assert_adam_close(got.detach().numpy(), want, path)


def test_zamba2_data_only_step_matches_single_rank(runs):
    """zamba2 on a 2-rank ``data`` mesh (FSDP and DP, no model split):
    losses and parameter shards after two steps against one rank."""
    cfg = _cfg("zamba2-1.2b")
    lm = LM(cfg)
    tcfg = TrainConfig(**TCFG)
    state = init_train_state(lm, 0, tcfg, device="cpu")
    for t, w in zip(tree_leaves(state["params"]),
                    tree_leaves(runs["weights"]["zamba2"])):
        t.copy_(w)
    step = make_train_step(lm, tcfg, dataclasses.replace(TRAIN_OPTS,
                                                         remat="none"))
    losses = []
    for _ in range(2):
        state, m = step(state, make_batch(cfg, 4, 32, dtype=torch.float32))
        losses.append(float(m["loss"]))
    whole = [p.detach().numpy() for p in tree_leaves(state["params"])]
    for r, res in enumerate(runs["pair"]):
        mesh = Mesh((2,), ("data",)).place(r)
        _close([float(x) for x in res["zamba2/loss"]], losses, FWD)
        for (path, _), got, want in zip(spec_leaves(lm.spec()),
                                        res["zamba2/params"],
                                        _shards(lm, whole, mesh)):
            _assert_adam_close(got.detach().numpy(), want, path)
