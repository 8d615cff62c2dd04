"""Tensor parallelism of the hybrid (zamba2), ssm (rwkv6) and enc-dec
(seamless) families on gloo rank processes, against the JAX package's
sharded step and against the single-rank port.

One JAX subprocess (4 host devices, a 2×2 mesh of ``Auto`` axes, as
``tests/test_torch_parallel.py`` builds it) writes each family's sharded
loss and gradients at step 0, the parameters after two steps of JAX's own
``adamw_update`` on them (``lr_schedule`` gives lr 0 at step 0, so the
parameters and hence the gradient of step 1 are step 0's), and JAX's
single-device ``LM.decode_step`` over a random dense cache.  Four port
ranks (a 2×2 ``data × model`` mesh) train each family under the default
opts, ``tp_shardmap`` and selective remat, and decode over
``shard_cache``'s shards; two more (a 1×2 mesh) run the prefill that
collects the cache and the same decode.  Held in fp32 at
``tests/test_torch_train.py``'s tolerances.  The weights are the port's
(``LM.init``), with every leaf that init sets to zeros or ones (biases,
norms, rwkv6's mixing coefficients, mamba2's D) redrawn from a seed, so a
dropped or misrouted one shows.  JAX's zamba2 takes ``tp_shardmap`` (its
mamba block's in- and out-projections run through ``tpmm``); its rwkv6 and
enc-dec take none, so their ``tp_shardmap`` steps are held to JAX's
default one."""
import dataclasses
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
from repro_torch.parallel.sharding import (default_rules, logical_to_sharding,
                                           shard, spec_for)
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.trainer import TRAIN_OPTS
from test_torch_parallel import (TCFG, _assert_adam_close, _close, _env,
                                 _flat, _free_port, _redraw)
from test_torch_tenancy import one_torch_thread  # noqa: F401
from test_torch_train import FWD, GRAD

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("zamba2-1.2b", "rwkv6-1.6b", "seamless-m4t-large-v2")
VARIANTS = {"default": {}, "tp_shardmap": {"tp_shardmap": True}}
#: the families whose JAX forward reads ``tp_shardmap``
JAX_TP_SHARDMAP = ("zamba2-1.2b",)
B, S = 4, 32                         # the train and prefill batch
DEC_S, STEPS = 16, 3                 # the decode cache's rows, its steps
POSITIONS = (5, 9, 2, 12)
MESH22 = ((2, 2), ("data", "model"))
MESH12 = ((1, 2), ("data", "model"))
#: the families long_500k applies to (sub-quadratic state), decoded under
#: its rules too
LONG = ("zamba2-1.2b", "rwkv6-1.6b")


def _cfg(name):
    return dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32")


def _inputs(work: Path):
    """Each family's weights, a random dense decode cache and STEPS tokens
    a slot, from seeds, for the ranks (torch) and the oracle (numpy)."""
    w, arrays = {}, {"positions": np.array(POSITIONS, np.int32)}
    for i, name in enumerate(FAMILIES):
        cfg = _cfg(name)
        lm = LM(cfg)
        params = _redraw(lm, lm.init(3, device="cpu", dtype=torch.float32),
                         11 + i)
        gen = torch.Generator().manual_seed(7)
        cache = lm.init_cache(B, DEC_S, backend=None, device="cpu")
        for t in _flat(cache).values():
            t.normal_(generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (STEPS, B, 1),
                             generator=gen, dtype=torch.int32)
        w[name] = {"params": params, "cache": cache, "tokens": toks}
        for part, tree in (("params", params), ("cache", cache)):
            arrays.update({f"{name}/{part}/{k}": v.numpy()
                           for k, v in _flat(tree).items()})
        arrays[f"{name}/tokens"] = toks.numpy()
    torch.save(w, work / "weights.pt")
    np.savez(work / "weights.npz", **arrays)
    return w


# ------------------------------------------------------------ the oracle --

JAX_ORACLE = r"""
import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import CONFIGS, TrainConfig
from repro.models import LM, ForwardOpts, make_batch
from repro.parallel.sharding import default_rules, logical_to_sharding, sharding_context
from repro.train.optimizer import adamw_update, init_opt_state

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
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rules = default_rules(mesh.axis_names)
tcfg = TrainConfig(**TCFG)
update = jax.jit(lambda g, o, p, s: adamw_update(g, o, p, s, tcfg))
for name in FAMILIES:
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32")
    lm = LM(cfg)
    batch = make_batch(cfg, B, S, dtype=jnp.float32)
    psh = logical_to_sharding(lm.param_logical_axes(), lm.abstract_params(), mesh, rules)
    for variant in (("default", "tp_shardmap") if name in JAX_TP_SHARDMAP else ("default",)):
        opts = ForwardOpts(attn_impl="blockwise", remat="none", tp_shardmap=variant == "tp_shardmap")
        params = tree(f"{name}/params")
        def grads(p, b, opts=opts):
            with sharding_context(mesh, rules):
                return jax.value_and_grad(lambda p: lm.loss(
                    p, b, opts, moe_aux_weight=tcfg.moe_aux_loss, z_loss=tcfg.z_loss), has_aux=True)(p)
        with mesh:
            (loss, _), g = jax.jit(grads, in_shardings=(psh, None))(params, batch)
        # the train step's body on those gradients, twice: step 0's lr is 0,
        # so step 1 takes the same parameters and hence the same gradient
        opt = init_opt_state(params)
        for i in range(2):
            params, opt, _ = update(g, opt, params, jnp.int32(i))
        out[f"{name}/{variant}/loss"] = np.asarray(loss)
        put(f"{name}/{variant}/grads", g)
        put(f"{name}/{variant}/params", params)
    params, cache = tree(f"{name}/params"), tree(f"{name}/cache")
    step = jax.jit(lm.decode_step)
    for i in range(STEPS):
        logits, cache = step(params, jnp.asarray(W[f"{name}/tokens"][i]), cache,
                             jnp.asarray(W["positions"]) + i)
        out[f"{name}/decode/{i}"] = np.asarray(logits)
np.savez(f"{work}/jax.npz", **out)
print("ORACLE OK")
"""


# ----------------------------------------------------------- port ranks --

_RANK_HEAD = r"""
import dataclasses, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=WORLD)
from repro_torch.configs import CONFIGS, TrainConfig
from repro_torch.models import LM, ForwardOpts, make_batch
from repro_torch.parallel.collectives import CollectiveCounter
from repro_torch.parallel.mesh import make_mesh
from repro_torch.parallel.sharding import (batch_rows, default_rules, logical_to_sharding,
                                           shard_tree, sharding_context)
from repro_torch.train import make_train_step, shard_train_state
from repro_torch.train.trainer import TRAIN_OPTS
from repro_torch.train.optimizer import init_opt_state, tree_leaves

W = torch.load(f"{work}/weights.pt")
out = {}
def clone(t):
    return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()
mesh = make_mesh(*MESH)
rules = default_rules(mesh.axis_names)
positions = torch.tensor(POSITIONS, dtype=torch.int32)

def decode(name, lm, rules=rules, key="decode"):
    # STEPS decode steps over this rank's shards of the dense cache
    params = W[name]["params"]
    sp = shard_tree(params, logical_to_sharding(lm.param_logical_axes(), params, mesh, rules), mesh)
    cache = lm.shard_cache(clone(W[name]["cache"]), mesh, rules)
    got = []
    with torch.no_grad(), sharding_context(mesh, rules):
        for i in range(STEPS):
            got.append(lm.decode_step(sp, W[name]["tokens"][i], cache, positions + i)[0])
    out[f"{name}/{key}"] = got
    out[f"{name}/{key}/cache"] = {k: v for k, v in cache.items() if k != "global_shapes"}
    return sp
"""

RANKS = _RANK_HEAD + r"""
tcfg = TrainConfig(**TCFG)
for name in FAMILIES:
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32")
    lm = LM(cfg)
    batch = make_batch(cfg, B, S, dtype=torch.float32)
    r = batch_rows(mesh, rules, B)
    for variant, kw in (("default", {}), ("tp_shardmap", {"tp_shardmap": True}),
                        ("selective", {})):
        opts = dataclasses.replace(TRAIN_OPTS, remat="selective" if variant == "selective" else "none", **kw)
        p = clone(W[name]["params"])
        st = shard_train_state({"params": p, "opt": init_opt_state(p), "step": 0}, lm, mesh, rules)
        leaves = tree_leaves(st["params"])
        for t in leaves:
            t.requires_grad_(True)
        cc = CollectiveCounter()
        with sharding_context(mesh, rules):
            with cc:
                loss, met = lm.loss(st["params"], {k: v[r] for k, v in batch.items()}, opts,
                                    moe_aux_weight=tcfg.moe_aux_loss, z_loss=tcfg.z_loss)
                grads = torch.autograd.grad(loss, leaves)
            if variant != "selective":
                for t in leaves:
                    t.requires_grad_(False)
                step = make_train_step(lm, tcfg, opts)
                for i in range(2):
                    st, _ = step(st, batch)
                out[f"{name}/{variant}/params"] = tree_leaves(st["params"])
        out[f"{name}/{variant}/loss"] = met["loss"]
        out[f"{name}/{variant}/grads"] = list(grads)
        out[f"{name}/{variant}/collectives"] = cc.total
    decode(name, lm)
    if name in LONG:
        decode(name, lm, default_rules(mesh.axis_names, seq_sharded_cache=True),
               "decode_long")
torch.save(out, f"{work}/rank{rank}.pt")
dist.destroy_process_group()
print("RANK OK")
"""

PAIR = _RANK_HEAD + r"""
for name in FAMILIES:
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32")
    lm = LM(cfg)
    sp = decode(name, lm)
    batch = make_batch(cfg, B, S, dtype=torch.float32)
    with torch.no_grad(), sharding_context(mesh, rules):
        logits, cache = lm.prefill(sp, batch["tokens"], ForwardOpts(),
                                   enc_embeds=batch.get("enc_embeds"))
    out[f"{name}/prefill"] = (logits, cache)
torch.save(out, f"{work}/pair{rank}.pt")
dist.destroy_process_group()
print("PAIR OK")
"""


def _prelude(world: int, mesh) -> str:
    return (f"FAMILIES = {FAMILIES!r}\nJAX_TP_SHARDMAP = {JAX_TP_SHARDMAP!r}\n"
            f"LONG = {LONG!r}\n"
            f"B, S, DEC_S, STEPS = {B}, {S}, {DEC_S}, {STEPS}\n"
            f"POSITIONS = {POSITIONS!r}\nTCFG = {TCFG!r}\n"
            f"WORLD = {world}\nMESH = {mesh!r}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_families")
    inputs = _inputs(work)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _prelude(4, MESH22) + JAX_ORACLE, str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(devices=4), cwd=ROOT)]
    for script, n, mesh in ((RANKS, 4, MESH22), (PAIR, 2, MESH12)):
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", _prelude(n, mesh) + script, str(r),
             str(port), str(work)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
            for r in range(n)]
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-4000:]
    finally:
        for p in procs:
            p.kill()
    return {"inputs": inputs, "jax": dict(np.load(work / "jax.npz")),
            "ranks": [torch.load(work / f"rank{r}.pt") for r in range(4)],
            "pair": [torch.load(work / f"pair{r}.pt") for r in range(2)]}


# ------------------------------------------------------- the single rank --

_SINGLE = {}


def _single(runs, name):
    """The single-rank port on the ranks' inputs: the step-0 loss and
    gradients and the parameters after two steps (remat none), the
    decode's logits and final cache, the prefill's last logits and
    cache."""
    if name in _SINGLE:
        return _SINGLE[name]
    inputs = runs["inputs"][name]
    lm = LM(_cfg(name))
    tcfg = TrainConfig(**TCFG)
    opts = dataclasses.replace(TRAIN_OPTS, remat="none")
    batch = make_batch(lm.cfg, B, S, dtype=torch.float32)
    state = init_train_state(lm, 0, tcfg, device="cpu")
    for t, w in zip(tree_leaves(state["params"]),
                    tree_leaves(inputs["params"])):
        t.copy_(w)
    leaves = tree_leaves(state["params"])
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss(state["params"], batch, opts,
                      moe_aux_weight=tcfg.moe_aux_loss, z_loss=tcfg.z_loss)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    step = make_train_step(lm, tcfg, opts)
    for _ in range(2):
        state, _ = step(state, batch)
    cache = {k: {n: t.clone() for n, t in v.items()}
             for k, v in inputs["cache"].items()}
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    with torch.no_grad():
        logits = [lm.decode_step(inputs["params"], inputs["tokens"][i],
                                 cache, pos + i)[0] for i in range(STEPS)]
        prefill = lm.prefill(inputs["params"], batch["tokens"],
                             ForwardOpts(), enc_embeds=batch.get("enc_embeds"))
    _SINGLE[name] = dict(lm=lm, loss=float(loss.detach()), grads=grads,
                         params=tree_leaves(state["params"]), logits=logits,
                         cache=cache, prefill=prefill)
    return _SINGLE[name]


def _shards(lm, leaves, mesh):
    """Each whole parameter leaf (``tree_leaves`` order) as ``mesh``'s rank
    holds it."""
    rules = default_rules(mesh.axis_names)
    return [shard(torch.as_tensor(np.asarray(f)),
                  spec_for(p.axes, p.shape, rules, mesh), mesh).numpy()
            for (_, p), f in zip(spec_leaves(lm.spec()), leaves)]


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- the tests --

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_train_step_matches_jax_and_single_rank(runs, name, variant):
    """Each rank of the 2×2 mesh: the loss, every gradient leaf's shard at
    step 0 and every parameter's shard after two steps (lr > 0 at the
    second) against JAX's sharded step and the single-rank port.  The
    whole-on-every-rank leaves read in part (rwkv6's decay LoRA and
    ``ln_x``, mamba2's B/C path) show a missing ``copy_to`` only here, in
    their gradients."""
    one = _single(runs, name)
    lm, jax_out = one["lm"], runs["jax"]
    jkey = variant if name in JAX_TP_SHARDMAP else "default"
    paths = [path for path, _ in spec_leaves(lm.spec())]
    for r, res in enumerate(runs["ranks"]):
        mesh = Mesh(*MESH22).place(r)
        key = f"{name}/{variant}"
        _close(res[f"{key}/loss"], one["loss"], FWD)
        _close(res[f"{key}/loss"], jax_out[f"{name}/{jkey}/loss"], FWD)
        for want in (_shards(lm, [g.numpy() for g in one["grads"]], mesh),
                     _shards(lm, [jax_out[f"{name}/{jkey}/grads/{p}"]
                                  for p in paths], mesh)):
            for path, got, w in zip(paths, res[f"{key}/grads"], want):
                assert got.shape == w.shape, path
                _close(got.numpy(), w, GRAD)
        for want in (_shards(lm, [p.detach().numpy() for p in one["params"]],
                             mesh),
                     _shards(lm, [jax_out[f"{name}/{jkey}/params/{p}"]
                                  for p in paths], mesh)):
            for path, got, w in zip(paths, res[f"{key}/params"], want):
                _assert_adam_close(got.detach().numpy(), w, path)


@pytest.mark.parametrize("name", FAMILIES)
def test_selective_remat_runs_no_collective_again(runs, name):
    """The step-0 backward under ``remat="selective"`` runs the
    collectives of ``"none"``, the new ones (the mixers' ``copy_to``\\s,
    the split norm's all-reduce, cmix's receptance gather) included:
    the policy saves each collective's output.  Gradients are the same."""
    for res in runs["ranks"]:
        assert res[f"{name}/selective/collectives"] > 0
        assert res[f"{name}/selective/collectives"] == \
            res[f"{name}/default/collectives"]
        for a, b in zip(res[f"{name}/selective/grads"],
                        res[f"{name}/default/grads"]):
            _close(a.numpy(), b.numpy(), GRAD)


def _cache_slices(name, cfg, cache, m: int):
    """The single rank's prefill cache as model rank ``m`` of two collects
    it: its heads (and a hybrid conv state's own x channels, then B and
    C); rwkv6's shift states whole."""
    def heads(t, dim):
        n = t.shape[dim] // 2
        return t.narrow(dim, m * n, n)
    lay = cache["layers"]
    if name == "rwkv6-1.6b":
        return {"layers": {"shift1": lay["shift1"], "shift2": lay["shift2"],
                           "wkv": heads(lay["wkv"], 2)}}
    if name == "seamless-m4t-large-v2":
        return {"layers": {k: heads(v, 3) for k, v in lay.items()}}
    din = cfg.d_inner
    conv = torch.cat([heads(lay["conv"][..., :din], 3),
                      lay["conv"][..., din:]], dim=-1)
    return {"layers": {"conv": conv, "ssm": heads(lay["ssm"], 2)},
            "shared": {k: heads(v, 3) for k, v in cache["shared"].items()}}


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_collects_this_ranks_states(runs, name):
    """``LM.prefill`` on the 1×2 mesh: the whole batch's last logits on
    both ranks, and a cache of this rank's heads' states (zamba2's conv
    state: its x channels, then B and C), each equal to the single rank's
    slice."""
    one = _single(runs, name)
    want_logits, want_cache = one["prefill"]
    for m, res in enumerate(runs["pair"]):
        logits, cache = res[f"{name}/prefill"]
        _close(_np(logits), _np(want_logits), FWD)
        want = _flat(_cache_slices(name, one["lm"].cfg, want_cache, m))
        got = _flat(cache)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            _close(_np(got[k]), _np(want[k]), FWD)


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_decode_matches_single_rank_and_jax(runs, name):
    """STEPS decode steps over ``shard_cache``'s shards on the 2×2 and the
    1×2 mesh: every rank's logits (the whole batch's) against the single
    rank and JAX's ``LM.decode_step``, and every rank's cache shard after
    the steps against the single rank's final cache, as ``shard_cache``
    cuts it.  zamba2's conv shard does not line up with the mixer's split:
    its d_inner + 2N columns halve at a point inside the x channels' second
    half, so rank 0 holds part of rank 1's channels and rank 1 B and C."""
    one = _single(runs, name)
    cfg = one["lm"].cfg
    if name == "zamba2-1.2b":
        cols = cfg.d_inner + 2 * cfg.ssm_state
        assert cols % 2 == 0 and cols // 2 != cfg.d_inner // 2
    for mesh_def, results in ((MESH22, runs["ranks"]),
                              (MESH12, runs["pair"])):
        for r, res in enumerate(results):
            mesh = Mesh(*mesh_def).place(r)
            rules = default_rules(mesh.axis_names)
            for i, got in enumerate(res[f"{name}/decode"]):
                assert got.shape == (B, 1, cfg.padded_vocab)
                _close(_np(got), _np(one["logits"][i]), FWD)
                _close(_np(got), runs["jax"][f"{name}/decode/{i}"], FWD)
            whole = one["cache"]
            specs = logical_to_sharding(one["lm"].cache_logical_axes(whole),
                                        whole, mesh, rules)
            got = _flat(res[f"{name}/decode/cache"])
            for k, t in _flat(whole).items():
                spec = _flat(specs)[k]
                want = shard(t, spec, mesh)
                assert got[k].shape == want.shape, k
                _close(_np(got[k]), _np(want), FWD)
            if name == "zamba2-1.2b":
                conv = got["layers/conv"]
                assert conv.shape[-1] == (cfg.d_inner
                                          + 2 * cfg.ssm_state) // 2


@pytest.mark.parametrize("name", LONG)
def test_long_context_decode_matches_single_rank(runs, name):
    """The decode under long_500k's rules (``seq_sharded_cache``: the batch
    whole on every rank, the sequence split over ``data × model``, the
    weights' ``embed`` dims still split over ``data`` and gathered for use
    with a slice backward, the shift states' ``embed`` split over
    ``data``) on the 2×2 mesh: every rank's logits and cache shards against
    the single rank's, as ``shard_cache`` cuts them under those rules."""
    one = _single(runs, name)
    for r, res in enumerate(runs["ranks"]):
        mesh = Mesh(*MESH22).place(r)
        rules = default_rules(mesh.axis_names, seq_sharded_cache=True)
        for i, got in enumerate(res[f"{name}/decode_long"]):
            _close(_np(got), _np(one["logits"][i]), FWD)
        whole = one["cache"]
        specs = _flat(logical_to_sharding(
            one["lm"].cache_logical_axes(whole), whole, mesh, rules))
        got = _flat(res[f"{name}/decode_long/cache"])
        for k, t in _flat(whole).items():
            want = shard(t, specs[k], mesh)
            assert got[k].shape == want.shape, k
            _close(_np(got[k]), _np(want), FWD)
