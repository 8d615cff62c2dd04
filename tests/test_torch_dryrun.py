"""The dry-run of the port on the CPU: its configs and a cell's inputs against
the JAX package's, the sharded dense-cache decode step on 2×2 gloo ranks
against the single-rank port and JAX's ``LM.decode_step`` (and the
hybrid, ssm and enc-dec decode on a data-only mesh of four and on the 2×2
mesh's model split), the dry-run's
per-rank FLOPs and collectives against the same steps run for real on
those ranks (qwen3-4b's train and decode steps, zamba2's train step), and
the command line on full-size cells (``ok`` decode and hybrid train cells,
a skipped one, one made to raise) and ``pp_dryrun``'s.

Four gloo rank processes (the 2×2 ``data × model`` mesh) and one dry-run
process (a fake group of four ranks, each rank in turn) run at once: a
fake group takes the default process group, so no dry-run runs in this
process."""
import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JASSIGNED
from repro.configs import CONFIGS as JCONFIGS
from repro.configs import PAPER_ARCHS as JPAPER
from repro.configs import SHAPES as JSHAPES
from repro.configs import ParallelConfig as JParallel
from repro.configs import RunConfig as JRun
from repro.configs import applicable as japplicable
from repro.configs import list_configs as jlist
from repro.models import LM as JLM
from repro.models import input_logical_axes as jaxes
from repro.models import input_specs as jspecs
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.models import LM, input_logical_axes, input_specs
from repro_torch.models import transformer as ttfm
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CASES = {"qwen3": ("qwen3-4b", {}), "moonshot": ("moonshot-v1-16b-a3b", {})}
#: the hybrid, ssm and enc-dec families, decoded on a data-only mesh and
#: on the 2x2 mesh
DATA_ONLY = ("zamba2-1.2b", "rwkv6-1.6b", "seamless-m4t-large-v2")
B, S, STEPS, POS = 4, 16, 3, 9
TRAIN_B, TRAIN_S = 4, 64
TOL = dict(rtol=2e-5, atol=2e-5)


def _cfg(name, **kw):
    return dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32",
                               **kw)


# -------------------------------------------------------------- configs --

def test_shapes_and_applicable_equal_jax():
    assert list(tconfigs.SHAPES) == list(JSHAPES)
    for name, js in JSHAPES.items():
        ts = tconfigs.get_shape(name)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert ts.tokens_per_step == js.tokens_per_step
    for arch, jcfg in JCONFIGS.items():
        for js in JSHAPES.values():
            assert tconfigs.applicable(TCONFIGS[arch], tconfigs.get_shape(
                js.name)) == japplicable(jcfg, js), (arch, js.name)


def test_parallel_and_run_configs_equal_jax():
    tp, jp = tconfigs.ParallelConfig(), JParallel()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.num_devices == jp.num_devices == 256
    kw = dict(mesh_shape=(2, 16, 16), mesh_axes=("pod", "data", "model"))
    assert tconfigs.ParallelConfig(**kw).num_devices == \
        JParallel(**kw).num_devices == 512
    tr, jr = tconfigs.RunConfig(), JRun()
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    full = tconfigs.RunConfig(model=TCONFIGS["qwen3-4b"],
                              shape=tconfigs.get_shape("train_4k"))
    assert dataclasses.asdict(full) == dataclasses.asdict(
        JRun(model=JCONFIGS["qwen3-4b"], shape=JSHAPES["train_4k"]))


def test_registry_splits_equal_jax():
    assert list(tconfigs.ASSIGNED_ARCHS) == list(JASSIGNED)
    assert list(tconfigs.PAPER_ARCHS) == list(JPAPER)
    assert tconfigs.list_configs() == jlist()
    assert tconfigs.list_configs(assigned_only=True) == jlist(True)
    assert set(tconfigs.__all__) >= {
        "ModelConfig", "ParallelConfig", "RunConfig", "ShapeConfig",
        "TrainConfig", "SHAPES", "applicable", "get_shape", "get_config",
        "list_configs", "ASSIGNED_ARCHS", "PAPER_ARCHS", "CONFIGS"}


# --------------------------------------------------------------- inputs --

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jflat_axes(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {"/" + "/".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in leaves}


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", list(JASSIGNED))
def test_input_specs_and_axes_equal_jax(arch, shape):
    """Shapes and dtypes of every leaf, the logical axes of every leaf, and
    for a decode cell of the decoder stack the cache's own axes."""
    jcfg, tcfg = JASSIGNED[arch], TCONFIGS[arch]
    js, ts = JSHAPES[shape], tconfigs.get_shape(shape)
    jb, tb = _flat(jspecs(jcfg, js)), _flat(input_specs(tcfg, ts))
    assert jb.keys() == tb.keys()
    for k in jb:
        assert tb[k].device.type == "meta"
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
        assert str(tb[k].dtype) == f"torch.{jb[k].dtype}", k
    assert _flat(input_logical_axes(tcfg, ts)) == _jflat_axes(jaxes(jcfg,
                                                                   js))
    if js.kind == "decode" and jcfg.family != "encdec":
        jcache = JLM(jcfg).init_cache(js.global_batch, js.seq_len,
                                      abstract=True)
        tcache = LM(tcfg).init_cache(ts.global_batch, ts.seq_len,
                                     backend=None, device="meta")
        assert _flat(ttfm.cache_logical_axes(tcfg, tcache)) == _jflat_axes(
            jtfm.cache_logical_axes(jcfg, jcache))


# ------------------------------------------------ ranks and the dry-run --

RANKS = r"""
import dataclasses, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import CONFIGS, ShapeConfig, TrainConfig
from repro_torch.launch.dryrun import _forward_opts
from repro_torch.models import LM, make_batch
from repro_torch.parallel.collectives import CollectiveCounter
from repro_torch.parallel.mesh import make_mesh
from repro_torch.parallel.sharding import default_rules, logical_to_sharding, shard_tree, sharding_context
from repro_torch.roofline.collectives import parse_collectives
from repro_torch.train import make_train_step, shard_train_state
from repro_torch.train.optimizer import init_opt_state

W = torch.load(f"{work}/weights.pt")
mesh = make_mesh((2, 2), ("data", "model"))
rules = default_rules(mesh.axis_names)
out = {}
def clone(t):
    return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()
for key, (name, kw) in CASES.items():
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32", **kw)
    lm = LM(cfg)
    params = W[key]["params"]
    sp = shard_tree(params, logical_to_sharding(lm.param_logical_axes(), params, mesh, rules), mesh)
    for run, pos in (("uniform", torch.full((B,), POS, dtype=torch.int32)),
                     ("ragged", torch.tensor([5, 9, 2, 12], dtype=torch.int32))):
        single, cache = clone(W[key]["cache"]), lm.shard_cache(clone(W[key]["cache"]), mesh, rules)
        got, ref = [], []
        with torch.no_grad():
            for i in range(STEPS):
                ref.append(lm.decode_step(params, W[key]["tokens"][i], single, pos + i)[0])
                with sharding_context(mesh, rules):
                    got.append(lm.decode_step(sp, W[key]["tokens"][i], cache, pos + i)[0])
        out[f"{key}/{run}"], out[f"{key}/{run}/single"] = got, ref
        out[f"{key}/{run}/cache_k"] = cache["layers"]["k"]
    out[f"{key}/global_shapes"] = cache["global_shapes"]
    try:
        with torch.no_grad(), sharding_context(mesh, rules):
            lm.decode_step(sp, W[key]["tokens"][0], {"layers": cache["layers"]},
                           torch.full((B,), POS, dtype=torch.int32))
        out[f"{key}/no_shapes"] = ""
    except ValueError as e:
        out[f"{key}/no_shapes"] = str(e)
    if key != "qwen3":
        continue
    # the counted steps the dry-run reckons: one train step, one decode step
    cc, fc = CollectiveCounter(), FlopCounterMode(display=False)
    batch = make_batch(cfg, TRAIN_B, TRAIN_S, dtype=torch.float32)
    opts = _forward_opts(cfg, ShapeConfig("t", TRAIN_S, TRAIN_B, "train"))
    p = clone(params)
    st = shard_train_state({"params": p, "opt": init_opt_state(p), "step": 0}, lm, mesh, rules)
    with sharding_context(mesh, rules):
        step = make_train_step(lm, TrainConfig(), opts)
        with fc, cc:
            step(st, batch)
    out["count/train"] = dict(flops=fc.get_total_flops(), calls=cc.calls,
                              coll=parse_collectives(cc.records))
    cc, fc = CollectiveCounter(), FlopCounterMode(display=False)
    cache = lm.shard_cache(clone(W[key]["cache"]), mesh, rules)
    with torch.no_grad(), sharding_context(mesh, rules), fc, cc:
        lm.decode_step(sp, W[key]["tokens"][0], cache, torch.full((B,), POS, dtype=torch.int32))
    out["count/decode"] = dict(flops=fc.get_total_flops(), calls=cc.calls,
                               coll=parse_collectives(cc.records))
# zamba2's train step on the 2x2 mesh, counted as the dry-run reckons it
zcfg = dataclasses.replace(CONFIGS["zamba2-1.2b"].reduced(), dtype="float32")
zlm = LM(zcfg)
cc, fc = CollectiveCounter(), FlopCounterMode(display=False)
p = clone(W["zamba2-1.2b"]["params"])
st = shard_train_state({"params": p, "opt": init_opt_state(p), "step": 0}, zlm, mesh, rules)
with sharding_context(mesh, rules):
    step = make_train_step(zlm, TrainConfig(), _forward_opts(zcfg, ShapeConfig("t", TRAIN_S, TRAIN_B, "train")))
    with fc, cc:
        step(st, make_batch(zcfg, TRAIN_B, TRAIN_S, dtype=torch.float32))
out["count/zamba2_train"] = dict(flops=fc.get_total_flops(), calls=cc.calls,
                                 coll=parse_collectives(cc.records))
# the hybrid, ssm and enc-dec decode: batch rows split over a data-only
# mesh of four, and on the 2x2 mesh, whose model axis splits the mixers'
# channels and heads and the caches' sequences
m4 = make_mesh((4,), ("data",))
r4 = default_rules(m4.axis_names)
for name in DATA_ONLY:
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32")
    lm = LM(cfg)
    params, cache, toks = W[name]["params"], W[name]["cache"], W[name]["tokens"]
    pos = torch.full((B,), POS, dtype=torch.int32)
    single, sc = clone(cache), lm.shard_cache(clone(cache), m4, r4)
    sp = shard_tree(params, logical_to_sharding(lm.param_logical_axes(), params, m4, r4), m4)
    got, ref = [], []
    with torch.no_grad():
        for i in range(2):
            ref.append(lm.decode_step(params, toks[i], single, pos + i)[0])
            with sharding_context(m4, r4):
                got.append(lm.decode_step(sp, toks[i], sc, pos + i)[0])
    out[f"data/{name}"], out[f"data/{name}/single"] = got, ref
    sp2 = shard_tree(params, logical_to_sharding(lm.param_logical_axes(), params, mesh, rules), mesh)
    sc2 = lm.shard_cache(clone(cache), mesh, rules)
    with torch.no_grad(), sharding_context(mesh, rules):
        out[f"split/{name}"] = [lm.decode_step(sp2, toks[i], sc2, pos + i)[0]
                                for i in range(2)]
torch.save(out, f"{work}/rank{rank}.pt")
dist.destroy_process_group()
print("RANK OK")
"""

DRYRUN = r"""
import dataclasses, sys, torch
work = sys.argv[1]
from repro_torch.configs import CONFIGS, ShapeConfig
from repro_torch.launch.dryrun import _forward_opts, dryrun_step, init_fake_group
from repro_torch.models import LM, input_specs
from repro_torch.parallel.mesh import make_mesh
from repro_torch.parallel.sharding import default_rules
cfg = dataclasses.replace(CONFIGS["qwen3-4b"].reduced(), dtype="float32")
lm = LM(cfg)
out = {}
for rank in range(4):
    init_fake_group(4, rank)
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = default_rules(mesh.axis_names)
    ts = ShapeConfig("t", TRAIN_S, TRAIN_B, "train")
    ds = ShapeConfig("d", S, B, "decode")
    out[rank] = {
        "train": dryrun_step(lm, "train", input_specs(cfg, ts, torch.float32), mesh, rules,
                             _forward_opts(cfg, ts)),
        "decode": dryrun_step(lm, "decode", input_specs(cfg, ds, torch.float32), mesh, rules,
                              _forward_opts(cfg, ds))}
zcfg = dataclasses.replace(CONFIGS["zamba2-1.2b"].reduced(), dtype="float32")
for rank in range(4):
    init_fake_group(4, rank)
    mesh = make_mesh((2, 2), ("data", "model"))
    ts = ShapeConfig("t", TRAIN_S, TRAIN_B, "train")
    out[rank]["zamba2_train"] = dryrun_step(
        LM(zcfg), "train", input_specs(zcfg, ts, torch.float32), mesh,
        default_rules(mesh.axis_names), _forward_opts(zcfg, ts))
torch.save(out, f"{work}/dryrun.pt")
print("DRYRUN OK")
"""


def _prelude():
    return (f"CASES = {CASES!r}\nDATA_ONLY = {DATA_ONLY!r}\n"
            f"B, S, STEPS, POS = {B}, {S}, {STEPS}, {POS}\n"
            f"TRAIN_B, TRAIN_S = {TRAIN_B}, {TRAIN_S}\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
            "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}


def _inputs(work: Path):
    """Each case's weights, a random dense cache and STEPS tokens a slot,
    from seeds, for the ranks (torch) and the JAX oracle."""
    w = {}
    for key, (name, kw) in list(CASES.items()) + [(n, (n, {}))
                                                  for n in DATA_ONLY]:
        cfg = _cfg(name, **kw)
        lm = LM(cfg)
        gen = torch.Generator().manual_seed(7)
        cache = lm.init_cache(B, S, backend=None, device="cpu")
        for t in cache["layers"].values():
            t.normal_(generator=gen)
        w[key] = {"params": lm.init(3, device="cpu", dtype=torch.float32),
                  "cache": cache,
                  "tokens": torch.randint(0, cfg.vocab_size, (STEPS, B, 1),
                                          generator=gen, dtype=torch.int32)}
    torch.save(w, work / "weights.pt")
    return w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun")
    inputs = _inputs(work)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _prelude() + RANKS, str(r), str(port),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(), cwd=ROOT) for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _prelude() + DRYRUN, str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT))
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-4000:]
    finally:
        for p in procs:
            p.kill()
    return {"inputs": inputs,
            "ranks": [torch.load(work / f"rank{r}.pt") for r in range(4)],
            "dryrun": torch.load(work / "dryrun.pt")}


def _np(t):
    return t.detach().float().numpy()


def _jax_decode(key, inputs):
    """JAX's ``LM.decode_step`` over the same weights, cache and tokens,
    every slot at POS + i in step i."""
    name, kw = CASES[key]
    jcfg = dataclasses.replace(JCONFIGS[name].reduced(), dtype="float32",
                               **kw)
    jlm = JLM(jcfg)
    to_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    params = jax.tree.map(to_j, inputs["params"])
    cache = jax.tree.map(to_j, inputs["cache"])
    step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i))
    out = []
    for i in range(STEPS):
        logits, cache = step(params, to_j(inputs["tokens"][i]), cache,
                             jnp.int32(POS + i))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_decode_matches_single_rank_and_jax(runs, key):
    """The dense-cache decode step on every rank of the 2×2 mesh: its
    logits (the whole batch's) against the single-rank port at ragged and
    uniform positions, and against JAX's decode step at uniform ones; and
    every rank's cache shard holds the rows it owns."""
    jax_logits = _jax_decode(key, runs["inputs"][key])
    for r, res in enumerate(runs["ranks"]):
        for run in ("uniform", "ragged"):
            for got, ref in zip(res[f"{key}/{run}"],
                                res[f"{key}/{run}/single"]):
                assert got.shape == ref.shape == (B, 1, got.shape[-1])
                np.testing.assert_allclose(_np(got), _np(ref), **TOL)
        for got, ref in zip(res[f"{key}/uniform"], jax_logits):
            np.testing.assert_allclose(_np(got), ref, **TOL)
    # rank (d, m) holds rows 2d..2d+1 and positions 8m..8m+7 of the cache,
    # the new rows written where they fall
    full = [runs["ranks"][r][f"{key}/uniform/cache_k"] for r in range(4)]
    whole = torch.cat([torch.cat(full[2 * d:2 * d + 2], dim=2)
                       for d in range(2)], dim=1)
    assert whole.shape == runs["inputs"][key]["cache"]["layers"]["k"].shape
    pos_rows = whole[:, :, POS:POS + STEPS]
    assert not torch.equal(pos_rows, runs["inputs"][key]["cache"][
        "layers"]["k"][:, :, POS:POS + STEPS])
    assert torch.equal(whole[:, :, :POS], runs["inputs"][key]["cache"][
        "layers"]["k"][:, :, :POS])


@pytest.mark.parametrize("key", list(CASES))
def test_shard_cache_records_the_global_shapes(runs, key):
    """``LM.shard_cache`` keeps each leaf's whole shape in the cache's
    ``"global_shapes"``, which the sharded decode reads; the shards
    without it are refused."""
    full = runs["inputs"][key]["cache"]["layers"]
    for res in runs["ranks"]:
        assert res[f"{key}/global_shapes"] == {
            "layers": {k: tuple(v.shape) for k, v in full.items()}}
        assert "global shapes" in res[f"{key}/no_shapes"]


@pytest.mark.parametrize("name", DATA_ONLY)
def test_data_only_decode_of_hybrid_ssm_encdec(runs, name):
    """zamba2 (its shared block's K/V too), rwkv6 and seamless decode their
    batch rows split over a data-only mesh of four, and on the 2×2 mesh
    (the model axis splitting the mixers' channels and heads, the
    attention heads and the caches' sequences), equal to the single rank
    on every rank (``tests/test_torch_tp_families.py`` holds the split
    decode to JAX's too)."""
    for res in runs["ranks"]:
        for run in ("data", "split"):
            for got, ref in zip(res[f"{run}/{name}"],
                                res[f"data/{name}/single"]):
                assert got.shape == ref.shape and got.shape[0] == B
                np.testing.assert_allclose(_np(got), _np(ref), **TOL)


@pytest.mark.parametrize("kind", ["train", "decode", "zamba2_train"])
def test_dryrun_counts_equal_the_real_step_rank_by_rank(runs, kind):
    """The dry-run of a reduced qwen3-4b train step and decode step, and of
    a reduced zamba2 train step (its mixers split over the model axis), on
    a fake group of four, once as each rank, against the same steps run on
    the gloo ranks: the aten FLOPs (``FlopCounterMode``; the CPU runs the
    kernels' plain versions, which count none, and the dry-run reckons the
    kernels' work apart) and every collective, its kind, bytes and
    group."""
    for r in range(4):
        real = runs["ranks"][r][f"count/{kind}"]
        dry = runs["dryrun"][r][kind]
        assert dry["cost_analysis"]["aten_flops"] == real["flops"] > 0
        assert dry["collective_calls"] == real["calls"]
        assert dry["collectives"] == real["coll"]
        kernels = dry["kernels"]
        if kind != "decode":
            key = "qwen3" if kind == "train" else "zamba2-1.2b"
            assert {k: v["launches"] for k, v in kernels.items()} == {
                "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                "adamw_fused": len(list(_leaves(runs["inputs"][key][
                    "params"])))}
        else:
            assert set(kernels) == {"rmsnorm_rows"}
        assert dry["cost_analysis"]["flops"] == (
            dry["cost_analysis"]["aten_flops"]
            + dry["cost_analysis"]["kernel_flops"])
        ma = dry["memory_analysis"]
        assert ma["peak_size_in_bytes"] == (ma["argument_size_in_bytes"]
                                            + ma["temp_size_in_bytes"])
        assert ma["temp_size_in_bytes"] > 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------ an op's bytes --

_CACHE = (4, 8, 1024, 8, 128)       # (L, B, S, KV, D), bf16
_ROW = 8 * 8 * 128 * 2              # one row a slot of one layer


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


BYTE_CASES = {
    # one row a slot written into a layer of the cache: the rows, the
    # values and the two int64 index vectors, not the cache
    "cache_row_write": (lambda c, x: c[0].__setitem__(x["slots"],
                                                      x["row"]),
                        _ROW + _ROW + 2 * 8 * 8),
    "index_put_accumulate": (lambda c, x: c[0].index_put_(
        x["slots"], x["row"], accumulate=True), _ROW + 2 * _ROW + 2 * 8 * 8),
    # a copy reads its source and writes its destination
    "copy_": (lambda c, x: c[1].copy_(x["layer"]),
              2 * 8 * 1024 * 8 * 128 * 2),
    # a fill writes its destination only
    "fill_": (lambda c, x: c.fill_(0.0), 4 * 8 * 1024 * 8 * 128 * 2),
    "zero_": (lambda c, x: c.zero_(), 4 * 8 * 1024 * 8 * 128 * 2),
    # in place: the destination read and written, the other operand read
    "add_": (lambda c, x: c.add_(c), 3 * 4 * 8 * 1024 * 8 * 128 * 2),
    "add": (lambda c, x: c + c, 3 * 4 * 8 * 1024 * 8 * 128 * 2),
    # into out=: written once
    "add_out": (lambda c, x: torch.add(c[0], c[1], out=c[2]),
                3 * 8 * 1024 * 8 * 128 * 2),
    # a view moves nothing
    "view": (lambda c, x: c[0].transpose(1, 2), 0),
}


@pytest.mark.parametrize("case", list(BYTE_CASES))
def test_step_cost_counts_what_an_op_moves(case):
    """``StepCost``'s bytes of one op on a meta cache: what it reads once
    and what it writes once; an output that is a written argument is not
    counted again, and an indexed write costs its rows."""
    from repro_torch.launch.dryrun import StepCost
    fn, want = BYTE_CASES[case]
    cache = _meta(*_CACHE)
    operands = {"slots": (torch.empty(8, dtype=torch.int64, device="meta"),
                          torch.empty(8, dtype=torch.int64, device="meta")),
                "row": _meta(8, 8, 128), "layer": _meta(*_CACHE[1:])}
    with StepCost() as cost:
        fn(cache, operands)
    assert cost.bytes == want


# ------------------------------------------------------- the command line --

RECORD_KEYS = {"arch", "shape", "mesh", "tag", "chips", "tokens_per_step",
               "opts", "ok", "cost_analysis", "kernels", "collectives",
               "memory_analysis", "op_counts", "dryrun_s",
               "model_flops_global", "n_params", "n_active_params"}


def _cli(*args, module="repro_torch.launch.dryrun"):
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=ROOT)


#: the dry-run's command line with its step made to raise, in the
#: subprocess that runs it
RAISING_CLI = ("import sys\n"
               "from repro_torch.launch import dryrun\n"
               "def raising(*args, **kwargs):\n"
               "    raise ValueError('a cell made to fail')\n"
               "dryrun.dryrun_step = raising\n"
               "sys.argv[0] = 'dryrun'\n"
               "dryrun.main()\n")


def test_cli_full_size_cells(tmp_path):
    """``--arch qwen3-4b --shape decode_32k`` at full size writes an ok
    record with every field; qwen3-4b × long_500k is skipped with JAX's
    text; zamba2-1.2b × train_4k writes an ok record, its mixers split over
    the model axis of 16; a cell whose step raises (patched in the
    subprocess) gives exit code 1, a [FAIL] line and a record of the
    error; ``pp_dryrun`` writes its record with the pipeline's hops
    counted."""
    out = str(tmp_path)
    procs = {
        "ok": _cli("--arch", "qwen3-4b", "--shape", "decode_32k",
                   "--out-dir", out),
        "skip": _cli("--arch", "qwen3-4b", "--shape", "long_500k",
                     "--out-dir", out),
        "hybrid": _cli("--arch", "zamba2-1.2b", "--shape", "train_4k",
                       "--out-dir", out),
        "fail": subprocess.Popen(
            [sys.executable, "-c", RAISING_CLI, "--arch", "rwkv6-1.6b",
             "--shape", "decode_32k", "--out-dir", out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=ROOT),
        "pp": _cli("--out-dir", out, module="repro_torch.launch.pp_dryrun")}
    res = {k: (*p.communicate(timeout=300), p.returncode)
           for k, p in procs.items()}
    stdout, stderr, rc = res["ok"]
    assert rc == 0, stderr[-3000:]
    assert stdout.startswith("[OK] pod16x16 qwen3-4b decode_32k (baseline)")
    rec = json.loads((tmp_path / "pod16x16" /
                      "qwen3-4b__decode_32k.json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["ok"] is True
    assert rec["chips"] == 256 and rec["tokens_per_step"] == 128
    assert rec["opts"]["attn_impl"] == "blockwise"
    assert rec["opts"]["q_chunk"] == rec["opts"]["kv_chunk"] == 1024
    assert rec["kernels"]["rmsnorm_rows"]["launches"] == 36 * 4 + 1
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes accessed"] > 0
    assert set(rec["collectives"]["per_kind"]) == {"all-gather",
                                                   "all-reduce"}
    ma = rec["memory_analysis"]
    # this rank's weights and its 8 x 2048-row shard of the bf16 cache
    cache = 2 * 36 * 8 * 2048 * 8 * 128 * 2
    assert ma["argument_size_in_bytes"] > cache
    assert rec["n_params"] == TCONFIGS["qwen3-4b"].param_count()

    stdout, stderr, rc = res["skip"]
    assert rc == 0, stderr[-3000:]
    rec = json.loads((tmp_path / "pod16x16" /
                      "qwen3-4b__long_500k.json").read_text())
    assert rec["skipped"] == ("long_500k needs sub-quadratic attention "
                              "state; dense arch is full-attention "
                              "(DESIGN.md §4)")
    assert stdout.startswith("[SKIP] pod16x16 qwen3-4b long_500k")

    stdout, stderr, rc = res["hybrid"]
    assert rc == 0, stderr[-3000:]
    assert stdout.startswith("[OK] pod16x16 zamba2-1.2b train_4k")
    rec = json.loads((tmp_path / "pod16x16" /
                      "zamba2-1.2b__train_4k.json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["ok"] is True
    assert rec["n_params"] == TCONFIGS["zamba2-1.2b"].param_count()
    assert rec["collectives"]["total_bytes"] > 0
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(
        rec["collectives"]["per_kind"])

    stdout, stderr, rc = res["fail"]
    assert rc == 1
    assert stdout.startswith("[FAIL] pod16x16 rwkv6-1.6b decode_32k")
    rec = json.loads((tmp_path / "pod16x16" /
                      "rwkv6-1.6b__decode_32k.json").read_text())
    assert rec["ok"] is False
    assert rec["error"] == "ValueError: a cell made to fail"

    stdout, stderr, rc = res["pp"]
    assert rc == 0, stderr[-3000:]
    assert stdout.startswith("[OK] PP dry-run granite-20b-code")
    rec = json.loads((tmp_path / "pod2x16x16" /
                      "granite-20b-code__pp_fwd.json").read_text())
    # rank 0 is stage 0 of 2: it sends each of the 4 microbatches on
    cp = rec["collectives"]["per_kind"]["collective-permute"]
    assert cp["count"] == 4
    assert cp["bytes"] == 4 * 256 // 256 * 1024 * TCONFIGS[
        "granite-20b-code"].d_model * 2
    assert rec["serve_kv_projection"]["pages_in_dense_equiv"] == 32768
