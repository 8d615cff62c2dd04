"""Logical-axis sharding of the port against the JAX package, with no
processes: every registered config's parameter logical axes and abstract
shapes and dtypes at full size, the train state's logical axes, ``spec_for``
under ``default_rules`` (and its ``fsdp=False``, ``seq_sharded_cache`` and
``fsdp_over_pod`` variants) on abstract meshes up to the 2×16×16
production mesh, ``make_batch`` bit for bit, and the block of a leaf that
``shard`` gives each rank."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import CONFIGS as JCONFIGS
from repro.models import LM as JLM, make_batch as jmake_batch
from repro.parallel.sharding import default_rules as jdefault_rules
from repro.parallel.sharding import spec_for as jspec_for
from repro.train import abstract_train_state as jabstract_train_state
from repro.train import train_state_logical_axes as jtrain_state_axes
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.models import LM, make_batch
from repro_torch.models.common import spec_leaves
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.sharding import (default_rules, logical_to_sharding,
                                           shard, spec_for)
from repro_torch.train import abstract_train_state, train_state_logical_axes
from repro_torch.train.optimizer import tree_leaves

NAMES = sorted(TCONFIGS)
MESHES = [((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RULE_KW = [{}, {"fsdp": False}, {"seq_sharded_cache": True},
           {"fsdp_over_pod": True}]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Everything here is host logic on small tensors: one intra-op thread
    serves it, and spares the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@pytest.mark.parametrize("name", NAMES)
def test_param_axes_and_abstract_params_equal_jax(name):
    """Leaf for leaf, at full size: the logical axes, the shapes and the
    dtypes (meta tensors against ShapeDtypeStructs)."""
    jlm, tlm = JLM(JCONFIGS[name]), LM(TCONFIGS[name])
    assert tlm.param_logical_axes() == jlm.param_logical_axes()
    jabs = jax.tree.leaves(jlm.abstract_params())
    tabs = tree_leaves(tlm.abstract_params())
    assert all(t.device.type == "meta" for t in tabs)
    assert [tuple(t.shape) for t in tabs] == [tuple(j.shape) for j in jabs]
    assert [str(t.dtype).removeprefix("torch.") for t in tabs] == \
        [str(j.dtype) for j in jabs]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_train_state_logical_axes_equal_jax(param_dtype):
    """The masters' axes are there iff a parameter is not fp32, in both
    packages; the abstract states' shapes agree leaf for leaf."""
    jcfg = dataclasses.replace(JCONFIGS["qwen3-4b"], param_dtype=param_dtype)
    tcfg = dataclasses.replace(TCONFIGS["qwen3-4b"], param_dtype=param_dtype)
    jaxes = jtrain_state_axes(JLM(jcfg))
    taxes = train_state_logical_axes(LM(tcfg))
    assert taxes == jaxes
    assert ("master" in taxes["opt"]) == (param_dtype != "float32")
    jabs = jabstract_train_state(JLM(jcfg))
    tabs = abstract_train_state(LM(tcfg))
    assert [tuple(j.shape) for j in jax.tree.leaves(jabs["opt"])] == \
        [tuple(t.shape) for t in tree_leaves(tabs["opt"])]
    assert tabs["step"].dtype == torch.int32 and tabs["step"].dim() == 0


@pytest.mark.parametrize("kw", RULE_KW, ids=["default", "no_fsdp",
                                             "seq_cache", "fsdp_pod"])
def test_default_rules_equal_jax(kw):
    for _, axes in MESHES:
        assert default_rules(axes, **kw) == jdefault_rules(axes, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_spec_for_equals_jax_on_abstract_meshes(name):
    """Every parameter leaf of the full-size config, on each abstract mesh
    under each rule set: the port's spec is JAX's PartitionSpec entries
    (rules dropped where a dim does not divide, no mesh axis twice)."""
    leaves = spec_leaves(LM(TCONFIGS[name]).spec())
    for shape, axes in MESHES:
        jmesh = AbstractMesh(shape, axes)
        tmesh = Mesh(shape, axes)
        for kw in RULE_KW:
            rules = default_rules(axes, **kw)
            jrules = jdefault_rules(axes, **kw)
            for path, p in leaves:
                want = tuple(jspec_for(p.axes, p.shape, jrules, jmesh))
                assert spec_for(p.axes, p.shape, rules, tmesh) == want, \
                    (path, shape, kw)
                # the port's spec_for takes JAX's mesh too: only .shape
                assert spec_for(p.axes, p.shape, rules, jmesh) == want


def test_logical_to_sharding_of_the_train_state_equals_jax():
    jlm = JLM(JCONFIGS["moonshot-v1-16b-a3b"])
    tlm = LM(TCONFIGS["moonshot-v1-16b-a3b"])
    shape, axes = MESHES[3]
    jmesh, tmesh = AbstractMesh(shape, axes), Mesh(shape, axes)
    rules = default_rules(axes)
    got = logical_to_sharding(train_state_logical_axes(tlm),
                              abstract_train_state(tlm), tmesh, rules)
    jaxes = jtrain_state_axes(jlm)
    jabs = jabstract_train_state(jlm)
    want = jax.tree.map(
        lambda a, s: tuple(jspec_for(a, s.shape, rules, jmesh)), jaxes, jabs,
        is_leaf=_is_axes)
    assert got == want


@pytest.mark.parametrize("name", ["qwen3-4b", "internvl2-2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_is_bitwise_jax(name, dtype):
    """JAX's numpy draws in JAX's order: tokens, labels and the stub
    embeddings (rounded through fp32, as JAX converts) bit for bit."""
    jb = jmake_batch(JCONFIGS[name].reduced(), 3, 48, rng=7,
                     dtype=getattr(jnp, dtype))
    tb = make_batch(TCONFIGS[name].reduced(), 3, 48, rng=7,
                    dtype=getattr(torch, dtype))
    assert sorted(jb) == sorted(tb)
    for k, j in jb.items():
        t = tb[k]
        if k in ("tokens", "labels"):
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            assert t.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(j.astype(jnp.float32)))


def test_shard_takes_the_row_major_block_of_each_rank():
    """On a (2, 2) mesh of 4 placed ranks (rank r at (r // 2, r % 2), as
    ``jax.make_mesh`` lays devices out), ``shard`` of every leaf of a
    reduced config's parameters is block ``index`` of each dim its spec
    splits, the first named axis major."""
    cfg = TCONFIGS["llama3.2-3b"].reduced()
    leaves = spec_leaves(LM(cfg).spec())
    shape, axes = (2, 2), ("data", "model")
    rules = default_rules(axes)
    gen = torch.Generator().manual_seed(0)
    for path, p in leaves:
        full = torch.randn(p.shape, generator=gen)
        spec = spec_for(p.axes, p.shape, rules, Mesh(shape, axes))
        for r in range(4):
            got = shard(full, spec, Mesh(shape, axes).place(r))
            idx = [slice(None)] * full.dim()
            coords = {"data": r // 2, "model": r % 2}
            for dim, entry in enumerate(spec):
                names = (entry,) if isinstance(entry, str) else entry or ()
                n, i = 1, 0
                for a in names:
                    n, i = n * shape[axes.index(a)], i * shape[
                        axes.index(a)] + coords[a]
                if names:
                    step = full.shape[dim] // n
                    idx[dim] = slice(i * step, (i + 1) * step)
            assert torch.equal(got, full[tuple(idx)]), (path, r)


@pytest.mark.parametrize("name", ["qwen3-4b", "moonshot-v1-16b-a3b"])
def test_new_forward_opts_on_one_rank_give_the_default_values(name):
    """Outside a sharding context ``flat_heads``, ``tp_shardmap``,
    ``moe_ep`` and ``attn_impl="seqsp"`` run the default path's values:
    the contractions fall back to the plain ones, K/V repeat to H, the
    expert-parallel MoE is ``moe_ffn`` and sequence-sharded attention runs
    its blockwise form at offset 0."""
    from repro_torch.models import ForwardOpts
    cfg = dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device="cpu", dtype=torch.float32)
    toks = make_batch(cfg, 2, 32, rng=1)["tokens"]
    base = ForwardOpts(attn_impl="blockwise", norm_impl="plain")
    with torch.no_grad():
        want, _, aux = lm.forward(params, toks, base, return_aux=True)
        for kw in ({"flat_heads": True}, {"tp_shardmap": True},
                   {"moe_ep": True}, {"attn_impl": "seqsp"}):
            got, _, gaux = lm.forward(
                params, toks, dataclasses.replace(base, **kw),
                return_aux=True)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=str(kw))
            assert float(gaux) == float(aux)
