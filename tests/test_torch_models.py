"""The port's model against the JAX model on the same weights (``from_jax``
on ``LM(cfg).init(key)``) and the same numpy inputs: configs, norms, RoPE,
attention, the prefill forward with its collected caches, and chained paged
decode steps at ragged positions.  Reduced fp32 configs, tolerance 2e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import ForwardOpts as JOpts
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.models import ForwardOpts, LM
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import layer_params

ARCHS = ["qwen3-4b", "llama3.2-3b"]
TOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.default_rng(11)


@functools.lru_cache(maxsize=None)
def setup(name):
    jcfg = dataclasses.replace(JCONFIGS[name].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32")
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jlm, jparams, tcfg, LM(tcfg), tparams


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ARCHS)
def test_config_copies_equal_jax(name):
    """The port's config files are copies: every field, and the reduced
    config, must equal the JAX package's."""
    j, t = JCONFIGS[name], TCONFIGS[name]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.param_count() == t.param_count()


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_rms_norm_and_rope_match_jax(impl):
    x = RNG.normal(0, 2, (2, 5, 3, 32)).astype(np.float32)
    sc = RNG.normal(1, 0.2, (32,)).astype(np.float32)
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(sc), 1e-5,
                           impl)
    exp = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-5)
    np.testing.assert_allclose(_np(got), _np(exp), **TOL)
    pos = np.array([[3, 9, 0, 17, 4], [1, 2, 3, 4, 500]], np.int32)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    exp = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(exp), **TOL)


def test_from_jax_keeps_norms_fp32_and_casts_matrices_once():
    jcfg, _, jparams, tcfg, _, _ = setup("qwen3-4b")
    p = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                 dtype=torch.bfloat16)
    assert p["layers"]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["wq"]["kernel"].shape == (2, 128, 4, 32)
    assert p["layers"]["attn"]["q_norm"]["scale"].dtype == torch.float32
    assert p["final_norm"]["scale"].dtype == torch.float32
    exp = np.asarray(jparams["embed"]["table"].astype(jnp.bfloat16),
                     np.float32)
    np.testing.assert_array_equal(_np(p["embed"]["table"]), exp)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_and_scales_match_jax_spec(name):
    jcfg, jlm, jparams, tcfg, tlm, _ = setup(name)
    ours = tlm.init(0, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), ours)
    assert jshapes == tshapes
    wo = ours["layers"]["attn"]["wo"]["kernel"]
    assert abs(float(wo.std()) - 0.02 / np.sqrt(2 * tcfg.num_layers)) < 2e-3
    assert abs(float(ours["embed"]["table"].std()) - 0.02) < 2e-3
    assert bool((ours["layers"]["ln1"]["scale"] == 1).all())


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name", ARCHS)
def test_attention_block_matches_jax(name, impl):
    jcfg, _, jparams, tcfg, _, tparams = setup(name)
    x = RNG.normal(0, 1, (2, 12, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    jy, (jk, jv) = jattn.attention_block(jp, jcfg, jnp.asarray(x),
                                         impl="dense")
    ty, (tk, tv) = tattn.attention_block(layer_params(tparams, 0)["attn"],
                                         tcfg, torch.from_numpy(x),
                                         impl=impl)
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_and_caches_match_jax(name, impl):
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup(name)
    toks = RNG.integers(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    jl, _, jc = jlm.forward(jparams, {"tokens": jnp.asarray(toks)},
                            JOpts(attn_impl="dense", remat="none"),
                            collect_cache=True)
    tl, tc = tlm.forward(tparams, torch.from_numpy(toks).long(),
                         ForwardOpts(attn_impl=impl), collect_cache=True)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc["layers"][k]),
                                   _np(jc["layers"][k]), **TOL)


@pytest.mark.parametrize("decode_impl", ["kernel", "gather"])
@pytest.mark.parametrize("name", ARCHS)
def test_chained_paged_decode_steps_match_jax(name, decode_impl):
    """8 decode steps at ragged per-slot positions over a paged pool, a
    freed slot parked at position 0 on the scratch page included: logits
    each step and the pools at the end."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup(name)
    b, page, m = 4, 4, 6
    n_pages = b * m + 1
    L, kv, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim
    table = (np.arange(b * m) + 1).reshape(b, m).astype(np.int32)
    table[3] = 0                                    # freed slot
    pools = RNG.normal(0, 1, (2, L, n_pages, page, kv, hd)).astype(np.float32)
    jcache = {"layers": {"k": jnp.asarray(pools[0]),
                         "v": jnp.asarray(pools[1])},
              "page_table": jnp.asarray(table)}
    tcache = {"layers": {"k": torch.from_numpy(pools[0].copy()),
                         "v": torch.from_numpy(pools[1].copy())},
              "page_table": torch.from_numpy(table)}
    pos = np.array([2, 7, 12, 0], np.int32)
    for step in range(8):
        toks = RNG.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        p = np.where(np.arange(b) == 3, 0, pos + step).astype(np.int32)
        jl, jcache = jlm.decode_step(jparams, jnp.asarray(toks), jcache,
                                     jnp.asarray(p))
        tl, tcache = tlm.decode_step(tparams, torch.from_numpy(toks).long(),
                                     tcache, torch.from_numpy(p),
                                     decode_impl=decode_impl)
        # the freed slot's output is garbage by design: compare live slots
        np.testing.assert_allclose(_np(tl[:3]), _np(jl[:3]), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["layers"][k]),
                                   _np(jcache["layers"][k]), **TOL)
