"""K7 (the RWKV6 WKV recurrence), the RWKV6 time- and channel-mix blocks and
the rwkv6 model of the port against the JAX package, on the same weights
(``from_jax`` on ``LM(cfg).init(key)``) and the same numpy inputs.

The plain K7 is held to the JAX Pallas kernel (interpret mode on the CPU)
and to the naive recurrence ``ref.wkv6_ref``; the port's ``"kernel"`` mixer
path to JAX's ``"pallas"`` path and its ``"plain"`` path to JAX's
``"xla"`` path.  fp32 is held to 2e-5; bf16 to 2e-2 (outputs and the
blocks' intermediates round to bf16), the tolerances of
``tests/test_kernels.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ForwardOpts as JOpts
from repro.models import LM as JLM
from repro.models import rwkv6 as jrwkv
from repro.train.trainer import make_eval_step as jmake_eval_step
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_wkv as twkv
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import layer_params
from repro_torch.train import make_eval_step
from test_torch_tenancy import one_torch_thread  # noqa: F401

NAME = "rwkv6-1.6b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RNG = np.random.default_rng(15)


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = dataclasses.replace(JCONFIGS[NAME].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS[NAME].reduced(), dtype="float32")
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jlm, jparams, tcfg, LM(tcfg), tparams


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])


def wkv_inputs(b, s, h, k):
    r, kk, vv = (RNG.normal(0, 0.5, (b, s, h, k)).astype(np.float32)
                 for _ in range(3))
    lw = np.maximum(-RNG.uniform(0.001, 1.5, (b, s, h, k)), -2.5) \
        .astype(np.float32)
    u = RNG.normal(0, 0.3, (h, k)).astype(np.float32)
    return r, kk, vv, lw, u


def _fold(t):
    b, s, h, k = t.shape
    return t.transpose(0, 2, 1, 3).reshape(b * h, s, k)


def _ref(r, kk, vv, lw, u, dtype="float32"):
    b, s, h, k = r.shape
    out = jref.wkv6_ref(*(jnp.asarray(_fold(np.asarray(t, np.float32)),
                                      JDT[dtype]) for t in (r, kk, vv)),
                        jnp.asarray(_fold(lw)), jnp.asarray(u))
    return np.asarray(out, np.float32).reshape(b, h, s, k) \
        .transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,chunk", [
    (1, 64, 1, 16, 16),
    (2, 128, 3, 32, 32),
    (1, 96, 2, 64, 32),
])
def test_plain_k7_matches_pallas_kernel_and_ref(b, s, h, k, chunk, dtype):
    """``tests/test_kernels.py``'s sweep shapes, through the model-layout
    wrappers of both packages (the port's runs K7's plain version here)."""
    r, kk, vv, lw, u = wkv_inputs(b, s, h, k)
    jd = JDT[dtype]
    jr, jk, jv = (jnp.asarray(a, jd) for a in (r, kk, vv))
    pallas = jops.rwkv6_wkv(jr, jk, jv, jnp.asarray(lw), jnp.asarray(u),
                            chunk=chunk)
    ref = _ref(jr, jk, jv, lw, u, dtype)
    got = tops.rwkv6_wkv(_t(r, dtype), _t(kk, dtype), _t(vv, dtype), _t(lw),
                         _t(u), chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, k)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), ref, **TOL[dtype])


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_k7_ragged_matches_padded_chunked_form(chunk):
    """S = 100 is no multiple of the chunk (the TPU kernel refuses it): the
    plain K7 pads with steps that do nothing, as the model's chunked form
    does; both agree with the naive recurrence."""
    r, kk, vv, lw, u = wkv_inputs(2, 100, 3, 16)
    jform = jrwkv.wkv6_chunked(*(jnp.asarray(a) for a in (r, kk, vv, lw, u)),
                               chunk=chunk)
    ref = _ref(r, kk, vv, lw, u)
    args = [_t(a) for a in (r, kk, vv, lw, u)]
    got = tops.rwkv6_wkv(*args, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(jform), **TOL["float32"])
    np.testing.assert_allclose(_np(got), ref, **TOL["float32"])
    np.testing.assert_allclose(_np(trwkv.wkv6_chunked(*args, chunk=chunk)),
                               _np(jform), **TOL["float32"])


def test_k7_refuses_a_chunk_longer_than_the_split_allows():
    """The rank-1 decay split is exact only for chunks of at most 32 steps
    at the -2.5 log-decay floor; a longer chunk is refused, not run."""
    r, kk, vv, lw, u = (_t(a) for a in wkv_inputs(1, 128, 1, 16))
    with pytest.raises(ValueError, match="exact only for chunks"):
        tops.rwkv6_wkv(r, kk, vv, lw, u, chunk=64)


def test_log_decay_multiplies_wB_in_fp32():
    """The decay LoRA's second product runs in fp32 with an fp32 wB, also
    under bf16 compute, as in JAX: held to 1e-6 of JAX's expression on the
    same bf16 first product, where a bf16-rounded wB moves the log decay by
    far more.  wB is scaled up so that the LoRA term is of order 1."""
    jcfg, _, jparams, tcfg, _, _ = setup()
    jp = dict(jax.tree.map(lambda a: np.array(a[0]),
                           jparams["layers"])["tmix"])
    jp["wB"] = {"kernel": RNG.normal(0, 1.0, jp["wB"]["kernel"].shape)
                .astype(np.float32)}
    wB = torch.from_numpy(jp["wB"]["kernel"])
    p = {"w0": torch.from_numpy(jp["w0"]),
         "wA": {"kernel": torch.from_numpy(jp["wA"]["kernel"])
                .to(torch.bfloat16)},
         "wB": {"kernel": wB}}
    xw = _t(RNG.normal(0, 1, (2, 8, jcfg.d_model)), "bfloat16")
    got = _np(trwkv.log_decay(p, xw))
    lora = (xw @ p["wA"]["kernel"]).float().numpy()

    def jax_lw(wb):
        dec_in = jnp.asarray(jp["w0"]) + jnp.matmul(
            jnp.asarray(lora), wb, precision=jax.lax.Precision.HIGHEST)
        return np.asarray(jnp.maximum(-jnp.exp(jnp.clip(dec_in, -12.0, 0.0)),
                                      trwkv.LOG_DECAY_FLOOR))

    exp = jax_lw(jnp.asarray(jp["wB"]["kernel"]))
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)
    bf16_wB = jax_lw(jnp.asarray(jp["wB"]["kernel"], jnp.bfloat16)
                     .astype(jnp.float32))
    assert np.abs(bf16_wB - exp).max() > 100 * 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"),
                                        ("plain", "xla")])
def test_tmix_and_cmix_blocks_match_jax(impl, jimpl, dtype):
    """Time mix and channel mix from the same fp32 masters: in bf16 the
    port's matrices are cast once by ``from_jax`` (``wB`` kept fp32) and
    JAX casts at each use."""
    jcfg, _, jparams, tcfg, _, _ = setup()
    tp = layer_params(from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                               device="cpu", dtype=TDT[dtype]), 0)
    assert tp["tmix"]["wB"]["kernel"].dtype == torch.float32
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])
    # non-zero token-shift mixes, so the shift paths carry weight
    for blk, names in (("tmix", ("mu_x", "mu")), ("cmix", ("mu_k", "mu_r"))):
        for n in names:
            mu = RNG.uniform(0, 1, jp[blk][n].shape).astype(np.float32)
            jp[blk][n] = jnp.asarray(mu)
            tp[blk][n] = _t(mu)
    x = RNG.normal(0, 1, (2, 64, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, JDT[dtype])
    tx = _t(np.asarray(jx, np.float32), dtype)
    exp, _ = jrwkv.tmix_block(jp["tmix"], jcfg, jx, impl=jimpl)
    got, _ = trwkv.tmix_block(tp["tmix"], tcfg, tx, impl=impl)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(exp), **TOL[dtype])
    exp, _ = jrwkv.cmix_block(jp["cmix"], jcfg, jx)
    got, _ = trwkv.cmix_block(tp["cmix"], tcfg, tx)
    np.testing.assert_allclose(_np(got), _np(exp), **TOL[dtype])


@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"),
                                        ("plain", "xla")])
def test_forward_logits_match_jax(impl, jimpl):
    """Reduced rwkv6 (2 layers, LayerNorm), S = 64: the port's kernel path
    (plain K7 on the CPU) against JAX's Pallas mixer, its plain path against
    JAX's xla mixer."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    toks = RNG.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    jl, _, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)},
                           JOpts(mixer_impl=jimpl, remat="none"))
    opts = ForwardOpts(mixer_impl=impl,
                       norm_impl="kernel" if impl == "kernel" else "plain")
    tl, cache = tlm.forward(tparams, torch.from_numpy(toks).long(), opts)
    assert cache is None and tl.shape == (2, 64, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL["float32"])


def test_eval_step_metrics_match_jax():
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    toks = RNG.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    labels = RNG.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": labels}
    exp = jmake_eval_step(jlm, JOpts(mixer_impl="pallas", remat="none"))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(tlm, ForwardOpts())(tparams, batch)
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(float(got[k]), float(exp[k]),
                                   **TOL["float32"])


def test_from_jax_keeps_fp32_leaves_and_wB_fp32_under_bf16():
    jcfg, _, jparams, tcfg, _, _ = setup()
    p = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                 dtype=torch.bfloat16)
    t, c = p["layers"]["tmix"], p["layers"]["cmix"]
    for leaf in (t["mu_x"], t["mu"], t["w0"], t["u"], t["ln_x"]["scale"],
                 t["ln_x"]["bias"], c["mu_k"], c["mu_r"], t["wB"]["kernel"],
                 p["layers"]["ln1"]["bias"], p["final_norm"]["bias"]):
        assert leaf.dtype == torch.float32
    for leaf in (t["wr"]["kernel"], t["wA"]["kernel"], t["W2"]["kernel"],
                 c["wk"]["kernel"], p["lm_head"]["kernel"]):
        assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(t["wB"]["kernel"]),
        np.asarray(jparams["layers"]["tmix"]["wB"]["kernel"]))


def test_init_params_shapes_and_scales_match_jax_spec():
    jcfg, jlm, jparams, tcfg, tlm, _ = setup()
    ours = tlm.init(0, device="cpu", dtype=torch.bfloat16)
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == \
        jax.tree.map(lambda a: tuple(a.shape), ours)
    t = ours["layers"]["tmix"]
    assert t["wB"]["kernel"].dtype == torch.float32
    assert t["wr"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(t["w0"]), np.asarray(jparams["layers"]["tmix"]["w0"]))
    assert abs(float(t["u"].std()) - 0.3) < 0.05
    assert abs(float(t["wr"]["kernel"].float().std()) - 0.02) < 2e-3
    for leaf in (t["mu_x"], t["mu"], t["ln_x"]["bias"],
                 ours["layers"]["ln1"]["bias"]):
        assert bool((leaf == 0).all())
    assert bool((t["ln_x"]["scale"] == 1).all())


def test_config_copy_equals_jax():
    j, t = JCONFIGS[NAME], TCONFIGS[NAME]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.param_count() == t.param_count()


def test_paged_and_contiguous_backends_stay_refused():
    """Prefill and decode run over the raw state cache (item 16); the
    managed cache backends, a pool group and a paged decode view stay
    refused, as JAX's paged decode and engine refuse recurrent state.
    (Training runs: ``tests/test_torch_train.py``.)"""
    _, _, _, tcfg, tlm, tparams = setup()
    for backend in ("paged", "contiguous"):
        with pytest.raises(ValueError, match="page structure"):
            tlm.init_cache(1, 16, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="page structure"):
        tlm.init_cache(1, 16, backend=None, device="cpu",
                       pool_group=object())
    cache = tlm.init_cache(1, 16, backend=None, device="cpu")
    cache["page_table"] = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="page structure"):
        tlm.decode_step(tparams, torch.zeros(1, 1, dtype=torch.long), cache,
                        torch.zeros(1, dtype=torch.int32))


def test_cpu_kernel_path_counts_no_launch():
    """On CPU tensors every wrapper runs its plain version: the eval through
    the kernel path launches nothing."""
    _, _, _, tcfg, tlm, tparams = setup()
    toks = RNG.integers(0, tcfg.vocab_size, (1, 16)).astype(np.int32)
    tops.reset_launch_counts()
    make_eval_step(tlm, ForwardOpts())(tparams, {"tokens": toks,
                                                 "labels": toks})
    assert set(tops.launch_counts().values()) == {0}
    assert twkv.wkv6_scan_bhsd.launches == 0
