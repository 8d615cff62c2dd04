"""K6 (the Mamba2 SSD scan), the Mamba2 block and the zamba2 hybrid model of
the port against the JAX package, on the same weights (``from_jax`` on
``LM(cfg).init(key)``) and the same numpy inputs.

The plain K6 is held to the JAX Pallas kernel (interpret mode on the CPU)
and to the naive recurrence ``ref.ssd_ref``; the port's ``"kernel"`` mixer
path to JAX's ``"pallas"`` path and its ``"plain"`` path to JAX's
``"xla"`` path.  fp32 is held to 2e-5; bf16 to 2e-2 (outputs and the
block's intermediates round to bf16), the tolerances of
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
from repro.models import mamba2 as jmamba
from repro.train.trainer import make_eval_step as jmake_eval_step
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import ops as tops
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import layer_params
from repro_torch.train import make_eval_step
from test_torch_tenancy import one_torch_thread  # noqa: F401

NAME = "zamba2-1.2b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RNG = np.random.default_rng(14)


@functools.lru_cache(maxsize=None)
def setup(dtype="float32"):
    jcfg = dataclasses.replace(JCONFIGS[NAME].reduced(), dtype=dtype)
    tcfg = dataclasses.replace(TCONFIGS[NAME].reduced(), dtype=dtype)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jlm, jparams, tcfg, LM(tcfg), tparams


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])


def ssd_inputs(b, s, h, p, n):
    x = RNG.normal(0, 0.5, (b, s, h, p)).astype(np.float32)
    da = -RNG.uniform(0.001, 0.3, (b, s, h)).astype(np.float32)
    bm = RNG.normal(0, 0.5, (b, s, n)).astype(np.float32)
    cm = RNG.normal(0, 0.5, (b, s, n)).astype(np.float32)
    return x, da, bm, cm


def _fold(x, da):
    b, s, h, p = x.shape
    return (x.transpose(0, 2, 1, 3).reshape(b * h, s, p),
            da.transpose(0, 2, 1).reshape(b * h, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 1, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 2, 64, 64, 64),
])
def test_plain_k6_matches_pallas_kernel_and_ref(b, s, h, p, n, chunk, dtype):
    """``tests/test_kernels.py``'s sweep shapes, through the model-layout
    wrappers of both packages (the port's runs K6's plain version here)."""
    x, da, bm, cm = ssd_inputs(b, s, h, p, n)
    jd = JDT[dtype]
    jx, jb, jc = (jnp.asarray(a, jd) for a in (x, bm, cm))
    jda = jnp.asarray(da)
    pallas = jops.mamba2_ssd(jx, jda, jb, jc, chunk=chunk)
    x2, da2 = _fold(np.asarray(jx, np.float32), da)
    ref = jref.ssd_ref(jnp.asarray(x2, jd), jnp.asarray(da2), jb, jc)
    ref = np.asarray(ref, np.float32).reshape(b, h, s, p).transpose(0, 2, 1, 3)
    got = tops.mamba2_ssd(_t(x, dtype), _t(da), _t(bm, dtype), _t(cm, dtype),
                          chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, p)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), ref, **TOL[dtype])


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_k6_ragged_matches_padded_chunked_form(chunk):
    """S = 100 is no multiple of the chunk (the TPU kernel refuses it): the
    plain K6 pads with steps that do nothing, as the model's chunked form
    does; both agree with the naive recurrence."""
    b, s, h, p, n = 2, 100, 3, 16, 8
    x, da, bm, cm = ssd_inputs(b, s, h, p, n)
    jform = jmamba.ssd_chunked(*(jnp.asarray(a) for a in (x, da, bm, cm)),
                               chunk)
    x2, da2 = _fold(x, da)
    ref = np.asarray(jref.ssd_ref(jnp.asarray(x2), jnp.asarray(da2),
                                  jnp.asarray(bm), jnp.asarray(cm)))
    ref = ref.reshape(b, h, s, p).transpose(0, 2, 1, 3)
    args = [_t(a) for a in (x, da, bm, cm)]
    got = tops.mamba2_ssd(*args, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(jform), **TOL["float32"])
    np.testing.assert_allclose(_np(got), ref, **TOL["float32"])
    np.testing.assert_allclose(_np(tmamba.ssd_chunked(*args, chunk)),
                               _np(jform), **TOL["float32"])


def test_ssd_chunked_bf16_rounds_where_jax_does():
    """In bf16 the models' chunked form rounds the mixing matrix, the decays
    and the chunk start states to bf16 where JAX does, so it stays closer to
    JAX's ``ssd_chunked`` than the all-fp32 scan (K6's function) is (on
    this CPU: 0 against 1.6e-2 for seeds 0-2)."""
    b, s, h, p, n, chunk = 2, 64, 2, 16, 8, 16
    x, da, bm, cm = ssd_inputs(b, s, h, p, n)
    jx, jb, jc = (jnp.asarray(a, jnp.bfloat16) for a in (x, bm, cm))
    jform = _np(jmamba.ssd_chunked(jx, jnp.asarray(da), jb, jc, chunk))
    tx, tb, tc = (_t(np.asarray(a, np.float32), "bfloat16")
                  for a in (jx, jb, jc))
    ours = _np(tmamba.ssd_chunked(tx, _t(da), tb, tc, chunk))
    fp32_scan = _np(tops.mamba2_ssd(tx, _t(da), tb, tc, chunk=chunk))
    err_ours = np.abs(ours - jform).max()
    err_scan = np.abs(fp32_scan - jform).max()
    assert err_ours <= 0.25 * err_scan, (err_ours, err_scan)


def test_ssd_chunked_gradient_finite_where_the_decay_overflows():
    """dA = -2 a step over 64-step chunks: above the diagonal of a chunk's
    pairwise decays cs_i - cs_j reaches 126, past fp32's exp range (88).
    JAX's ``ssd_chunked`` masks after the exponential, so its backward
    multiplies the mask's zero by inf: NaN gradients.  The port masks
    before it: its values are JAX's, and its gradients are finite and the
    float64 form's (where nothing overflows)."""
    b, s, h, p, n, chunk = 1, 128, 2, 8, 4, 64
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    da = np.full((b, s, h), -2.0, np.float32)
    bm, cm = rng.normal(0, 1, (2, b, s, n)).astype(np.float32)
    w = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)

    def jloss(x, da):
        y = jmamba.ssd_chunked(x, da, jnp.asarray(bm), jnp.asarray(cm), chunk)
        return jnp.sum(y * w), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(da))
    assert not np.isfinite(np.asarray(jg[1])).all()

    def grads(dtype):
        tx, tda = (torch.tensor(a, dtype=dtype, requires_grad=True)
                   for a in (x, da))
        y = tmamba.ssd_chunked(tx, tda, torch.tensor(bm, dtype=dtype),
                               torch.tensor(cm, dtype=dtype), chunk)
        return (y,) + torch.autograd.grad(
            (y * torch.tensor(w, dtype=dtype)).sum(), (tx, tda))

    y32, gx32, gda32 = grads(torch.float32)
    _, gx64, gda64 = grads(torch.float64)
    np.testing.assert_allclose(_np(y32), _np(jy), **TOL["float32"])
    for g32, g64 in ((gx32, gx64), (gda32, gda64)):
        assert torch.isfinite(g32).all()
        np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(g64.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"),
                                        ("plain", "xla")])
def test_mamba_block_matches_jax(impl, jimpl, dtype):
    """One Mamba2 block from the same fp32 masters: in bf16 the port's
    matrices are cast once by ``from_jax`` and JAX casts at each use."""
    jcfg, _, jparams, tcfg, _, _ = setup()
    tp = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                  dtype=TDT[dtype])
    x = RNG.normal(0, 1, (2, 48, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, JDT[dtype])
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["mamba"]
    exp, _ = jmamba.mamba_block(jp, jcfg, jx, impl=jimpl)
    got, _ = tmamba.mamba_block(layer_params(tp, 0)["mamba"], tcfg,
                                _t(np.asarray(jx, np.float32), dtype),
                                impl=impl)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(exp), **TOL[dtype])


@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"),
                                        ("plain", "xla")])
def test_forward_logits_match_jax(impl, jimpl):
    """Reduced zamba2 (4 Mamba2 layers, the shared block after layers 1 and
    3), S = 64: the port's kernel path (plain K6, K2, K3 on the CPU) against
    JAX's Pallas mixers, its plain path against JAX's xla mixers."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    toks = RNG.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    jl, _, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)},
                           JOpts(attn_impl="dense", mixer_impl=jimpl,
                                 remat="none"))
    opts = (ForwardOpts() if impl == "kernel" else
            ForwardOpts(attn_impl="dense", norm_impl="plain",
                        mixer_impl="plain"))
    tl, cache = tlm.forward(tparams, torch.from_numpy(toks).long(), opts)
    assert cache is None and tl.shape == (2, 64, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL["float32"])


def test_eval_step_metrics_match_jax():
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    toks = RNG.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    labels = RNG.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": labels}
    exp = jmake_eval_step(jlm, JOpts(attn_impl="dense", mixer_impl="pallas",
                                     remat="none"))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(tlm, ForwardOpts())(tparams, batch)
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_allclose(float(got[k]), float(exp[k]),
                                   **TOL["float32"])


def test_from_jax_keeps_fp32_leaves_and_casts_matrices_once():
    jcfg, _, jparams, tcfg, _, _ = setup()
    p = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                 dtype=torch.bfloat16)
    m = p["layers"]["mamba"]
    for name in ("A_log", "D", "dt_bias"):
        assert m[name].dtype == torch.float32
    assert m["norm"]["scale"].dtype == torch.float32
    assert m["wx"]["kernel"].dtype == torch.bfloat16
    assert m["conv_x"].dtype == torch.bfloat16
    assert p["shared"]["in_proj"]["kernel"].shape == (2 * 128, 128)
    assert p["shared"]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    assert p["layers"]["ln1"]["scale"].dtype == torch.float32
    exp = np.asarray(jparams["layers"]["mamba"]["wx"]["kernel"]
                     .astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(_np(m["wx"]["kernel"]), exp)
    np.testing.assert_array_equal(_np(m["A_log"]),
                                  np.asarray(jparams["layers"]["mamba"]
                                             ["A_log"]))


def test_init_params_shapes_and_scales_match_jax_spec():
    jcfg, jlm, jparams, tcfg, tlm, _ = setup()
    ours = tlm.init(0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == \
        jax.tree.map(lambda a: tuple(a.shape), ours)
    m, jm = ours["layers"]["mamba"], jparams["layers"]["mamba"]
    # conv kernels: U(-1/sqrt(fan), 1/sqrt(fan)), fan over the stacked
    # (L, w) dims as in JAX
    bound = 1 / np.sqrt(tcfg.num_layers * tcfg.ssm_conv_dim)
    for t, jt in ((m["conv_x"], jm["conv_x"]), (m["conv_B"], jm["conv_B"])):
        assert float(t.abs().max()) <= bound
        assert float(t.abs().max()) > 0.9 * bound
        assert float(np.abs(np.asarray(jt)).max()) <= bound
    a = torch.exp(m["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert bool((m["D"] == 1).all()) and bool((m["norm"]["scale"] == 1).all())
    assert abs(float(ours["shared"]["attn"]["wo"]["kernel"].std())
               - 0.02 / np.sqrt(2 * tcfg.num_layers)) < 2e-3
    assert abs(float(m["wx"]["kernel"].std()) - 0.02) < 2e-3


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
    assert tssd.ssd_scan_bhsd.launches == 0
