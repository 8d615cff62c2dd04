"""The port's kernels: each plain PyTorch version against the JAX Pallas
kernel (interpret mode on CPU) and the JAX ``repro.kernels.ref`` oracle, on
the same numpy inputs; K4's backward against ``jax.grad`` of the JAX loss.
The kernels themselves run only on a card and are tested in
``test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import adamw_update as jaw
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro_torch.kernels import adamw_update as taw
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import softmax_xent as tsx

RNG = np.random.default_rng(7)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # bf16: both sides round inputs and outputs to bf16 at other places
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _both(a, name):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ K2 ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,kv,g,d,bq,bk", [
    (1, 128, 1, 1, 64, 64, 64),
    (2, 256, 2, 3, 64, 128, 64),
    (1, 128, 4, 2, 128, 32, 128),
    (2, 64, 1, 8, 32, 64, 32),
])
def test_flash_attention_matches_pallas_and_ref(b, s, kv, g, d, bq, bk,
                                                dtype):
    jq, tq = _both(RNG.normal(0, 1, (b, s, kv, g, d)), dtype)
    jk, tk = _both(RNG.normal(0, 1, (b, s, kv, d)), dtype)
    jv, tv = _both(RNG.normal(0, 1, (b, s, kv, d)), dtype)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                  block_k=bk)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    q2 = jq.transpose(0, 2, 3, 1, 4).reshape(b * kv * g, s, d)
    k2 = jk.transpose(0, 2, 1, 3).reshape(b * kv, s, d)
    v2 = jv.transpose(0, 2, 1, 3).reshape(b * kv, s, d)
    exp = jref.flash_attention_ref(q2, k2, v2, causal=True)
    exp = exp.reshape(b, kv, g, s, d).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


def test_flash_attention_non_causal_matches_pallas():
    b, s, kv, g, d = 1, 128, 2, 2, 64
    jq, tq = _both(RNG.normal(0, 1, (b, s, kv, g, d)), "float32")
    jk, tk = _both(RNG.normal(0, 1, (b, s, kv, d)), "float32")
    jv, tv = _both(RNG.normal(0, 1, (b, s, kv, d)), "float32")
    got = tops.flash_attention(tq, tk, tv, causal=False)
    pallas = jops.flash_attention(jq, jk, jv, causal=False, block_q=64,
                                  block_k=64)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol("float32"))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [5, 100])
def test_flash_attention_ragged_s_matches_ref(s, causal):
    """A prefill bucket capped by max_seq need not be a power of two; the
    Pallas kernel asserts divisibility, so only the oracle is compared."""
    jq, tq = _both(RNG.normal(0, 1, (6, s, 32)), "float32")
    jk, tk = _both(RNG.normal(0, 1, (2, s, 32)), "float32")
    jv, tv = _both(RNG.normal(0, 1, (2, s, 32)), "float32")
    got = tfa.flash_attention_bhsd(tq, tk, tv, causal=causal)
    exp = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(exp), **_tol("float32"))


# ------------------------------------------------------------------ K3 ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,br", [(128, 64, 64), (384, 256, 128),
                                    (64, 1024, 32)])
def test_rmsnorm_matches_pallas_and_ref(n, d, br, dtype):
    jx, tx = _both(RNG.normal(0, 2, (n, d)), dtype)
    js, ts = _both(RNG.normal(1, 0.2, (d,)), "float32")
    got = tops.rmsnorm(tx, ts)
    np.testing.assert_allclose(_np(got), _np(jops.rmsnorm(jx, js,
                                                          block_rows=br)),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jref.rmsnorm_ref(jx, js)),
                               **_tol(dtype))


# ------------------------------------------------------------------ K1 ----

def _paged_inputs(dtype, nan_dead: bool):
    """B=6 slots (KV=2, G=2, D=32, page 4, M=6) at boundary positions: 0,
    the last row of page 0, the first rows of pages 1, a full table, and a
    freed slot (all-zero table row at position 0).  ``nan_dead`` fills every
    page past a slot's live pages with NaN."""
    b, kv, g, d, page, m = 6, 2, 2, 32, 4, 6
    n_pages = b * m + 1
    positions = np.array([0, 3, 4, 5, 23, 0], np.int32)
    table = (RNG.permutation(n_pages - 1)[: b * m] + 1).reshape(b, m)
    table = table.astype(np.int32)
    table[5] = 0
    k = RNG.normal(0, 1, (n_pages, page, kv, d))
    v = RNG.normal(0, 1, (n_pages, page, kv, d))
    if nan_dead:
        for s in range(b - 1):
            dead = table[s, positions[s] // page + 1:]
            k[dead] = np.nan
            v[dead] = np.nan
    q = RNG.normal(0, 1, (b, kv, g, d))
    j = [_both(a, dtype)[0] for a in (q, k, v)]
    t = [_both(a, dtype)[1] for a in (q, k, v)]
    return (j + [jnp.asarray(table), jnp.asarray(positions)],
            t + [torch.from_numpy(table), torch.from_numpy(positions)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_pallas_with_nan_dead_pages(dtype):
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _paged_inputs(dtype, True)
    got = tops.paged_decode_attention(tq[:, None], tk, tv, tt, tp)[:, 0]
    assert torch.isfinite(got.float()).all()
    exp = jops.paged_decode_attention(jq[:, None], jk, jv, jt, jp)[:, 0]
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_ref(dtype):
    """The JAX oracle gathers without the dead-page redirect, so its pools
    here are finite everywhere."""
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _paged_inputs(dtype, False)
    got = tpd.paged_flash_decode(tq, tk, tv, tt, tp)
    exp = jref.paged_decode_ref(jq, jk, jv, jt, jp)
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(dtype))


def test_plain_versions_on_cpu_count_no_launch():
    tops.reset_launch_counts()
    (_, (tq, tk, tv, tt, tp)) = _paged_inputs("float32", False)
    tops.paged_decode_attention(tq[:, None], tk, tv, tt, tp)
    tops.rmsnorm(tq, torch.ones(tq.shape[-1]))
    x = torch.randn(4, 8, 16)
    tfa.flash_attention_bhsd(x, x[:2], x[:2])
    logits = torch.randn(3, 5, 128, requires_grad=True)
    nll, lse = tops.softmax_xent(logits, torch.zeros(3, 5, dtype=torch.int32),
                                 100)
    (nll.sum() + lse.sum()).backward()
    z = torch.zeros(10)
    taw.adamw_fused(z, z.clone(), z.clone(), z.clone(), torch.ones(()),
                    lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                    weight_decay=0.1, bias_corr1=0.1, bias_corr2=0.05)
    assert tops.launch_counts() == {name: 0 for name in tops.KERNELS}


# ------------------------------------------------------------------ K4 ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,vp,vocab", [(16, 256, 256), (24, 384, 300),
                                        (8, 1024, 1000)])
def test_softmax_xent_matches_pallas_and_ref(n, vp, vocab, dtype):
    """nll against the Pallas kernel (interpret) and the JAX oracle, lse
    against ``logsumexp`` over the live columns, with and without a padded
    vocab tail."""
    jx, tx = _both(RNG.normal(0, 4, (n, vp)), dtype)
    y = RNG.integers(0, vocab, (n,)).astype(np.int32)
    nll, lse = tsx.softmax_xent_fwd(tx, torch.from_numpy(y), vocab)
    assert nll.dtype == lse.dtype == torch.float32
    jy = jnp.asarray(y)
    np.testing.assert_allclose(_np(nll), _np(jops.softmax_xent(
        jx, jy, vocab=vocab)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(nll), _np(jref.softmax_xent_ref(
        jx, jy, vocab=vocab)), rtol=2e-5, atol=2e-5)
    exp = jax.scipy.special.logsumexp(jx[:, :vocab].astype(jnp.float32),
                                      axis=-1)
    np.testing.assert_allclose(_np(lse), _np(exp), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_backward_matches_jax_grad(dtype):
    """K4's backward formula (its plain version here) against ``jax.grad``
    of the JAX ``cross_entropy`` with z-loss on the same logits; columns
    past the vocab get exactly zero."""
    jx, tx = _both(RNG.normal(0, 3, (4, 5, 384)), dtype)
    y = RNG.integers(0, 300, (4, 5)).astype(np.int32)

    def loss(x):
        return jcommon.cross_entropy(x, jnp.asarray(y), 300, z_loss=1e-3)[0]

    exp = jax.grad(loss)(jx)
    tx.requires_grad_(True)
    nll, lse = tops.softmax_xent(tx, torch.from_numpy(y), 300)
    (got,) = torch.autograd.grad((nll + 1e-3 * lse.square()).mean(), tx)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(exp), **(
        _tol(dtype) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-7)))
    assert float(got[..., 300:].abs().max()) == 0.0


# ------------------------------------------------------------------ K5 ----

@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,scale,wd,step", [(5000, 0.5, 0.1, 3),
                                             (4096, 1.0, 0.0, 1),
                                             (1000, 0.25, 0.05, 10)])
def test_adamw_matches_pallas_and_ref(n, scale, wd, step, gdtype):
    """Sizes that are and are not a multiple of the Pallas block, clip
    scales below 1 and non-zero weight decay; the port updates in place."""
    jg, tg = _both(RNG.normal(0, 1, (n,)), gdtype)
    m = RNG.normal(0, 0.1, (n,)).astype(np.float32)
    v = RNG.uniform(0, 0.1, (n,)).astype(np.float32)
    p = RNG.normal(0, 0.02, (n,)).astype(np.float32)
    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=wd)
    tm, tv, tp = (torch.from_numpy(a.copy()) for a in (m, v, p))
    taw.adamw_fused(tg, tm, tv, tp, torch.tensor(scale), **hyper,
                    bias_corr1=1.0 - 0.9 ** step,
                    bias_corr2=1.0 - 0.95 ** step)
    pallas = jaw.adamw_fused(jg, jnp.asarray(m), jnp.asarray(v),
                             jnp.asarray(p), **hyper, step=step,
                             grad_scale=scale, interpret=True)
    oracle = jref.adamw_ref(jg.astype(jnp.float32) * scale, jnp.asarray(m),
                            jnp.asarray(v), jnp.asarray(p), **hyper,
                            step=step)
    for exp in (pallas, oracle):
        for got, e in zip((tm, tv, tp), exp):
            np.testing.assert_allclose(_np(got), _np(e), rtol=1e-5,
                                       atol=1e-7)
