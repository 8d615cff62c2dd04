"""The port's hand-written kernels against their plain PyTorch versions on a
CUDA card (``-m gpu``), the forward-only kernels' refusal of autograd, and a
kernel-path train step against the plain path.  Without a card every test
here skips; the file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

fp32 is held to 1e-4 (the kernels sum in another order) and bf16 to 2e-2
(outputs round to bf16)."""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.kernels import adamw_update as taw
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import softmax_xent as tsx
from repro_torch.models import LM, ForwardOpts
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.optimizer import tree_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,page", [(32, 4), (128, 16)])
def test_paged_decode_kernel_matches_plain(dtype, d, page):
    """Boundary positions (0, page edges, a full table), a freed slot on
    scratch page 0, and NaN in every dead page."""
    dev = _card()
    gen = torch.Generator().manual_seed(1)
    b, kv, g, m = 6, 2, 4, 6
    n_pages = b * m + 1
    pos = torch.tensor([0, page - 1, page, page + 1, m * page - 1, 0],
                       dtype=torch.int32)
    table = (torch.randperm(n_pages - 1, generator=gen)[: b * m] + 1)
    table = table.reshape(b, m).to(torch.int32)
    table[5] = 0
    k = torch.randn(n_pages, page, kv, d, generator=gen)
    v = torch.randn(n_pages, page, kv, d, generator=gen)
    for s in range(b - 1):
        dead = table[s, pos[s] // page + 1:].long()
        k[dead] = float("nan")
        v[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen)
    td = DTYPES[dtype]
    q, k, v = (x.to(dev, td) for x in (q, k, v))
    table, pos = table.to(dev), pos.to(dev)
    before = tpd.paged_flash_decode.launches
    got = tpd.paged_flash_decode(q, k, v, table, pos)
    assert tpd.paged_flash_decode.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    assert _err(got, tpd.paged_decode_ref(q, k, v, table, pos)) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 200, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(dtype, s, causal):
    dev = _card()
    td = DTYPES[dtype]
    q = torch.randn(16, s, 128, device=dev).to(td)
    k = torch.randn(4, s, 128, device=dev).to(td)
    v = torch.randn(4, s, 128, device=dev).to(td)
    got = tfa.flash_attention_bhsd(q, k, v, causal=causal)
    assert _err(got, tfa.flash_attention_ref(q, k, v, causal=causal)) \
        <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(8, 2560), (256, 128)])
def test_rmsnorm_kernel_matches_plain(dtype, n, d):
    dev = _card()
    x = (2 * torch.randn(n, d, device=dev)).to(DTYPES[dtype])
    sc = 1 + 0.2 * torch.randn(d, device=dev)
    assert _err(trn.rmsnorm_rows(x, sc), trn.rmsnorm_ref(x, sc)) <= TOL[dtype]


def _elem_rel(a, b) -> float:
    """max |a - b| / |b| over the elements; where b is 0, a must be 0."""
    a, b = a.detach().float(), b.detach().float()
    diff = (a - b).abs()
    return float(torch.where(b == 0, torch.where(diff == 0, 0.0,
                                                 float("inf")),
                             diff / b.abs()).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,vp,vocab", [(64, 151936, 151936),
                                        (16, 384, 300)])
def test_softmax_xent_kernels_match_plain(dtype, n, vp, vocab):
    """Forward and backward, with a padded vocab.  The backward's elements
    span ten orders of magnitude, so each is held to its own size: 1e-5
    (fp32) or 1e-2 (bf16, one unit of rounding) relative."""
    dev = _card()
    x = (4 * torch.randn(n, vp, device=dev)).to(DTYPES[dtype])
    y = torch.randint(0, vocab, (n,), device=dev, dtype=torch.int32)
    g_nll, g_lse = torch.rand(n, device=dev), torch.rand(n, device=dev)
    before = (tsx.softmax_xent_fwd.launches, tsx.softmax_xent_bwd.launches)
    nll, lse = tsx.softmax_xent_fwd(x, y, vocab)
    d = tsx.softmax_xent_bwd(x, y, lse, g_nll, g_lse, vocab)
    assert (tsx.softmax_xent_fwd.launches, tsx.softmax_xent_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    rnll, rlse = tsx.softmax_xent_ref(x, y, vocab)
    assert _err(nll, rnll) <= 1e-4 and _err(lse, rlse) <= 1e-4
    rd = tsx.softmax_xent_bwd_ref(x, y, lse, g_nll, g_lse, vocab)
    assert d.dtype == x.dtype
    assert _elem_rel(d, rd) <= {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert float(d[:, vocab:].float().abs().sum()) == 0.0


@pytest.mark.gpu
def test_softmax_xent_kernels_refuse_unaligned_rows():
    """The kernels move 16-byte packs: rows of 1001 bf16 values do not start
    on 16-byte boundaries, so the wrappers raise and launch nothing."""
    dev = _card()
    x = torch.zeros(9, 1001, device=dev, dtype=torch.bfloat16)
    y = torch.zeros(9, device=dev, dtype=torch.int32)
    g = torch.zeros(9, device=dev)
    before = (tsx.softmax_xent_fwd.launches, tsx.softmax_xent_bwd.launches)
    with pytest.raises(ValueError, match="16-byte"):
        tsx.softmax_xent_fwd(x, y, 999)
    with pytest.raises(ValueError, match="16-byte"):
        tsx.softmax_xent_bwd(x, y, g, g, g, 999)
    assert (tsx.softmax_xent_fwd.launches,
            tsx.softmax_xent_bwd.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4096, 3 * 4096 + 7])
def test_adamw_kernel_matches_plain(gdtype, n):
    dev = _card()
    g = torch.randn(n, device=dev).to(DTYPES[gdtype])
    m, v = 0.1 * torch.randn(n, device=dev), 0.1 * torch.rand(n, device=dev)
    p = 0.02 * torch.randn(n, device=dev)
    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                 bias_corr1=1 - 0.9 ** 3, bias_corr2=1 - 0.95 ** 3)
    scale = torch.tensor(0.5, device=dev)
    km, kv, kp = m.clone(), v.clone(), p.clone()
    taw.adamw_fused(g, km, kv, kp, scale, **hyper)
    taw.adamw_ref(g, m, v, p, scale, **hyper)
    for a, b in ((km, m), (kv, v), (kp, p)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_forward_only_kernels_refuse_autograd():
    """K1-K3 have no backward: given a CUDA input that requires a gradient
    they raise instead of returning a tensor that cuts the graph; under
    no_grad they run."""
    dev = _card()
    x = torch.randn(8, 2560, device=dev)
    sc = torch.ones(2560, device=dev, requires_grad=True)
    q = torch.randn(8, 64, 128, device=dev, requires_grad=True)
    k = torch.randn(2, 64, 128, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        trn.rmsnorm_rows(x, sc)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention_bhsd(q, k, k)
    pool = torch.randn(3, 16, 2, 128, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tpd.paged_flash_decode(torch.randn(1, 2, 4, 128, device=dev), pool,
                               pool, torch.ones(1, 2, dtype=torch.int32,
                                                device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev))
    with torch.no_grad():
        trn.rmsnorm_rows(x, sc)
        tfa.flash_attention_bhsd(q, k, k)


@pytest.mark.gpu
def test_kernel_path_train_step_matches_plain_path():
    """Reduced qwen3-4b in fp32: the loss gradients through K4 equal the
    plain path's element by element, and two train steps through K4 and K5
    end where two plain steps do, each tensor to a relative max error of
    1e-3 (as chip_smoke's training parity): Adam divides each element by
    its own gradient scale, so an element whose gradient cancels to near
    zero turns fp32 rounding into a visible difference."""
    dev = _card()
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              dtype="float32")
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=1, total_steps=10)
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    states, grads = {}, {}
    for impl in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           xent_impl=impl)
        state = init_train_state(lm, 0, tcfg, device=dev)
        leaves = tree_leaves(state["params"])
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm.loss(state["params"], batch, opts)
        grads[impl] = torch.autograd.grad(loss, leaves)
        step = make_train_step(lm, tcfg, opts, adamw_impl=impl)
        for _ in range(2):
            state, _ = step(state, batch)
        states[impl] = state
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    for tree in ("params", "opt"):
        for a, b in zip(tree_leaves(states["kernel"][tree]),
                        tree_leaves(states["plain"][tree])):
            assert _err(a, b) <= 1e-3 * float(b.detach().abs().max())


@pytest.mark.gpu
def test_kernel_path_bf16_grads_match_plain_path():
    """Reduced qwen3-4b at the train path's precision (fp32 parameters, bf16
    compute): the loss through K4 equals the plain loss, and every gradient
    leaf agrees to a relative max error of 2e-2 (the two paths' bf16
    dlogits may differ by one unit of rounding in some elements)."""
    dev = _card()
    cfg = get_config("qwen3-4b").reduced()
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    lm = LM(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    params = lm.init(0, device=dev, dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for impl in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           xent_impl=impl)
        loss, _ = lm.loss(params, batch, opts)
        out[impl] = (loss, torch.autograd.grad(loss, leaves))
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gk, gp):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert _err(a, b) <= 2e-2 * float(b.abs().max())
