"""The port's hand-written kernels against their plain PyTorch versions on a
CUDA card (``-m gpu``).  Without a card every test here skips; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

fp32 is held to 1e-4 (the kernels sum in another order) and bf16 to 2e-2
(outputs round to bf16)."""
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import rmsnorm as trn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
