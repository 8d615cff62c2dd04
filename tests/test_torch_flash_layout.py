"""K2's host-side launch plan (``repro_torch.kernels.flash_attention.plan``)
as a pure function of CPU tensors: the mode chosen per dtype and head dim,
the element strides the kernel receives for the model layout and for the
public (B*KV*G, S, D) layout, the shared memory of every instantiation, the
query tiles of the grid, and the refusals.  The kernel itself runs only on a
card (``test_torch_gpu.py``)."""
import itertools

import pytest
import torch

from repro_torch.kernels import flash_attention as tfa


def _model(b=2, s=40, kv=2, g=3, d=64, dtype=torch.bfloat16):
    q = torch.randn(b, s, kv, g, d).to(dtype)
    k = torch.randn(b, s, kv, d).to(dtype)
    v = torch.randn(b, s, kv, d).to(dtype)
    return q, k, v, torch.empty_like(q)


@pytest.mark.parametrize("dtype,d,mode", [
    (torch.bfloat16, 32, "bf16"), (torch.bfloat16, 64, "bf16"),
    (torch.bfloat16, 128, "bf16"), (torch.float32, 32, "fp32"),
    (torch.float32, 64, "fp32"), (torch.float32, 80, "fp32"),
    (torch.float32, 128, "fp32")])
def test_mode_per_dtype_and_head_dim(dtype, d, mode):
    p = tfa.plan(*_model(d=d, dtype=dtype))
    assert p.mode == mode and p.d == d
    assert p.block_q == (tfa.BF16_BLOCK_Q if mode == "bf16"
                         else tfa.FP32_BLOCK_Q)


@pytest.mark.parametrize("d", [16, 80, 96, 256])
def test_bf16_head_dim_outside_the_instantiations_is_refused(d):
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        tfa.plan(*_model(d=d))


def test_unsupported_dtype_is_refused():
    with pytest.raises(TypeError, match="dtype"):
        tfa.plan(*_model(dtype=torch.float16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_model_layout_strides_equal_the_permuted_view(dtype):
    """The strides passed for q, k, v, out in the model layout are those of
    the (b, kv, g, s) permuted views, and reading through them gives the
    permuted view's elements: the kernel reads the model layout in place."""
    q, k, v, out = _model(dtype=dtype)
    p = tfa.plan(q, k, v, out)
    qp, kp = q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3)
    assert p.q_strides == qp.stride()[:4] == p.o_strides
    assert p.k_strides == kp.stride()[:3] == p.v_strides
    got = torch.as_strided(q, qp.shape, (*p.q_strides, 1))
    assert torch.equal(got, qp)
    got = torch.as_strided(k, kp.shape, (*p.k_strides, 1))
    assert torch.equal(got, kp)


def test_fused_projection_slices_keep_their_strides():
    """q, k, v sliced out of one fused (B, S, (H + 2 KV) D) projection are
    strided views: the plan passes their row stride as it is."""
    b, s, kv, g, d = 2, 24, 2, 4, 64
    qkv = torch.randn(b, s, (kv * g + 2 * kv) * d).to(torch.bfloat16)
    q = qkv[..., :kv * g * d].unflatten(-1, (kv, g, d))
    k = qkv[..., kv * g * d:(kv * g + kv) * d].unflatten(-1, (kv, d))
    v = qkv[..., (kv * g + kv) * d:].unflatten(-1, (kv, d))
    p = tfa.plan(q, k, v, torch.empty_like(q))
    row = (kv * g + 2 * kv) * d
    assert p.q_strides == (s * row, g * d, d, row)
    assert p.k_strides == p.v_strides == (s * row, d, row)
    assert p.o_strides == (s * kv * g * d, g * d, d, kv * g * d)


def test_public_layout_views_read_the_rows_in_place():
    """flash_attention_bhsd's (B*KV*G, S, D) tensors reach the same entry as
    views: query head b*G + g is row (b, 0, g) and reads K/V row b."""
    bkv, g, s, d = 3, 4, 20, 32
    q = torch.randn(bkv * g, s, d).to(torch.bfloat16)
    k = torch.randn(bkv, s, d).to(torch.bfloat16)
    out = torch.empty_like(q)
    views = tfa.bhsd_views(q, k, k, out)
    assert all(t.data_ptr() == base.data_ptr()
               for t, base in zip(views, (q, k, k, out)))
    p = tfa.plan(*views)
    assert (p.b, p.kv, p.g, p.s, p.d) == (bkv, 1, g, s, d)
    assert p.q_strides == (g * s * d, 0, s * d, d)
    assert p.k_strides == (s * d, 0, d)
    for b, gi, si in itertools.product(range(bkv), range(g), (0, 7, s - 1)):
        off = b * p.q_strides[0] + gi * p.q_strides[2] + si * p.q_strides[3]
        assert torch.equal(q.flatten()[off:off + d], q[b * g + gi, si])


@pytest.mark.parametrize("d", tfa.BF16_HEAD_DIMS)
def test_bf16_shared_memory_fits_the_card(d):
    assert tfa.smem_bytes("bf16", d) <= tfa.SMEM_LIMIT == 232_448


def test_fp32_shared_memory_fits_or_is_refused():
    for d in range(8, 264, 8):
        assert tfa.smem_bytes("fp32", d) <= tfa.SMEM_LIMIT
        assert tfa.plan(*_model(d=d, dtype=torch.float32)).smem == \
            tfa.smem_bytes("fp32", d)
    with pytest.raises(ValueError, match="shared memory"):
        tfa.plan(*_model(d=512, dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 5, 31, 100, 127, 128, 129, 200, 513])
@pytest.mark.parametrize("b,kv,g", [(2, 2, 3), (3, 4, 3)])
def test_query_tiles_cover_every_row_once(dtype, s, b, kv, g):
    """For ragged S the grid's tiles cover each of the S * B*KV*G query rows
    exactly once (rows past S are not stored), and a head's tiles run
    longest first; 36 heads make a last chunk of 4."""
    p = tfa.plan(*_model(b=b, s=s, kv=kv, g=g, d=32, dtype=dtype))
    seen = torch.zeros(b, kv, g, s, dtype=torch.int32)
    firsts = {}
    for block in range(p.grid):
        bi, kvi, gi, q0 = p.tile(block)
        assert 0 <= q0 < s and q0 % p.block_q == 0
        seen[bi, kvi, gi, q0:min(q0 + p.block_q, s)] += 1
        firsts.setdefault((bi, kvi, gi), []).append(q0)
    assert bool((seen == 1).all())
    assert len(firsts) == b * kv * g
    for q0s in firsts.values():
        assert q0s == sorted(q0s, reverse=True)


def test_misaligned_strides_and_bases_are_refused():
    """The kernel loads 16-byte chunks: a row stride or a base pointer that
    is not a multiple of 16 bytes raises, it is never copied silently."""
    q, k, v, out = _model(d=64)
    wide = torch.randn(2, 40, 2, 68).to(torch.bfloat16)   # 136-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        tfa.plan(q, wide[..., :64], v, out)
    flat = torch.randn(2 * 40 * 2 * 64 + 1).to(torch.bfloat16)
    shifted = flat[1:].view(2, 40, 2, 64)                 # base + 2 bytes
    with pytest.raises(ValueError, match="16-byte"):
        tfa.plan(q, shifted, v, out)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.plan(q, k, v.transpose(1, 2).contiguous().transpose(1, 2)
                 .transpose(2, 3).contiguous().transpose(2, 3), out)


def test_shape_mismatch_is_refused():
    q, k, v, out = _model()
    with pytest.raises(ValueError, match="expected"):
        tfa.plan(q, k[:, :-1], v, out)
    with pytest.raises(ValueError, match="expected"):
        tfa.plan(q, k, v.float(), out)
