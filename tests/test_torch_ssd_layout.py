"""K6's host-side launch plan (``repro_torch.kernels.mamba2_ssd.plan``) as a
pure function of CPU tensors: the mode per dtype, the element strides the
kernel receives for the model layout and for the public (B*H, S, P) layout,
the shared memory and resident blocks of each mode, the refusals, and what
the fp32 mode takes that the bf16 mode refuses.  Also ``ops.mamba2_ssd`` on
the model layout against the JAX Pallas kernel in interpret mode, and the
plain emulation of the bf16 mode's rounding points against the all-fp32
plain version: within the stated bound, and exactly where no rounding point
rounds, for a ragged S covered by 64-step tiles.  The kernel itself runs
only on a card (``test_torch_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import mamba2_ssd as tssd
from repro_torch.kernels import ops as tops


def _model(b=2, s=100, h=3, p=64, n=64, dtype=torch.bfloat16):
    x = torch.randn(b, s, h, p).to(dtype)
    da = -torch.rand(b, s, h)
    bm = torch.randn(b, s, n).to(dtype)
    cm = torch.randn(b, s, n).to(dtype)
    return x, da, bm, cm, torch.empty_like(x)


def _scan_inputs(b, s, h, p, n, seed):
    """As the Mamba2 block makes them: dt log-uniform in [1e-3, 0.1], A in
    [1, 16], x = X * dt with X ~ N(0, 1), da = -dt * A, B, C ~ N(0, 0.25)."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, s, h)))
    a = rng.uniform(1.0, 16.0, h)
    x = rng.normal(0, 1, (b, s, h, p)) * dt[..., None]
    bm, cm = (rng.normal(0, 0.5, (b, s, n)) for _ in range(2))
    return [a_.astype(np.float32) for a_ in (x, -dt * a, bm, cm)]


@pytest.mark.parametrize("dtype,mode,threads", [
    (torch.bfloat16, "bf16", tssd.BF16_THREADS),
    (torch.float32, "fp32", tssd.FP32_THREADS)])
def test_mode_per_dtype(dtype, mode, threads):
    p = tssd.plan(*_model(dtype=dtype))
    assert (p.mode, p.threads, p.grid) == (mode, threads, 2 * 3)
    assert p.smem == tssd.smem_bytes(mode, 64, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_model_layout_strides_equal_the_permuted_view(dtype):
    """The strides passed for x, da, out in the model layout are those of
    the (batch, step, head) dims, and reading through them gives the
    (b, h, s) permuted view's elements: the kernel reads the model layout
    in place.  b and c are read by (batch, step)."""
    x, da, bm, cm, out = _model(dtype=dtype)
    p = tssd.plan(x, da, bm, cm, out)
    assert p.x_strides == x.stride()[:3] == p.y_strides
    assert p.da_strides == da.stride() and p.b_strides == bm.stride()[:2]
    assert p.c_strides == cm.stride()[:2]
    xp = x.permute(0, 2, 1, 3)
    got = torch.as_strided(x, xp.shape, (p.x_strides[0], p.x_strides[2],
                                         p.x_strides[1], 1))
    assert torch.equal(got, xp)
    dap = da.permute(0, 2, 1)
    got = torch.as_strided(da, dap.shape, (p.da_strides[0], p.da_strides[2],
                                           p.da_strides[1]))
    assert torch.equal(got, dap)


def test_public_layout_views_read_the_rows_in_place():
    """ssd_scan_bhsd's (B*H, S, P) tensors reach the same entry as views:
    row bb * H + h is (bb, :, h) of the model layout."""
    b, h, s, p = 2, 3, 40, 32
    x = torch.randn(b * h, s, p).to(torch.bfloat16)
    da = -torch.rand(b * h, s)
    out = torch.empty_like(x)
    views = tssd.bhsd_views(x, da, out, h)
    assert all(v.data_ptr() == t.data_ptr()
               for v, t in zip(views, (x, da, out)))
    bm = torch.randn(b, s, 16).to(torch.bfloat16)
    pl = tssd.plan(views[0], views[1], bm, bm, views[2])
    assert (pl.b, pl.s, pl.h, pl.p) == (b, s, h, p)
    assert pl.x_strides == (h * s * p, p, s * p) == pl.y_strides
    assert pl.da_strides == (h * s, 1, s)
    for bi, hi, si in ((0, 0, 0), (1, 2, s - 1), (1, 0, 7)):
        off = bi * pl.x_strides[0] + si * pl.x_strides[1] \
            + hi * pl.x_strides[2]
        assert torch.equal(x.flatten()[off:off + p], x[bi * h + hi, si])


def test_bf16_shared_memory_fits_two_blocks_an_sm():
    """The note's arithmetic: a three-stage ring of x, B, C (64 x 64 bf16)
    and da, plus the state twice, is 90,880 B; two blocks fit an SM, so
    zamba2's 256 rows run in one wave on 132 SMs."""
    smem = tssd.smem_bytes("bf16", 64, 64)
    assert smem == 3 * (3 * 8192 + 256) + 2 * 8192 == 90_880
    assert smem <= tssd.SMEM_LIMIT == 232_448
    assert tssd.blocks_per_sm("bf16", 64, 64) == 2
    assert 132 * tssd.blocks_per_sm("bf16", 64, 64) >= 4 * 64
    for p, n in ((16, 8), (32, 16), (64, 64)):   # padded to 64: one size
        assert tssd.plan(*_model(p=p, n=n)).smem == smem


def test_fp32_shared_memory_fits():
    for d in range(8, 136, 8):
        assert tssd.smem_bytes("fp32", d, d) <= tssd.SMEM_LIMIT
        assert tssd.blocks_per_sm("fp32", d, d) >= 1
        plan = tssd.plan(*_model(s=8, h=1, p=d, n=d, dtype=torch.float32))
        assert plan.smem == tssd.smem_bytes("fp32", d, d)


@pytest.mark.parametrize("s", [1, 5, 63, 64, 65, 127, 128, 200, 2000, 2048])
def test_mma_emulation_tiles_cover_a_ragged_s(s):
    """The bf16 mode walks ceil(S / 64) tiles and masks the steps of the
    last one past S (da = 0, x = b = c = 0: no decay, no state update), as
    its emulation does.  With da = 0 and small integers in x, B, C every
    rounding point is exact, so the emulation equals the plain version
    (which chunks differently) bit for bit: each of the S steps is counted
    once and none past S is."""
    b, h, p, n = 1, 2, 16, 16
    gen = torch.Generator().manual_seed(s)
    x, bm, cm = (torch.randint(-1, 2, shape, generator=gen).float()
                 for shape in ((b * h, s, p), (b, s, n), (b, s, n)))
    da = torch.zeros(b * h, s)
    emu = tssd.ssd_scan_mma_emu(x, da, bm, cm)
    assert emu.shape == (b * h, s, p)
    assert torch.equal(emu, tssd.ssd_scan_ref(x, da, bm, cm, chunk=128))


def test_unsupported_dtype_is_refused():
    with pytest.raises(TypeError, match="dtype"):
        tssd.plan(*_model(dtype=torch.float16))


@pytest.mark.parametrize("dtype,p,n", [
    (torch.bfloat16, 72, 64), (torch.bfloat16, 64, 72),
    (torch.bfloat16, 128, 128), (torch.float32, 136, 64),
    (torch.float32, 64, 136)])
def test_dims_beyond_max_dim_are_refused(dtype, p, n):
    with pytest.raises(ValueError, match="takes P and N in"):
        tssd.plan(*_model(s=8, h=1, p=p, n=n, dtype=dtype))


def test_misaligned_strides_and_bases_are_refused():
    """The kernel loads rows in 16-byte chunks: a stride, a base or a row
    of x, b, c, out that is not a multiple of 16 bytes raises; it is never
    copied silently."""
    x, da, bm, cm, out = _model(p=64, n=64)
    wide = torch.randn(2, 100, 3, 68).to(torch.bfloat16)   # 136-byte steps
    with pytest.raises(ValueError, match="16-byte"):
        tssd.plan(wide[..., :64], da, bm, cm, out)
    flat = torch.randn(2 * 100 * 64 + 1).to(torch.bfloat16)
    shifted = flat[1:].view(2, 100, 64)                      # base + 2 bytes
    with pytest.raises(ValueError, match="16-byte"):
        tssd.plan(x, da, shifted, cm, out)
    with pytest.raises(ValueError, match="16-byte"):         # 24-byte rows
        tssd.plan(*_model(p=12, n=16))
    with pytest.raises(ValueError, match="contiguous"):
        tssd.plan(x, da, bm, cm, out.transpose(2, 3).contiguous()
                  .transpose(2, 3))


def test_fp32_mode_takes_unaligned_layouts():
    """The fp32 mode reads scalars: a P or N that is not a multiple of 4,
    a step stride that is not a multiple of 16 bytes and a base off a
    16-byte boundary are taken as they are; only a last dim that is not
    contiguous is refused."""
    x, da, bm, cm, out = _model(p=12, n=6, dtype=torch.float32)
    wide = torch.randn(2, 100, 3, 13)[..., :12]              # 52-byte steps
    shifted = torch.randn(2 * 100 * 6 + 1)[1:].view(2, 100, 6)  # base + 4 B
    pl = tssd.plan(wide, da, shifted, cm, out)
    assert pl.mode == "fp32" and pl.x_strides == (100 * 3 * 13, 3 * 13, 13)
    assert pl.b_strides == (600, 6)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.plan(x, da, bm, cm, out.transpose(2, 3).contiguous()
                  .transpose(2, 3))


def test_shape_and_dtype_mismatch_is_refused():
    x, da, bm, cm, out = _model()
    with pytest.raises(ValueError, match="expected"):
        tssd.plan(x, da, bm[:, :-1], cm, out)
    with pytest.raises(ValueError, match="expected"):
        tssd.plan(x, da.to(torch.bfloat16), bm, cm, out)
    with pytest.raises(ValueError, match="expected"):
        tssd.plan(x, da, bm.float(), cm, out)


def test_ops_mamba2_ssd_model_layout_matches_pallas_interpret():
    """The port's model-layout entry (its plain version on the CPU) against
    the JAX Pallas kernel in interpret mode, on the same numpy inputs, at
    the fp32 tolerance 2e-5; x is a strided view (a slice of a wider
    projection), read as it is."""
    b, s, h, p, n, chunk = 2, 128, 3, 16, 8, 32
    x, da, bm, cm = _scan_inputs(b, s, h, p, n, seed=17)
    want = np.asarray(jops.mamba2_ssd(jnp.asarray(x), jnp.asarray(da),
                                      jnp.asarray(bm), jnp.asarray(cm),
                                      chunk=chunk))
    wide = torch.zeros(b, s, h, 2 * p)
    wide[..., :p] = torch.from_numpy(x)
    got = tops.mamba2_ssd(wide[..., :p], torch.from_numpy(da),
                          torch.from_numpy(bm), torch.from_numpy(cm),
                          chunk=chunk)
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_mma_emulation_stays_within_the_stated_bound():
    """The bf16 mode's rounding points (G, the state and X o w each rounded
    to one bf16), emulated in fp32, stay within the 1e-2 of the all-fp32
    plain version that csrc/mamba2_ssd.cu states (below the 1.56e-2 at
    which two bf16 outputs could be two units apart at |y| < 4), on inputs
    shaped as the model makes them, with a ragged S; and they do round
    (the emulation is not the plain version)."""
    b, s, h, p, n = 1, 1000, 8, 64, 64
    x, da, bm, cm = _scan_inputs(b, s, h, p, n, seed=18)
    xb = torch.from_numpy(x).to(torch.bfloat16).permute(0, 2, 1, 3) \
        .reshape(b * h, s, p)
    dab = torch.from_numpy(da).permute(0, 2, 1).reshape(b * h, s)
    bb, cb = (torch.from_numpy(t).to(torch.bfloat16) for t in (bm, cm))
    emu = tssd.ssd_scan_mma_emu(xb, dab, bb, cb)
    ref = tssd.ssd_scan_ref(xb.float(), dab, bb.float(), cb.float(),
                            chunk=256)
    err = float((emu - ref).abs().max())
    assert float(ref.abs().max()) < 4
    assert 1e-5 < err <= 1e-2, err
