"""K7's host-side launch plan (``repro_torch.kernels.rwkv6_wkv.plan``) as a
pure function of CPU tensors: the mode per dtype, the state split over V
(its slices, grid and threads from the shapes alone), the element strides
the kernel receives for the model layout and for the public (B*H, S, K)
layout, the shared memory and resident blocks of each mode, and the
refusals.  Also ``ops.rwkv6_wkv`` (``wkv6_scan_model``) on the model layout
against the public entry on the folded inputs and against the JAX Pallas
kernel in interpret mode, and the plain emulation of the bf16 mode's
rounding points and 32-step tile walk (``wkv6_scan_mma_emu``) against the
all-fp32 plain version and JAX's naive recurrence.  The kernel itself runs
only on a card (``test_torch_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_wkv as twkv


def _model(b=2, s=100, h=3, kd=64, vd=64, dtype=torch.bfloat16):
    r, k = (torch.randn(b, s, h, kd).to(dtype) for _ in range(2))
    v = torch.randn(b, s, h, vd).to(dtype)
    lw = -torch.rand(b, s, h, kd)
    u = torch.randn(h, kd)
    return r, k, v, lw, u, torch.empty_like(v)


def _wkv_inputs(b, s, h, kd, seed, floor=False):
    """Model-scale inputs in the model layout: r, k, v ~ N(0, 0.15^2), lw =
    max(-exp(U[-6, 1.5]), -2.5) (the model's decays and ones at the floor;
    ``floor`` puts every third channel at -2.5), u ~ N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 0.15, (b, s, h, kd)) for _ in range(3))
    lw = np.maximum(-np.exp(rng.uniform(-6.0, 1.5, (b, s, h, kd))), -2.5)
    if floor:
        lw[..., ::3] = -2.5
    u = rng.normal(0, 0.3, (h, kd))
    return [a.astype(np.float32) for a in (r, k, v, lw, u)]


def _fold(t):
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("dtype,mode,threads", [
    (torch.bfloat16, "bf16", 32 * (twkv.PREP_WARPS + 2)),
    (torch.float32, "fp32", twkv.FP32_THREADS)])
def test_mode_per_dtype(dtype, mode, threads):
    p = twkv.plan(*_model(dtype=dtype))
    assert (p.mode, p.threads, p.vs, p.slices) == (mode, threads, 32, 2)
    assert p.grid == 2 * 3 * 2
    assert p.smem == twkv.smem_bytes(mode, 64, 32)
    assert p.stages == (twkv.BF16_STAGES if mode == "bf16" else 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_model_layout_strides_equal_the_permuted_view(dtype):
    """The strides passed for r, k, v, lw, out in the model layout are those
    of the (batch, step, head) dims, and reading through them gives the
    (b, h, s) permuted view's elements: the kernel reads the model layout
    in place."""
    r, k, v, lw, u, out = _model(dtype=dtype)
    p = twkv.plan(r, k, v, lw, u, out)
    assert p.r_strides == r.stride()[:3] == p.k_strides
    assert p.v_strides == v.stride()[:3] == p.y_strides
    assert p.lw_strides == lw.stride()[:3]
    rp = r.permute(0, 2, 1, 3)
    got = torch.as_strided(r, rp.shape, (p.r_strides[0], p.r_strides[2],
                                         p.r_strides[1], 1))
    assert torch.equal(got, rp)


def test_public_layout_views_read_the_rows_in_place():
    """wkv6_scan_bhsd's (B*H, S, D) tensors reach the same entry as views:
    row bb * H + h is (bb, :, h) of the model layout."""
    b, h, s, kd = 2, 3, 40, 32
    r = torch.randn(b * h, s, kd).to(torch.bfloat16)
    lw = -torch.rand(b * h, s, kd)
    out = torch.empty_like(r)
    views = twkv.bhsd_views(h, r, r, r, lw, out)
    assert all(vw.data_ptr() == t.data_ptr()
               for vw, t in zip(views, (r, r, r, lw, out)))
    pl = twkv.plan(*views[:4], torch.randn(h, kd), views[4])
    assert (pl.b, pl.s, pl.h, pl.kd, pl.vd) == (b, s, h, kd, kd)
    assert pl.r_strides == (h * s * kd, kd, s * kd) == pl.y_strides
    for bi, hi, si in ((0, 0, 0), (1, 2, s - 1), (1, 0, 7)):
        off = bi * pl.r_strides[0] + si * pl.r_strides[1] \
            + hi * pl.r_strides[2]
        assert torch.equal(r.flatten()[off:off + kd], r[bi * h + hi, si])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_and_grid_do_not_depend_on_the_data(dtype):
    """Two calls with the same shapes and other values (NaN and inf
    included) and other strides give the same split, grid, threads and
    shared memory: nothing of the launch looks at the data, so a CUDA
    graph can capture it."""
    a = twkv.plan(*_model(dtype=dtype))
    r, k, v, lw, u, out = _model(dtype=dtype)
    r[0, 0, 0, 0], lw[1, 5, 2, 3] = float("nan"), float("-inf")
    wide = torch.zeros(2, 100, 3, 128, dtype=dtype)[..., :64]
    b = twkv.plan(wide, k, v, lw, u, out)
    for f in ("mode", "vs", "slices", "grid", "threads", "stages", "smem",
              "blocks_per_sm"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("mode", ["bf16", "fp32"])
def test_v_slices_cover_v_exactly(mode):
    """ceil(V / VS) blocks a row own VS columns each, the last one the
    rest: every column once, no block without a column."""
    dims = range(8, 129, 8) if mode == "bf16" else range(1, 129)
    for vd in dims:
        vs = twkv.vs_for(mode, vd)
        n = -(-vd // vs)
        widths = [min(vs, vd - i * vs) for i in range(n)]
        assert sum(widths) == vd and min(widths) > 0
        if mode == "bf16":
            assert vs in (16, 32)


def test_eval_shape_holds_two_blocks_an_sm():
    """rwkv6-1.6b's eval shape (B=4, H=32, K=V=64, bf16): two blocks an SM
    by shared memory and threads, and the 128 rows' V slices fill the 132
    SMs at two blocks each in one wave (every block resident at once)."""
    r, k, v, lw, u, out = _model(b=4, s=64, h=32)
    p = twkv.plan(r, k, v, lw, u, out)
    assert p.mode == "bf16" and p.blocks_per_sm >= 2
    assert p.smem == 3 * (2 * 4096 + 8192 + 2048) + 2 * (2 * 4096 + 2048
                                                          + 256) \
        + 2 * 4096 + 512 == 84_992
    assert 132 < p.grid <= 132 * p.blocks_per_sm


def test_shared_memory_fits():
    for kd in range(8, 129, 8):
        for vs in (16, 32):
            assert twkv.smem_bytes("bf16", kd, vs) <= twkv.SMEM_LIMIT
            assert twkv.blocks_per_sm("bf16", kd, vs) >= 1
        assert twkv.blocks_per_sm("bf16", kd, 32) == (2 if kd <= 64 else 1)
    for kd in range(1, 129):
        for vd in (1, 7, 32, 100, 128):
            vs = twkv.vs_for("fp32", vd)
            assert twkv.smem_bytes("fp32", kd, vs) <= twkv.SMEM_LIMIT
            assert twkv.blocks_per_sm("fp32", kd, vs) >= 1


@pytest.mark.parametrize("chunk", [0, 33, 64])
def test_chunk_outside_the_split_is_refused(chunk):
    with pytest.raises(ValueError, match="exact only for chunks"):
        twkv.plan(*_model(), chunk=chunk)


def test_unsupported_dtype_is_refused():
    with pytest.raises(TypeError, match="dtype"):
        twkv.plan(*_model(dtype=torch.float16))


@pytest.mark.parametrize("dtype,kd,vd", [
    (torch.bfloat16, 12, 64), (torch.bfloat16, 64, 20),
    (torch.bfloat16, 136, 64), (torch.bfloat16, 64, 136),
    (torch.bfloat16, 4, 8), (torch.float32, 136, 64),
    (torch.float32, 64, 129)])
def test_dims_outside_the_mode_are_refused(dtype, kd, vd):
    """bf16 loads rows in 16-byte chunks: K and V multiples of 8 up to
    128; fp32 takes 1..128."""
    with pytest.raises(ValueError, match="takes K and V"):
        twkv.plan(*_model(s=8, h=1, kd=kd, vd=vd, dtype=dtype))


def test_misaligned_strides_and_bases_are_refused():
    """A stride or base of r, k, v, lw or out that is not a multiple of 16
    bytes raises in the bf16 mode; it is never copied silently."""
    r, k, v, lw, u, out = _model()
    wide = torch.randn(2, 100, 3, 68).to(torch.bfloat16)    # 136-byte steps
    with pytest.raises(ValueError, match="16-byte"):
        twkv.plan(wide[..., :64], k, v, lw, u, out)
    flat = torch.randn(2 * 100 * 3 * 64 + 1).to(torch.bfloat16)
    shifted = flat[1:].view(2, 100, 3, 64)                   # base + 2 bytes
    with pytest.raises(ValueError, match="16-byte"):
        twkv.plan(r, k, shifted, lw, u, out)
    lwide = (-torch.rand(2, 100, 3, 65))[..., :64]           # 260-byte steps
    with pytest.raises(ValueError, match="16-byte"):
        twkv.plan(r, k, v, lwide, u, out)
    with pytest.raises(ValueError, match="contiguous"):
        twkv.plan(r, k, v, lw, u, out.transpose(2, 3).contiguous()
                  .transpose(2, 3))


def test_fp32_mode_takes_unaligned_layouts():
    """The fp32 mode reads scalars: K and V that are not multiples of 4, a
    step stride that is not a multiple of 16 bytes and a base off a 16-byte
    boundary are taken as they are."""
    r, k, v, lw, u, out = _model(kd=13, vd=6, dtype=torch.float32)
    wide = torch.randn(2, 100, 3, 14)[..., :13]
    shifted = torch.randn(2 * 100 * 3 * 6 + 1)[1:].view(2, 100, 3, 6)
    pl = twkv.plan(wide, k, shifted, lw, u, out)
    assert pl.mode == "fp32" and pl.r_strides == (100 * 3 * 14, 3 * 14, 14)
    assert (pl.vs, pl.slices) == (6, 1)


def test_shape_and_dtype_mismatch_is_refused():
    r, k, v, lw, u, out = _model()
    with pytest.raises(ValueError, match="expected"):
        twkv.plan(r, k[:, :-1], v, lw, u, out)
    with pytest.raises(ValueError, match="expected"):
        twkv.plan(r, k, v, lw.to(torch.bfloat16), u, out)
    with pytest.raises(ValueError, match="expected"):
        twkv.plan(r, k, v, lw, u[:, :-1], out)


def test_ops_rwkv6_wkv_is_the_model_layout_entry():
    assert tops.rwkv6_wkv is twkv.wkv6_scan_model


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,h,kd,chunk", [(64, 3, 16, 16), (96, 2, 64, 32)])
def test_model_entry_matches_bhsd_and_pallas_interpret(s, h, kd, chunk, dtype,
                                                       tol):
    """``wkv6_scan_model`` (its plain version on CPU tensors) against the
    public entry on the folded inputs (the same computation: bitwise) and
    against JAX's ``ops.rwkv6_wkv`` (the Pallas kernel in interpret mode) on
    the same numpy inputs; r is a strided view (a slice of a wider
    projection), read as it is."""
    b = 2
    r, k, v, lw, u = _wkv_inputs(b, s, h, kd, seed=21)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jops.rwkv6_wkv(
        *(jnp.asarray(a, jd) for a in (r, k, v)), jnp.asarray(lw),
        jnp.asarray(u), chunk=chunk), np.float32)
    wide = torch.zeros(b, s, h, 2 * kd, dtype=dtype)
    wide[..., :kd] = torch.from_numpy(r).to(dtype)
    tr, tk, tv = (torch.from_numpy(a).to(dtype) for a in (r, k, v))
    tlw, tu = torch.from_numpy(lw), torch.from_numpy(u)
    got = tops.rwkv6_wkv(wide[..., :kd], tk, tv, tlw, tu, chunk=chunk)
    assert got.shape == (b, s, h, kd) and got.dtype == dtype
    public = twkv.wkv6_scan_bhsd(_fold(tr), _fold(tk), _fold(tv), _fold(tlw),
                                 tu, chunk=chunk)
    assert torch.equal(_fold(got), public)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("s,kd,chunk,floor", [
    (100, 16, 16, False), (100, 64, 32, True), (1, 64, 32, False),
    (100, 128, 16, True), (200, 128, 32, False), (64, 16, 32, True)])
def test_mma_emulation_stays_within_1e2_of_fp32(s, kd, chunk, floor):
    """The bf16 mode's rounding points (qf, kf, A, r e^ce, the state and
    k e^(cs_end - cs) each rounded to one bf16) and its 32-step tiles,
    emulated in fp32, stay within 1e-2 of the all-fp32 plain version at
    ``chunk`` and of JAX's naive recurrence (``ref.wkv6_ref``), on
    model-scale inputs, with a ragged S, one step, and decays at the -2.5
    floor; and they do round (the emulation is not the plain version)."""
    b, h = 2, 2
    r, k, v, lw, u = _wkv_inputs(b, s, h, kd, seed=s + kd, floor=floor)
    tr, tk, tv = (_fold(torch.from_numpy(a)).to(torch.bfloat16)
                  for a in (r, k, v))
    tlw, tu = _fold(torch.from_numpy(lw)), torch.from_numpy(u)
    emu = twkv.wkv6_scan_mma_emu(tr, tk, tv, tlw, tu)
    assert emu.shape == (b * h, s, kd) and emu.dtype == torch.float32
    ref = twkv.wkv6_scan_ref(tr.float(), tk.float(), tv.float(), tlw, tu,
                             chunk=chunk)
    naive = np.asarray(jref.wkv6_ref(
        *(jnp.asarray(t.float().numpy()) for t in (tr, tk, tv)),
        jnp.asarray(tlw.numpy()), jnp.asarray(u)))
    err = float((emu - ref).abs().max())
    assert 1e-6 < err <= 1e-2, err
    assert float(np.abs(emu.numpy() - naive).max()) <= 1e-2


@pytest.mark.parametrize("s", [1, 5, 31, 32, 33, 100, 200])
def test_mma_emulation_tiles_cover_a_ragged_s(s):
    """The bf16 mode walks ceil(S / 32) tiles and masks the steps of the
    last one past S (lw = 0, r = k = v = 0: no decay, no state update), as
    its emulation does.  With lw = 0 and small integers in r, k, v, u every
    rounding point is exact, so the emulation equals the plain version
    (which chunks by 16 here) bit for bit: each of the S steps is counted
    once and none past S is."""
    bh, h, kd = 2, 1, 16
    gen = torch.Generator().manual_seed(s)
    r, k, v = (torch.randint(-1, 2, (bh, s, kd), generator=gen).float()
               for _ in range(3))
    u = torch.randint(-1, 2, (h, kd), generator=gen).float()
    lw = torch.zeros(bh, s, kd)
    emu = twkv.wkv6_scan_mma_emu(r, k, v, lw, u)
    assert torch.equal(emu, twkv.wkv6_scan_ref(r, k, v, lw, u, chunk=16))
