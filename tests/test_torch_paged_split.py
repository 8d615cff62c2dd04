"""K1's split schedule on the CPU: ``paged_decode_split_ref``, the plain
version of the kernel's schedule (each slot's live pages in the window cut
into ``splits`` ranges, the ranges' triples merged in rank order), against
the JAX Pallas kernel in interpret mode and ``repro.kernels.ref``, native
(fp32, bf16) and int8 pools, normalized and as partials with
``page_offset``; and ``plan``, the launch's host side, on its own.

Small shapes (B=5, KV=2, G=2, D=32, page 4, M=6, or M=3 for a table
narrower than the split count).  Tolerances: fp32 and int8 (fp32 q) 2e-5,
bf16 2e-2 (the output rounds to bf16)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_decode as jpd
from repro.kernels import ref as jref
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels.quant import quantize_kv
from test_torch_tenancy import one_torch_thread  # noqa: F401

TOL = {"fp32": 2e-5, "bf16": 2e-2, "int8": 2e-5}
B, KV, G, D, PAGE = 5, 2, 2, 32, 4


def _case(fmt: str, m: int = 6, dead: float = 1e3, seed: int = 0):
    """A pool of B * M + 1 pages (padded to an even count for two shards),
    a random table of global ids and positions: slot 0 at 0 (one live row),
    slot 1 on a page edge (page - 1), slot 2 on the first row of a page,
    slot 3 at the table's last row, slot 4 a freed slot (all-zero table
    row, position 0: one row of scratch page 0).  Every dead page holds
    ``dead``."""
    rng = np.random.default_rng(seed)
    n_pages = B * m + 2
    table = (rng.permutation(n_pages - 1)[: B * m] + 1).reshape(B, m)
    table[4] = 0
    pos = np.array([0, PAGE - 1, 2 * PAGE, m * PAGE - 1, 0], np.int32)
    k = rng.normal(size=(n_pages, PAGE, KV, D)).astype(np.float32)
    v = rng.normal(size=(n_pages, PAGE, KV, D)).astype(np.float32)
    for s in range(4):
        k[table[s, pos[s] // PAGE + 1:]] = dead
        v[table[s, pos[s] // PAGE + 1:]] = dead
    q = rng.normal(size=(B, KV, G, D)).astype(np.float32)
    t = dict(q=torch.from_numpy(q), k=torch.from_numpy(k),
             v=torch.from_numpy(v), table=torch.from_numpy(table).int(),
             pos=torch.from_numpy(pos), ks=None, vs=None)
    if fmt == "bf16":
        for name in "qkv":
            t[name] = t[name].to(torch.bfloat16)
    if fmt == "int8":
        (t["k"], t["ks"]), (t["v"], t["vs"]) = quantize_kv(t["k"]), \
            quantize_kv(t["v"])
    return t


def _jx(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _shard(t, c, n=2):
    pn = t["k"].shape[0] // n
    return {name: (x[c * pn:(c + 1) * pn] if name in ("k", "v", "ks", "vs")
                   and x is not None else x) for name, x in t.items()}, c * pn


def _split(t, splits, off=0, partials=False):
    return tpd.paged_decode_split_ref(
        t["q"], t["k"], t["v"], t["table"], t["pos"], t["ks"], t["vs"], off,
        partials, splits=splits)


def _pallas(t, off=0, partials=False):
    return jpd.paged_flash_decode(
        _jx(t["q"]), _jx(t["k"]), _jx(t["v"]), _jx(t["table"]), _jx(t["pos"]),
        page_offset=off, k_scale=_jx(t["ks"]), v_scale=_jx(t["vs"]),
        partials=partials, interpret=True)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close_triple(got, want, tol, what):
    """(acc, l, m): m and l absolutely and relatively, the normalized
    acc / l absolutely."""
    (ga, gl, gm), (wa, wl, wm) = [[_np(x) for x in tr] for tr in (got, want)]
    np.testing.assert_allclose(gm, wm, rtol=tol, atol=tol, err_msg=what)
    np.testing.assert_allclose(gl, wl, rtol=tol, atol=tol, err_msg=what)
    np.testing.assert_allclose(ga / np.maximum(gl, 1e-30)[..., None],
                               wa / np.maximum(wl, 1e-30)[..., None],
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_split_schedule_matches_pallas_and_ref(fmt, splits):
    """Normalized: the split schedule against the Pallas kernel (interpret)
    and the JAX oracle on the whole pool; with 3 and 8 splits the short
    slots leave ranges empty and slot 3's 6 pages end on a split edge."""
    t = _case(fmt)
    got = _split(t, splits)
    assert got.dtype == t["q"].dtype and bool(torch.isfinite(
        got.float()).all())
    want = _pallas(t)
    oracle = jref.paged_decode_ref(_jx(t["q"]), _jx(t["k"]), _jx(t["v"]),
                                   _jx(t["table"]), _jx(t["pos"]),
                                   _jx(t["ks"]), _jx(t["vs"]))
    for ref, what in ((want, "pallas"), (oracle, "jax ref")):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=TOL[fmt],
                                   atol=TOL[fmt], err_msg=what)


@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_split_schedule_partials_match_pallas(fmt, splits):
    """Partials of each of two shards (``page_offset``) against the Pallas
    kernel's: slots 0 and 4 hold one page each, so the other shard sees no
    live row of them and gives exactly (0, 0, -1e30)."""
    t = _case(fmt, seed=1)
    empty = 0
    for c in range(2):
        s, off = _shard(t, c)
        got = _split(s, splits, off, partials=True)
        assert all(x.dtype == torch.float32 for x in got)
        _close_triple(got, _pallas(s, off, partials=True), TOL[fmt],
                      f"shard {c}")
        acc, l, m = got
        hole = m == tpd.NEG_INF
        assert bool((l[hole] == 0).all()) and bool((acc[hole] == 0).all())
        empty += int(hole[:, 0, 0].sum())
    assert empty >= 2


@pytest.mark.parametrize("partials", [False, True])
@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_split_schedule_never_reads_dead_pages(fmt, partials):
    """NaN in every dead page (int8: NaN scales too) leaves every split's
    result bitwise as it is with finite dead pages."""
    finite, nan = _case(fmt, seed=2), _case(fmt, dead=float("nan"), seed=2)
    if fmt == "int8":
        for name in ("ks", "vs"):
            dead = torch.isnan(_case("fp32", dead=float("nan"),
                                     seed=2)[name[0]]).any(-1)
            nan[name] = torch.where(dead, float("nan"), nan[name])
    for splits in (1, 3, 8):
        a, b = _split(finite, splits, 0, partials), _split(nan, splits, 0,
                                                          partials)
        for x, y in zip(a if partials else [a], b if partials else [b]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("splits", [4, 8])
def test_split_schedule_narrow_table(splits):
    """M = 3 pages, fewer than the splits: most ranges are empty for every
    slot; against the Pallas kernel, normalized and as partials."""
    t = _case("fp32", m=3, seed=3)
    np.testing.assert_allclose(_np(_split(t, splits)), _np(_pallas(t)),
                               rtol=2e-5, atol=2e-5)
    s, off = _shard(t, 1)
    _close_triple(_split(s, splits, off, True), _pallas(s, off, True), 2e-5,
                  "shard 1")


def test_split_schedule_empty_window_is_the_identity():
    """A window that holds no page of the table gives exactly (0, 0,
    -1e30) for every slot, whatever the split count."""
    t = _case("fp32", seed=4)
    for splits in (1, 8):
        acc, l, m = _split(t, splits, 10_000, partials=True)
        assert bool((m == -1e30).all() and (l == 0).all()
                    and (acc == 0).all())


def test_plan_from_shapes_alone():
    """``plan`` takes shapes and the SM count, never positions; at the
    served shape (B=8, KV=8, G=4, D=128, page 16, M=32, 132 SMs) its
    clusters put about 2 blocks on every SM (the table's 32 pages in 4
    splits of 8), and at a 4,096-position table (M=256) at least 2, in one
    wave; the cluster is at most 8 blocks and shared memory within the
    227 KB a block may use for every mode and width; normalized and
    partials launch alike."""
    params = inspect.signature(tpd.plan).parameters
    assert "positions" not in params and "pos" not in params
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for m in (32, 256):
                pl = tpd.plan(8, 8, 4, 128, 16, m, dtype, quant, False, 132)
                assert pl == tpd.plan(8, 8, 4, 128, 16, m, dtype, quant,
                                      True, 132)
                blocks = pl.grid[0] * pl.grid[1]
                assert pl.cluster == pl.splits == pl.grid[0] <= 8
                assert blocks <= pl.blocks_per_sm * 132
                assert blocks >= (2 * 132 if m == 256 else 1.9 * 132)
                assert pl.pages_per_split == -(-m // pl.splits)
                assert pl.pages_per_split >= 8
            for g in (1, 3, 4, 8, 12):
                for d in (16, 32, 64, 128, 256):
                    for m in (1, 32, 256, 2048):
                        if d * (1 if quant else dtype.itemsize) % 16:
                            continue
                        pl = tpd.plan(8, 8, g, d, 16, m, dtype, quant,
                                      False, 132)
                        assert pl.smem <= 232_448 and 1 <= pl.splits <= 8
                        assert pl.g_blocks * pl.group >= g
    # a wide batch needs no split; a single slot takes all 8
    assert tpd.plan(64, 8, 4, 128, 16, 32, torch.bfloat16, False, False,
                    132).splits == 1
    assert tpd.plan(1, 8, 4, 128, 16, 256, torch.bfloat16, False, False,
                    132).splits == 8


@pytest.mark.parametrize("d,dtype,quant", [(264, torch.bfloat16, False),
                                           (120, torch.bfloat16, True),
                                           (6, torch.float32, False)])
def test_plan_refuses_what_the_kernel_does_not_take(d, dtype, quant):
    with pytest.raises(ValueError, match="16-byte"):
        tpd.plan(8, 8, 4, d, 16, 32, dtype, quant, False, 132)
