"""The port's roofline on the CPU: the kernels' meta paths (meta inputs give
the plain versions' output shapes and dtypes, report the work of
``roofline.kernels``, and never run a plain version), the bound formulas
that ``chip_smoke.py`` prints, the collective accounting against the JAX
``parse_collectives`` on HLO lines of the same collectives, the H100
terms of ``Roofline``, and ``report``'s tables from a record directory."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.roofline.hlo import parse_collectives as jax_parse_collectives
from repro_torch.kernels import adamw_update as aw
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import rwkv6_wkv as wkv
from repro_torch.kernels import softmax_xent as sx
from repro_torch.roofline import analysis, report
from repro_torch.roofline import collectives as rc
from repro_torch.roofline import kernels as rk
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32


def _t(shape, dtype, device, gen=None, kind="normal"):
    if device == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if kind == "int":
        return torch.randint(0, 4, shape, generator=gen).to(dtype)
    return torch.randn(shape, generator=gen).to(dtype)


def _k1(device, quant=False, partials=False):
    gen = torch.Generator().manual_seed(0)
    b, kv, g, d, page, n_pages, m = 2, 2, 3, 64, 16, 9, 4
    pool_dt = torch.int8 if quant else BF16
    q = _t((b, kv, g, d), BF16, device, gen)
    kp = _t((n_pages, page, kv, d), pool_dt, device, gen,
            "int" if quant else "normal")
    vp = _t((n_pages, page, kv, d), pool_dt, device, gen,
            "int" if quant else "normal")
    table = (torch.empty((b, m), dtype=I32, device="meta") if device == "meta"
             else torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0]], dtype=I32))
    pos = (torch.empty((b,), dtype=I32, device="meta") if device == "meta"
           else torch.tensor([50, 20], dtype=I32))
    args = [q, kp, vp]
    if quant:
        args += [torch.rand(n_pages, page, kv).to(device)
                 if device != "meta" else
                 torch.empty(n_pages, page, kv, device="meta")] * 2
    args += [table, pos]
    fn = {(False, False): pd.paged_flash_decode,
          (True, False): pd.paged_flash_decode_int8,
          (False, True): pd.paged_flash_decode_partials,
          (True, True): pd.paged_flash_decode_partials_int8}[quant, partials]
    if partials:
        args.append(0)
    work = rk.paged_decode(q, table, b * m * page, quant, partials)
    return fn, args, fn.__name__, work


def _k2(device, dtype, model_layout):
    gen = torch.Generator().manual_seed(1)
    b, s, kv, g, d = 2, 40, 2, 2, 64
    q = _t((b, s, kv, g, d), dtype, device, gen)
    k = _t((b, s, kv, d), dtype, device, gen)
    v = _t((b, s, kv, d), dtype, device, gen)
    name = "flash_attention_bhsd" if dtype == BF16 else \
        "flash_attention_bhsd_fp32"
    work = rk.flash_attention(q, k, True)
    if model_layout:
        return fa.flash_attention_model, [q, k, v], name, work
    flat = [t.reshape(-1, s, d) if device == "meta" else
            t.permute(0, 2, 3, 1, 4).reshape(-1, s, d) for t in (q,)]
    kvs = [t.reshape(-1, s, d) if device == "meta" else
           t.permute(0, 2, 1, 3).reshape(-1, s, d) for t in (k, v)]
    return fa.flash_attention_bhsd, flat + kvs, name, work


def _k6(device, model_layout):
    gen = torch.Generator().manual_seed(2)
    b, s, h, p, n = 2, 24, 3, 16, 8
    x = _t((b, s, h, p), F32, device, gen)
    da = _t((b, s, h), F32, device, gen)
    bm = _t((b, s, n), F32, device, gen)
    cm = _t((b, s, n), F32, device, gen)
    work = rk.ssd_scan(x, da, bm, cm)
    if model_layout:
        return ssd.ssd_scan_model, [x, da, bm, cm], "ssd_scan_bhsd", work
    xf = x.reshape(b * h, s, p) if device == "meta" else \
        x.permute(0, 2, 1, 3).reshape(b * h, s, p)
    df = da.reshape(b * h, s) if device == "meta" else \
        da.permute(0, 2, 1).reshape(b * h, s)
    return ssd.ssd_scan_bhsd, [xf, df, bm, cm], "ssd_scan_bhsd", work


def _k7(device, model_layout):
    gen = torch.Generator().manual_seed(3)
    b, s, h, kd = 2, 24, 2, 16
    r, k, v = (_t((b, s, h, kd), F32, device, gen) for _ in range(3))
    lw = (torch.empty((b, s, h, kd), device="meta") if device == "meta"
          else -torch.rand(b, s, h, kd, generator=gen))
    u = _t((h, kd), F32, device, gen)
    work = rk.wkv6_scan(r, k, v, lw, u)
    if model_layout:
        return wkv.wkv6_scan_model, [r, k, v, lw, u], "wkv6_scan_bhsd", work

    def fold(t):
        return t.reshape(b * h, s, kd) if device == "meta" else \
            t.permute(0, 2, 1, 3).reshape(b * h, s, kd)
    return (wkv.wkv6_scan_bhsd, [fold(r), fold(k), fold(v), fold(lw), u],
            "wkv6_scan_bhsd", work)


def _k3(device):
    gen = torch.Generator().manual_seed(4)
    x = _t((6, 96), BF16, device, gen)
    sc = _t((96,), F32, device, gen)
    return rn.rmsnorm_rows, [x, sc], "rmsnorm_rows", rk.rmsnorm(x, 96)


def _k4(device, backward):
    gen = torch.Generator().manual_seed(5)
    n, vp, vocab = 6, 256, 200
    logits = _t((n, vp), BF16, device, gen)
    labels = (torch.empty((n,), dtype=I32, device="meta") if device == "meta"
              else torch.randint(0, vocab, (n,), generator=gen).to(I32))
    if not backward:
        return (sx.softmax_xent_fwd, [logits, labels, vocab],
                "softmax_xent_fwd", rk.softmax_xent_fwd(n, vp, 2))
    extra = [_t((n,), F32, device, gen) for _ in range(3)]
    return (sx.softmax_xent_bwd, [logits, labels, *extra, vocab],
            "softmax_xent_bwd", rk.softmax_xent_bwd(n, vp, 2))


CASES = {
    "K1": lambda dev: _k1(dev),
    "K1 int8": lambda dev: _k1(dev, quant=True),
    "K1 partials": lambda dev: _k1(dev, partials=True),
    "K1 partials int8": lambda dev: _k1(dev, quant=True, partials=True),
    "K2 bf16 model": lambda dev: _k2(dev, BF16, True),
    "K2 fp32 model": lambda dev: _k2(dev, F32, True),
    "K2 bf16 bhsd": lambda dev: _k2(dev, BF16, False),
    "K3": _k3,
    "K4 fwd": lambda dev: _k4(dev, False),
    "K4 bwd": lambda dev: _k4(dev, True),
    "K6 model": lambda dev: _k6(dev, True),
    "K6 bhsd": lambda dev: _k6(dev, False),
    "K7 model": lambda dev: _k7(dev, True),
    "K7 bhsd": lambda dev: _k7(dev, False),
}

#: each kernel module's plain versions, patched to raise for the meta run
PLAIN = [(pd, "paged_decode_ref"), (fa, "flash_attention_ref"),
         (rn, "rmsnorm_ref"), (sx, "softmax_xent_ref"),
         (sx, "softmax_xent_bwd_ref"), (aw, "adamw_ref"),
         (ssd, "ssd_scan_ref"), (wkv, "wkv6_scan_ref")]


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    return [s for t in out for s in _shapes(t)]


@pytest.mark.parametrize("case", list(CASES))
def test_meta_path_gives_plain_shapes_and_reports_work(case, monkeypatch):
    fn, args, name, _ = CASES[case]("cpu")
    with torch.no_grad():
        want = _shapes(fn(*args))
    for mod, attr in PLAIN:
        monkeypatch.setattr(mod, attr, _raises)
    fn, args, name, work = CASES[case]("meta")
    before = ops.launch_counts()
    with rk.WorkCounter() as wc, torch.no_grad():
        out = fn(*args)
    assert all(t.device.type == "meta" for t in _tensors(out))
    assert _shapes(out) == want
    # the work of one launch, and no launch counted: nothing ran
    assert wc.launches == {name: 1}
    assert wc.nbytes[name] == work.nbytes
    assert sum(wc.flops[name].values()) == work.total_flops
    assert ops.launch_counts() == before


def test_adamw_meta_path_updates_nothing_and_reports_work(monkeypatch):
    monkeypatch.setattr(aw, "adamw_ref", _raises)
    g, m, v, p = (torch.empty(1000, device="meta") for _ in range(4))
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                 bias_corr1=0.1, bias_corr2=0.05)
    with rk.WorkCounter() as wc:
        assert aw.adamw_fused(g, m, v, p, torch.empty((), device="meta"),
                              **hyper) is None
    assert wc.launches == {"adamw_fused": 1}
    assert wc.nbytes["adamw_fused"] == rk.adamw(1000, 4).nbytes == 28_000
    assert wc.flops["adamw_fused"] == {"float32": 15_000}


def test_meta_path_refuses_autograd_as_the_card_does():
    x = torch.empty(4, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rn.rmsnorm_rows(x, torch.empty(64, device="meta"))
    # no counter active: nothing is reckoned, and the CPU still runs plain
    x = torch.randn(4, 64)
    torch.testing.assert_close(rn.rmsnorm_rows(x, torch.ones(64)),
                               rn.rmsnorm_ref(x, torch.ones(64)))


def _raises(*a, **k):
    raise AssertionError("a meta path ran a plain version")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _tensors(x)]


def test_bounds_keep_chip_smoke_formulas_to_the_last_digit():
    """The bound column's formulas, as ``chip_smoke.py`` computed them
    before they moved here, against ``roofline.kernels`` at its shapes."""
    import chip_smoke as cs
    assert cs.k1_bound is rk.k1_bound and cs.BF16_PEAK == 989e12

    def old(nbytes, flops, dtype):
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = flops / {BF16: 989e12, F32: 67e12}[dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    # phase 4's chunk attention (no kernel): one bf16 term
    nbytes, flops = 2 * (2 * 2048 * 8 * 128 + 128 * 8 * 4 * 128), 10 ** 9
    assert rk.Work(nbytes, ((BF16, flops),)).bound() == old(nbytes, flops,
                                                           BF16)
    m = "meta"
    q = torch.empty(8, 2, 5, 80, dtype=BF16, device=m)
    k = torch.empty(8, 4096, 2, 80, dtype=BF16, device=m)
    qm = torch.empty(8, 4096, 2, 5, 80, dtype=BF16, device=m)
    for causal in (True, False):
        nbytes = 2 * (2 * qm.numel() + 2 * k.numel())
        flops = 4 * 8 * 2 * 5 * 80 * (4096 * 4097 // 2 if causal
                                      else 4096 * 4096)
        assert rk.flash_attention(qm, k, causal).bound() == old(nbytes, flops,
                                                                BF16)
    x = torch.empty(16384, 2560, dtype=BF16, device=m)
    assert rk.rmsnorm(x, 2560).bound() == old(2 * x.numel() * 2 + 4 * 2560,
                                              4 * 16384 * 2560, F32)
    n, vp = 2048, 151936
    assert rk.softmax_xent_fwd(n, vp, 2).bound() == old(
        n * vp * 2 + n * 4 + 2 * n * 4, 4 * n * vp, F32)
    assert rk.softmax_xent_bwd(n, vp, 2).bound() == old(
        2 * n * vp * 2 + 4 * n * 4, 4 * n * vp, F32)
    assert rk.adamw(10 ** 8, 4).bound() == old(10 ** 8 * 28, 15 * 10 ** 8,
                                               F32)
    xs = torch.empty(4, 2048, 64, 64, dtype=BF16, device=m)
    da = torch.empty(4, 2048, 64, device=m)
    bm = torch.empty(4, 2048, 128, dtype=BF16, device=m)
    nb = sum(t.numel() * t.element_size() for t in (xs, da, bm, bm, xs))
    assert rk.ssd_scan(xs, da, bm, bm).bound() == old(nb, 5 * xs.numel() * 128,
                                                      BF16)
    for dtype in (BF16, F32):
        r = torch.empty(4, 2048, 32, 64, dtype=dtype, device=m)
        lw = torch.empty(4, 2048, 32, 64, device=m)
        u = torch.empty(32, 64, device=m)
        nb = sum(t.numel() * t.element_size() for t in (r, r, r, lw, u, r))
        assert rk.wkv6_scan(r, r, r, lw, u).bound() == old(
            nb, 5 * r.numel() * 64, dtype)
    # K1: two peaks, QK/PV at q's and int8's dequantization at fp32's
    table = torch.empty(8, 32, dtype=I32, device=m)
    for quant in (False, True):
        for partials in (False, True):
            rows = 1234
            row_b = 2 * (80 + 4) if quant else 2 * 80 * 2
            out_b = 8 * 2 * 5 * 82 * 4 if partials else q.numel() * 2
            nbytes = 2 * rows * row_b + q.numel() * 2 + out_b + 4 * (256 + 8)
            t_bytes = nbytes / 3.35e12 * 1e3
            t_ops = (4 * 2 * 5 * 80 * rows / 989e12
                     + (2 * rows * 2 * 80 if quant else 0) / 67e12) * 1e3
            want = ((t_bytes, "bytes") if t_bytes >= t_ops else
                    (t_ops, "operations")) + (nbytes,)
            assert rk.k1_bound(q, table, rows, quant, partials) == want


# ----------------------------------------------------------- collectives --

COLL_SCRIPT = r"""
import json, torch, torch.distributed as dist
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.parallel import collectives as coll
init_fake_group(16, 0)
g4 = dist.new_group([0, 1, 2, 3])
g16 = dist.new_group(list(range(16)))
g2 = dist.new_group([0, 8])
m = "meta"
cc = coll.CollectiveCounter()
with cc:
    coll.all_reduce(torch.empty(1024, 512, device=m), g4)
    coll.all_gather(torch.empty(16, 128, dtype=torch.bfloat16, device=m), 0, g4)
    coll.reduce_scatter(torch.empty(64, 128, device=m), 0, g16)
    coll.all_to_all(torch.empty(64, 128, device=m), g4)
    coll.send(torch.empty(8, 1024, device=m), 1, g2, 0)
    coll.recv(torch.empty(8, 1024, device=m), 1, g2, 0)
print(json.dumps(cc.records))
"""

HLO = """
  %ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ags = bf16[64,128]{1,0} all-gather-start(bf16[16,128]{1,0} %p1), replica_groups={{0,1,2,3}}, dimensions={0}
  %agd = bf16[64,128]{1,0} all-gather-done(bf16[64,128]{1,0} %ags)
  %rs = f32[4,128]{1,0} reduce-scatter(f32[64,128]{1,0} %p2), replica_groups=[1,16]<=[16], dimensions={0}, to_apply=%add
  %a2a = f32[64,128]{1,0} all-to-all(f32[64,128]{1,0} %p3), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp0 = f32[8,1024]{1,0} collective-permute(f32[8,1024]{1,0} %p4), source_target_pairs={{0,8}}
  %cp1 = f32[8,1024]{1,0} collective-permute(f32[8,1024]{1,0} %p5), source_target_pairs={{8,0}}
"""


def test_collectives_match_jax_parse_collectives():
    """The port's counter records of five collectives (the two ends of a
    pipeline hop for ``collective-permute``) against the JAX parser on HLO
    lines of the same collectives: equal count and bytes per kind."""
    res = subprocess.run([sys.executable, "-c", COLL_SCRIPT],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    records = json.loads(res.stdout.strip().splitlines()[-1])
    ours, theirs = rc.parse_collectives(records), jax_parse_collectives(HLO)
    assert ours["per_kind"] == theirs["per_kind"]
    assert ours["total_bytes"] == theirs["total_bytes"]
    assert sorted(tuple(o[:2]) for o in ours["largest_ops"]) == sorted(
        tuple(o[:2]) for o in theirs["largest_ops"])
    assert [r["ranks"] for r in records] == [
        [0, 1, 2, 3]] * 2 + [list(range(16))] + [[0, 1, 2, 3]] + [[0, 8]] * 2
    # groups inside one 8-card node stay on NVLink, the rest cross nodes
    by = {"nvlink": 2 * 1024 * 512 * 4 + 64 * 128 * 2 + 64 * 128 * 4,
          "network": 64 * 128 * 4 + 2 * 8 * 1024 * 4}
    assert ours["by_link"] == by


def test_link_of_follows_row_major_nodes():
    assert rc.link_of(range(8)) == "nvlink"
    assert rc.link_of([8, 9, 15]) == "nvlink"
    assert rc.link_of([7, 8]) == "network"
    assert rc.link_of(range(0, 256, 16)) == "network"


# ------------------------------------------------------------ roofline ---

REC = {"arch": "a", "shape": "train_4k", "mesh": "pod16x16", "chips": 256,
       "tokens_per_step": 1024,
       "cost_analysis": {"flops": 3e12, "bytes accessed": 6.7e9,
                         "flops_by_dtype": {"bfloat16": 2.8e12,
                                            "float32": 2e11}},
       "collectives": {"total_bytes": 1e9,
                       "by_link": {"nvlink": 9e8, "network": 1e8}},
       "model_flops_global": 256 * 2e12, "ok": True}


def test_roofline_terms_use_h100_constants():
    r = analysis.from_record(REC)
    assert r.compute_s == 2.8e12 / 989e12 + 2e11 / 67e12
    assert r.memory_s == 6.7e9 / 3.35e12
    assert r.collective_s == 9e8 / 450e9 + 1e8 / 50e9
    assert r.dominant == "compute"
    assert r.bound_s == r.compute_s
    assert r.useful_ratio == pytest.approx(2e12 / 3e12)
    assert r.mfu_bound == pytest.approx(2e12 / (989e12 * r.compute_s))
    d = r.to_dict()
    assert d["dominant"] == "compute" and d["mfu_bound"] == r.mfu_bound
    assert analysis.table_row(r).startswith("| a | train_4k | pod16x16 | ")
    # a record without the dtype or link split counts bf16 and NVLink
    bare = dict(REC, cost_analysis={"flops": 3e12, "bytes accessed": 0.0},
                collectives={"total_bytes": 1e9})
    r = analysis.from_record(bare)
    assert r.compute_s == 3e12 / 989e12 and r.collective_s == 1e9 / 450e9


def test_report_tables_from_a_record_dir(tmp_path):
    d = tmp_path / "pod16x16"
    d.mkdir()
    recs = {"a__train_4k": dict(REC, dryrun_s=1.5, tag="baseline",
                                memory_analysis={
                                    "argument_size_in_bytes": 2e9,
                                    "temp_size_in_bytes": 3e9},
                                collectives=dict(REC["collectives"],
                                                 per_kind={"all-gather": {}})),
            "a__decode_32k": {"arch": "a", "shape": "decode_32k",
                              "mesh": "pod16x16", "ok": False,
                              "error": "ValueError: item 25"},
            "a__long_500k": {"arch": "a", "shape": "long_500k",
                             "mesh": "pod16x16", "skipped": "full attention"},
            "a__train_4k__x": dict(REC, tag="x")}
    for name, r in recs.items():
        (d / f"{name}.json").write_text(json.dumps(r))
    assert len(report.load_records(root=tmp_path)) == 3
    assert len(report.load_records(tag="x", root=tmp_path)) == 1
    assert report.load_cell("a", "train_4k", root=tmp_path)["dryrun_s"] == 1.5
    assert report.load_cell("a", "prefill_32k", root=tmp_path) is None
    table = report.roofline_table(root=tmp_path)
    lines = table.splitlines()
    assert lines[:2] == analysis.TABLE_HEADER.splitlines()
    assert lines[2] == analysis.table_row(analysis.from_record(
        recs["a__train_4k"]))
    assert "FAILED: ValueError: item 25" in lines[3]
    assert "- `a × long_500k`: full attention" in table
    dt = report.dryrun_table(root=tmp_path)
    assert "| a | train_4k | pod16x16 | 1.5 | 2.0 | 3.0 | all-gather |" in dt
    assert "| a | decode_32k | pod16x16 | FAIL |" in dt
    st = report.summary_stats(root=tmp_path)
    assert st["cells_ok"] == 1 and st["bottlenecks"]["compute"] == 1
