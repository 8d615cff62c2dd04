"""The port's sharded paged serving (``repro_torch.parallel.pagedkv``) against
the JAX package on the CPU: K1's partials mode (plain version) against the
Pallas kernel in interpret mode and ``paged_gather_partials``, the
cross-shard merge against the unsharded K1, the shard writes against the
single-rank pool, the locality-first allocator against the JAX cache, and
2- and 4-rank gloo engines against the single-rank port and the JAX sharded
engine, plus ``repro_torch.launch.serve --mesh 2`` under
``torch.distributed.run``.  Reduced configs; fp32 is held to 2e-5, bf16 to
2e-2."""
import dataclasses
import functools
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.kernels import paged_decode as jpd
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.models.params import from_jax
from repro_torch.parallel import PoolGroup
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.kvcache import PagedCache, page_kv_bytes
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = {"fp32": 2e-5, "bf16": 2e-2, "int8": 2e-5}


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = dataclasses.replace(JCONFIGS["qwen3-4b"].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS["qwen3-4b"].reduced(), dtype="float32")
    jparams = JLM(jcfg).init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, JLM(jcfg), tcfg, LM(tcfg), tparams


# ------------------------------------------------------ K1 partials ----

def _k1_case(fmt: str, n: int, seed: int = 0, dead: float = 1e3):
    """A pool padded to n shards, a random table of global ids, ragged
    positions: slot 0 has one live page (so every other shard sees none of
    it), slot 3 is a freed slot on scratch page 0 at position 0, and every
    dead page holds ``dead``.  The gathered views redirect dead and other
    shards' pages to the shard's first page, which may be a dead page, and
    mask them: 1e3 there would show in any unmasked result, and NaN would
    survive the JAX gather's ``0 * NaN``, so NaN is for the plain K1
    alone, which zeroes what it masks, as the kernel never reads it."""
    rng = np.random.default_rng(seed)
    b, kv, g, d, page, m = 4, 2, 2, 32, 4, 6
    n_pages = -(-(b * m + 1) // n) * n
    table = (rng.permutation(n_pages - 1)[: b * m] + 1).reshape(b, m)
    table[3] = 0
    pos = np.array([2, 9, 23, 0], np.int32)
    k = rng.normal(size=(n_pages, page, kv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, page, kv, d)).astype(np.float32)
    for s in range(3):
        k[table[s, pos[s] // page + 1:]] = dead
        v[table[s, pos[s] // page + 1:]] = dead
    q = rng.normal(size=(b, kv, g, d)).astype(np.float32)
    t = dict(q=torch.from_numpy(q), k=torch.from_numpy(k),
             v=torch.from_numpy(v), table=torch.from_numpy(table).int(),
             pos=torch.from_numpy(pos))
    if fmt == "bf16":
        for name in "qkv":
            t[name] = t[name].to(torch.bfloat16)
    t["ks"] = t["vs"] = None
    if fmt == "int8":
        (t["k"], t["ks"]), (t["v"], t["vs"]) = quantize_kv(t["k"]), \
            quantize_kv(t["v"])
    return t, n_pages // n


def _jx(x):
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _shard(t, c, pn):
    return {name: (x[c * pn:(c + 1) * pn] if name in ("k", "v", "ks", "vs")
                   and x is not None else x) for name, x in t.items()}


def _close(got, want, tol, what):
    """The triple (acc, l, m) against another: the normalized output
    acc / l and m absolutely, l relatively."""
    (ga, gl, gm), (wa, wl, wm) = [[np.asarray(x, np.float32) for x in tr]
                                  for tr in (got, want)]
    np.testing.assert_allclose(gm, wm, rtol=tol, atol=tol, err_msg=what)
    np.testing.assert_allclose(gl, wl, rtol=tol, atol=tol, err_msg=what)
    np.testing.assert_allclose(ga / np.maximum(gl, 1e-30)[..., None],
                               wa / np.maximum(wl, 1e-30)[..., None],
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_plain_partials_match_pallas_and_gather(fmt, n):
    """Every shard's plain K1 partials (the kernel wrapper on CPU tensors)
    and the port's ``paged_gather_partials`` against the JAX Pallas kernel
    (``partials=True``, interpret) and the JAX ``paged_gather_partials`` on
    the same shard and ``page_offset``; a slot with no live page in a
    shard gives exactly (0, 0, -1e30)."""
    t, pn = _k1_case(fmt, n)
    t_nan, _ = _k1_case(fmt, n, dead=float("nan"))
    empty_seen = 0
    for c in range(n):
        s = _shard(t, c, pn)
        off = c * pn
        if fmt == "int8":
            got = tpd.paged_flash_decode_partials_int8(
                s["q"], s["k"], s["v"], s["ks"], s["vs"], s["table"],
                s["pos"], off)
        else:
            got = tpd.paged_flash_decode_partials(
                s["q"], s["k"], s["v"], s["table"], s["pos"], off)
        gacc, gl, gm = tattn.paged_gather_partials(
            s["q"][:, None], s["k"], s["v"], s["table"], s["pos"], off,
            k_scale=s["ks"], v_scale=s["vs"])
        pallas = jpd.paged_flash_decode(
            _jx(s["q"]), _jx(s["k"]), _jx(s["v"]), _jx(s["table"]),
            _jx(s["pos"]), page_offset=off, k_scale=_jx(s["ks"]),
            v_scale=_jx(s["vs"]), partials=True, interpret=True)
        jacc, jl, jm = jattn.paged_gather_partials(
            _jx(s["q"])[:, None], _jx(s["k"]), _jx(s["v"]), _jx(s["table"]),
            _jx(s["pos"]), off, k_scale=_jx(s["ks"]), v_scale=_jx(s["vs"]))
        jgather = (jacc[:, 0], jl, jm)
        tol = TOL[fmt]
        s_nan = _shard(t_nan, c, pn)
        got_nan = (tpd.paged_flash_decode_partials_int8(
            s_nan["q"], s_nan["k"], s_nan["v"], s_nan["ks"], s_nan["vs"],
            s_nan["table"], s_nan["pos"], off) if fmt == "int8" else
            tpd.paged_flash_decode_partials(
                s_nan["q"], s_nan["k"], s_nan["v"], s_nan["table"],
                s_nan["pos"], off))
        for a, b in zip(got, got_nan):
            assert torch.equal(a, b), "a dead page's content reached K1"
        _close(got, pallas, tol, f"plain vs pallas, shard {c}")
        _close(got, jgather, tol, f"plain vs JAX gather, shard {c}")
        _close((gacc[:, 0], gl, gm), jgather, tol,
               f"port gather vs JAX gather, shard {c}")
        for acc, l, m in (got, (gacc[:, 0], gl, gm)):
            assert all(x.dtype == torch.float32 for x in (acc, l, m))
            empty = m[:, 0, 0] == tpd.NEG_INF
            assert bool((m[empty] == -1e30).all())
            assert bool((l[empty] == 0).all() and (acc[empty] == 0).all())
            assert bool(torch.isfinite(acc).all())
        empty_seen += int(empty.sum())
    # slot 0's one live page and freed slot 3's scratch page lie in one
    # shard each: every other shard sees neither
    assert empty_seen >= 2 * (n - 1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_merged_partials_equal_unsharded_k1(fmt, n):
    """``merge_partials_local`` over the n shards' triples is the plain K1
    over the whole pool."""
    t, pn = _k1_case(fmt, n, seed=1)
    triples = []
    for c in range(n):
        s = _shard(t, c, pn)
        triples.append(tattn.paged_gather_partials(
            s["q"][:, None], s["k"], s["v"], s["table"], s["pos"], c * pn,
            k_scale=s["ks"], v_scale=s["vs"]))
        acc, l, m = (tpd.paged_flash_decode_partials_int8(
            s["q"], s["k"], s["v"], s["ks"], s["vs"], s["table"], s["pos"],
            c * pn) if fmt == "int8" else tpd.paged_flash_decode_partials(
            s["q"], s["k"], s["v"], s["table"], s["pos"], c * pn))
        triples.append((acc[:, None], l, m))
    want = tpd.paged_decode_ref(t["q"], t["k"], t["v"], t["table"], t["pos"],
                                t["ks"], t["vs"])
    for merged in (tattn.merge_partials_local(triples[0::2]),
                   tattn.merge_partials_local(triples[1::2])):
        np.testing.assert_allclose(merged[:, 0].numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)


# ----------------------------------------------------- shard writes ----

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_shard_writes_union_is_the_single_rank_pool(kv_dtype, n):
    """The same prefill block and decode rows written by one unsharded cache
    and by n rank caches (``PoolGroup(None, c, n)``: writes need no
    collective): the n windows laid end to end are bitwise the single-rank
    pool, every tensor; each rank pins P/n pages plus a sink page."""
    _, _, tcfg, _, _ = setup()
    kw = dict(page_size=4, num_pages=14, device="cpu", dtype=torch.float32,
              kv_dtype=kv_dtype)
    one = PagedCache(tcfg, 4, 32, locality_chips=n, **kw)
    ranks = [PagedCache(tcfg, 4, 32, pool_group=PoolGroup(None, c, n), **kw)
             for c in range(n)]
    rng = np.random.default_rng(2)
    lens = [5, 11, 14]
    prompt = rng.integers(0, 512, 16).astype(np.int32)
    dest = []
    for slot, plen in enumerate(lens):
        shared = {one.alloc(slot, plen + 6, prefix=prompt[:plen])}
        shared |= {kv.alloc(slot, plen + 6, prefix=prompt[:plen])
                   for kv in ranks}
        assert len(shared) == 1
        dest.append(one.prefill_dest(slot, 16, plen, shared.pop()))
    dest = torch.from_numpy(np.stack(dest))
    shape = (tcfg.num_layers, len(lens), 16, tcfg.num_kv_heads,
             tcfg.resolved_head_dim)
    block = one.quantize_block({name: torch.randn(shape) for name in "kv"})
    for kv in (one, *ranks):
        assert kv.page_table.tolist() == one.page_table.tolist()
        kv.staged_write_prefill(block, dest)
    # two decode steps: slots at their positions, slot 3 freed on scratch
    pos = torch.tensor(lens + [0], dtype=torch.int32)
    table = torch.from_numpy(one.page_table)
    for step in range(2):
        new = {name: torch.randn(len(pos), 1, tcfg.num_kv_heads,
                                 tcfg.resolved_head_dim) for name in "kv"}
        if kv_dtype == "int8":
            for name in "kv":
                new[name], new[name + "_scale"] = quantize_kv(new[name])
        for name, rows in new.items():
            for i in range(tcfg.num_layers):
                tattn._scatter_paged_kv(one.state["layers"][name][i], rows,
                                        table, pos + step)
                for c, kv in enumerate(ranks):
                    tattn.scatter_paged_kv_local(
                        kv.state["layers"][name][i], rows, table, pos + step,
                        c * kv.pages_per_chip)
    pn = one.pages_per_chip
    assert one.P == -(-14 // n) * n and pn == one.P // n
    for name, pool in one.state["layers"].items():
        shards = [kv.state["layers"][name] for kv in ranks]
        assert all(s.shape[1] == pn + 1 for s in shards)
        union = torch.cat([s[:, :pn] for s in shards], dim=1)
        assert torch.equal(union, pool), name
    pb = page_kv_bytes(tcfg, 4, torch.float32, kv_dtype)
    for kv in ranks:
        kv.verify()
        st = kv.memory_stats()
        assert st.mesh_chips == n and st.bytes_sink_per_chip == pb
        assert st.bytes_per_chip == st.bytes_total // n == pn * pb
        assert sum(t.numel() * t.element_size()
                   for t in kv.state["layers"].values()) == (pn + 1) * pb


# -------------------------------------------------------- allocator ----

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_locality_allocator_matches_jax(kv_dtype, n):
    """``PagedCache(locality_chips=n)`` against the JAX cache with the same
    knob, over one sequence of allocations (shared prefixes, a spill across
    chips, a deferral) and frees: page tables page for page after every
    call, the padding, ``usable_pages`` and the memory_stats fields."""
    jcfg, jlm, tcfg, tlm, _ = setup()
    jkv = jlm.init_cache(4, 32, dtype=jnp.float32, backend="paged",
                         page_size=4, num_pages=15, kv_dtype=kv_dtype,
                         locality_chips=n)
    tkv = tlm.init_cache(4, 32, page_size=4, num_pages=15, device="cpu",
                         kv_dtype=kv_dtype, locality_chips=n)
    sys_prompt = (np.arange(9) % 512).astype(np.int32)
    other = (np.arange(9) * 7 % 512).astype(np.int32)
    calls = [("alloc", 0, 17, sys_prompt), ("alloc", 1, 17, sys_prompt),
             ("alloc", 2, 9, other), ("alloc", 3, 32, other),
             ("free", 0), ("alloc", 3, 32, other), ("free", 1),
             ("alloc", 0, 12, sys_prompt), ("free", 2), ("free", 3),
             ("alloc", 1, 30, None), ("alloc", 2, 17, sys_prompt)]
    for call in calls:
        if call[0] == "alloc":
            _, slot, length, prefix = call
            if tkv._slot_pages[slot]:
                continue
            assert tkv.alloc(slot, length, prefix=prefix) == \
                jkv.alloc(slot, length, prefix=prefix), call
        else:
            tkv.free(call[1])
            jkv.free(call[1])
        assert tkv.page_table.tolist() == jkv.page_table.tolist(), call
        tkv.verify()
    assert tkv.P == jkv.P == -(-15 // n) * n
    assert tkv.pages_per_chip == jkv.pages_per_chip
    assert tkv.usable_pages() == jkv.usable_pages()
    ts, js = tkv.memory_stats(), jkv.memory_stats()
    for field in ("bytes_total", "bytes_reserved", "pages_total",
                  "pages_in_use", "pages_shared", "bytes_scales",
                  "mesh_chips", "bytes_per_chip", "bytes_scales_per_chip"):
        assert getattr(ts, field) == getattr(js, field), field
    assert ts.bytes_sink_per_chip == 0      # no pool group: nothing sharded
    if n == 4:
        spans = [{p // tkv.pages_per_chip for p in pages}
                 for pages in tkv._slot_pages if pages]
        assert any(len(s) > 1 for s in spans)


# ------------------------------------------------------ gloo engines ----

def _workloads(vocab):
    """The JAX sharded suite's three workloads (``test_serve_sharded.py``):
    ragged requests through a tight pool, int8 pages, and a shared system
    prompt whose pages land on different chips."""
    rng = np.random.default_rng(23)
    ragged = [(i, rng.integers(0, vocab, int(rng.integers(2, 10))).tolist(),
               int(rng.integers(3, 7))) for i in range(10)]
    rng = np.random.default_rng(37)
    quant = [(i, rng.integers(0, vocab, int(rng.integers(2, 9))).tolist(),
              int(rng.integers(2, 6))) for i in range(8)]
    sys_prompt = (np.arange(9) % vocab).tolist()
    rng = np.random.default_rng(5)
    prefix = [(i, sys_prompt + rng.integers(0, vocab, 2).tolist(), 4)
              for i in range(5)]
    base = dict(max_batch=4, max_seq=32, page_size=4)
    return {"native": (ragged, dict(base, num_pages=8)),
            "int8": (quant, dict(base, num_pages=16, kv_dtype="int8")),
            "prefix": (prefix, dict(base, num_pages=16))}


JAX_ENGINES = """
import dataclasses, jax, numpy as np
from repro.configs import CONFIGS
from repro.models import LM
from repro.parallel.mesh import make_mesh
from repro.serve import Request, ServeEngine
cfg = dataclasses.replace(CONFIGS['qwen3-4b'].reduced(), dtype='float32')
lm = LM(cfg)
params = lm.init(jax.random.key(0))
out = {}
for name, (reqs, kw) in WORK.items():
    eng = ServeEngine(lm, params, cache_backend='paged',
                      mesh=make_mesh((N,), ('model',)), **kw)
    for i, p, n in reqs:
        eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=n))
    out[name] = {r.id: r.out_tokens for r in eng.run_until_drained()}
print('STREAMS ' + json.dumps(out))
"""
JAX_ENGINES = "import json\n" + JAX_ENGINES

RANK = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.models import LM
from repro_torch.parallel import PoolGroup
from repro_torch.serve import Request, ServeEngine
rank, n, port, params_path = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
work = json.loads(sys.argv[5])
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                        rank=rank, world_size=n)
group = PoolGroup.of()
params, cfg = torch.load(params_path, weights_only=False)
lm = LM(cfg)
out = {}
for name, (reqs, kw) in work.items():
    for impl in ('kernel', 'gather'):
        eng = ServeEngine(lm, params, device='cpu', decode_impl=impl,
                          pool_group=group, **kw)
        for i, p, k in reqs:
            eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=k))
        done = eng.run_until_drained()
        eng.kv.verify()
        st = eng.kv.memory_stats()
        shard = eng.kv.state['layers']['k'].shape[1]
        assert st.pages_in_use == 0 and st.mesh_chips == n
        assert shard == eng.kv.pages_per_chip + 1 == eng.kv.P // n + 1
        assert eng.reg.gauge('serve_kv_bytes_per_chip').get() == \\
            st.bytes_per_chip + st.bytes_sink_per_chip
        out[f'{name}/{impl}'] = {r.id: r.out_tokens for r in done}
agree = [group.same_on_every_rank(b'same'),
         group.same_on_every_rank(str(rank).encode())]
dist.destroy_process_group()
print('STREAMS ' + json.dumps({'streams': out, 'agree': agree}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


def _streams(stdout: str):
    line = next(l for l in stdout.splitlines() if l.startswith("STREAMS "))
    return json.loads(line[len("STREAMS "):])


@functools.lru_cache(maxsize=None)
def _single_rank_streams():
    _, _, _, tlm, tparams = setup()
    out = {}
    for name, (reqs, kw) in _workloads(512).items():
        eng = ServeEngine(tlm, tparams, device="cpu", **kw)
        for i, p, k in reqs:
            eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=k))
        out[name] = {str(r.id): r.out_tokens
                     for r in eng.run_until_drained()}
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_ranks_match_single_rank_and_jax_sharded(n, tmp_path, subproc):
    """n spawned gloo ranks serve the three workloads through ``kernel``
    (K1's plain partials on the CPU) and ``gather``: each rank checks its
    shard, verify() and drain; every rank's streams agree (the engine
    raises otherwise) and equal the single-rank port's and the JAX sharded
    engine's on the same weights (JAX in a subprocess with n devices)."""
    _, _, tcfg, _, tparams = setup()
    params_path = tmp_path / "params.pt"
    torch.save((tparams, tcfg), params_path)
    work = json.dumps(_workloads(512))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(n), str(port),
         str(params_path), work], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
        for r in range(n)]
    try:
        jax_out = _streams(subproc(
            f"WORK = {_workloads(512)!r}\nN = {n}\n" + JAX_ENGINES,
            devices=n, timeout=240))
        results = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr
            results.append(_streams(stdout))
    finally:
        for p in procs:
            p.kill()
    single = _single_rank_streams()
    for r in results:
        assert r["agree"] == [True, False]
        assert r["streams"] == results[0]["streams"]
    for key, got in results[0]["streams"].items():
        name = key.split("/")[0]
        assert got == single[name], key
        assert got == jax_out[name], key


def test_launch_serve_mesh_2_under_torchrun():
    """``torch.distributed.run --nproc-per-node 2`` of the serve entry point
    with ``--mesh 2`` on the CPU: rank 0 prints the summary with the
    per-rank pool bytes."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.serve", "--device", "cpu", "--reduced",
         "--mesh", "2", "--requests", "4", "--max-batch", "2", "--max-seq",
         "32", "--new-tokens", "4", "--kv-dtype", "int8"],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("served 4 requests (4 completed), 16 tokens") == 1
    assert "sharded over 2 ranks" in res.stdout
    assert "kB/rank)" in res.stdout


def test_launch_serve_refuses_2d_mesh_and_missing_ranks():
    """A mesh without ``torch.distributed.run`` behind it exits naming it:
    ``--mesh 2x2`` (served since 2-D meshes were ported) asks for four
    processes, ``--mesh 2`` for two."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--nproc-per-node 4"):
        serve.main(["--device", "cpu", "--mesh", "2x2"])
    assert serve.parse_mesh("2x2") == (2, 2)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mesh", "2"], capture_output=True, text=True, cwd=ROOT,
        env=_env(), timeout=120)
    assert res.returncode != 0
    assert "torch.distributed.run" in res.stderr
