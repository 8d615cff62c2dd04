"""The port's contiguous KV cache and the main path's gates against JAX:
``ContiguousCache`` accounting and refusals, paged (``"gather"``,
M·page == S) against contiguous bitwise at every decode step and in the
engine streams, the north-star gate (the port's launcher path against the
JAX engine on the JAX launcher's workload and weights, both cache
backends), 32-token greedy rollouts at the ``LM`` level over the raw dense
cache against JAX ``LM.decode_step``, the fused step's static inputs, and
the launcher with ``--cache-backend contiguous``.  Reduced fp32 configs;
logits to 2e-5; greedy tokens equal, except at a step whose top-2 logit
gap is below 1e-4."""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import LM as JLM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kvcache import contiguous_kv_bytes as jcontiguous_kv_bytes
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import LM
from repro_torch.models.params import from_jax
from repro_torch.serve import (ContiguousCache, PagedCache, Request,
                               ServeEngine)
from repro_torch.serve.kvcache import contiguous_kv_bytes
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-4b", "llama3.2-3b"]
TOL = dict(rtol=2e-5, atol=2e-5)
GAP = 1e-4          # a greedy tie: both tokens are right


@functools.lru_cache(maxsize=None)
def setup(name="qwen3-4b"):
    """The JAX launcher's model and weights (``jax.random.key(0)`` on the
    reduced fp32 config) and the same weights in the port."""
    jcfg = dataclasses.replace(JCONFIGS[name].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32")
    jparams = JLM(jcfg).init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, JLM(jcfg), jparams, tcfg, LM(tcfg), tparams


def _workload(vocab, n=8, seed=3):
    """Ragged prompts in two buckets (8 and 16); every other request opens
    with the same 8-token prefix (two shared pages of 4)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 8)
    out = []
    for i in range(n):
        plen = int(rng.integers(5, 15))
        prompt = rng.integers(0, vocab, plen)
        if i % 2 == 0:
            prompt = np.concatenate([prefix, prompt[:max(plen - 8, 1)]])
        out.append((i, prompt.astype(np.int32), int(rng.integers(4, 8))))
    return out


def _tie_at(tlm, tparams, prompt, stream, t) -> float:
    """The top-2 logit gap of the port's forward where a stream diverges."""
    seq = np.concatenate([prompt, np.asarray(stream[:t], np.int32)])
    logits, _ = tlm.forward(tparams, torch.from_numpy(seq)[None].long())
    top2 = logits[0, -1, :tlm.cfg.vocab_size].topk(2).values
    return float(top2[0] - top2[1])


def _assert_streams_match(tlm, tparams, prompts, got, exp) -> int:
    """Equal streams, or a first divergence at a top-2 gap below ``GAP``;
    returns how many streams pass only by that tie rule."""
    assert sorted(got) == sorted(exp)
    ties = 0
    for i, a in got.items():
        b = exp[i]
        assert len(a) == len(b), (i, a, b)
        if a != b:
            t = next(k for k in range(len(a)) if a[k] != b[k])
            assert _tie_at(tlm, tparams, prompts[i], a, t) < GAP, (
                f"request {i} diverges at token {t}: {a} vs {b}")
            ties += 1
    return ties


# ---------------------------------------------------------- the cache ----

def test_contiguous_cache_accounting_and_refusals():
    jcfg, _, _, tcfg, tlm, tparams = setup()
    kv = tlm.init_cache(3, 24, backend="contiguous", device="cpu",
                        dtype=torch.float32)
    assert isinstance(kv, ContiguousCache) and kv.backend == "contiguous"
    want = contiguous_kv_bytes(tcfg, 3, 24, torch.float32)
    assert want == jcontiguous_kv_bytes(jcfg, 3, 24, jnp.float32)
    for k in ("k", "v"):
        assert tuple(kv.state["layers"][k].shape) == (
            tcfg.num_layers, 3, 24, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    st = kv.memory_stats()
    assert st.bytes_total == st.bytes_reserved == st.bytes_per_chip == want
    assert (st.slots_total, st.slots_in_use) == (3, 0)
    assert kv.can_ever_fit(24) and not kv.can_ever_fit(25)
    assert kv.alloc(0, 24, prefix=np.arange(20, dtype=np.int32)) == 0
    assert kv.alloc(2, 1) == 0
    st = kv.memory_stats()
    assert st.bytes_reserved == st.bytes_total == want
    assert st.slots_in_use == 2 and st.pages_total == st.page_size == 0
    with pytest.raises(AssertionError, match="already allocated"):
        kv.alloc(0, 4)
    kv.free(0)
    assert kv.memory_stats().slots_in_use == 1
    assert kv.decode_view() is kv.state and "page_table" not in kv.state
    # the raw dense cache of backend=None: what decode_step takes directly
    raw = tlm.init_cache(3, 24, backend=None, device="cpu")
    assert set(raw) == {"layers"} and all(
        torch.equal(raw["layers"][k], kv.state["layers"][k]) for k in "kv")
    # JAX's refusals: int8 pages and a split pool are paged formats
    with pytest.raises(ValueError, match="int8"):
        tlm.init_cache(2, 32, backend="contiguous", device="cpu",
                       kv_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        tlm.init_cache(2, 32, backend=None, device="cpu", kv_dtype="int8")
    with pytest.raises(ValueError, match="pages"):
        tlm.init_cache(2, 32, backend="contiguous", device="cpu",
                       pool_group=object())
    with pytest.raises(ValueError, match="pages"):
        tlm.init_cache(2, 32, backend="contiguous", device="cpu",
                       locality_chips=2)
    with pytest.raises(ValueError, match="int8"):
        ServeEngine(tlm, tparams, 2, 32, device="cpu",
                    cache_backend="contiguous", kv_dtype="int8")
    with pytest.raises(ValueError, match="cache_backend"):
        ServeEngine(tlm, tparams, 2, 32, device="cpu", cache_backend="dense")
    with pytest.raises(ValueError, match="backend"):
        tlm.init_cache(2, 32, backend="dense", device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_paged_gather_equals_contiguous_bitwise_each_step(name):
    """The same prefill block written into a paged pool (page 4, M·page ==
    S, shuffled pages) and into contiguous rows, then 10 decode steps at
    ragged positions with a freed slot parked at position 0: the live
    slots' logits are bitwise equal at every step."""
    _, _, _, tcfg, tlm, tparams = setup(name)
    b, s, page = 4, 32, 4
    rng = np.random.default_rng(21)
    lens = [5, 11, 16, 0]                       # slot 3 stays free
    paged = PagedCache(tcfg, b, s, page_size=page, device="cpu",
                       dtype=torch.float32, prefix_sharing=False)
    for pid in rng.permutation(b * s // page)[:8] + 1:
        paged._free_chip[0].remove(int(pid))   # scatter the slots' pages
        paged._free_chip[0].insert(0, int(pid))
    contig = tlm.init_cache(b, s, backend="contiguous", device="cpu",
                            dtype=torch.float32)
    tokens = rng.integers(0, tcfg.vocab_size, (3, 16)).astype(np.int32)
    _, cache = tlm.forward(tparams, torch.from_numpy(tokens).long(),
                           collect_cache=True)
    dest = np.zeros((3, 16), np.int32)
    for j in range(3):
        assert paged.alloc(j, s) == 0 and contig.alloc(j, s) == 0
        dest[j] = paged.prefill_dest(j, 16, lens[j])
    paged.staged_write_prefill(cache["layers"], torch.from_numpy(dest))
    contig.staged_write_prefill(cache["layers"], torch.arange(3))
    assert paged.page_table.max() > 0
    pos = np.array(lens, np.int32)
    live = np.array([True, True, True, False])
    for step in range(10):
        toks = torch.from_numpy(
            rng.integers(0, tcfg.vocab_size, (b, 1))).long()
        p = torch.from_numpy(np.where(live, pos + step, 0).astype(np.int32))
        lp, _ = tlm.decode_step(tparams, toks, paged.decode_view(), p,
                                decode_impl="gather")
        lc, _ = tlm.decode_step(tparams, toks, contig.decode_view(), p,
                                decode_impl="kernel")      # ignored
        assert torch.equal(lp[:3], lc[:3]), f"step {step}"


@pytest.mark.parametrize("prefix_sharing", [True, False])
def test_engine_paged_gather_equals_contiguous_bitwise(prefix_sharing):
    """The shared-prefix workload through a paged engine (``"gather"``,
    M·page == S) and a contiguous one: every decode step's live logit rows
    bitwise equal and the same streams."""
    _, _, _, tcfg, tlm, tparams = setup()
    rows, streams = {}, {}
    for backend in ("paged", "contiguous"):
        eng = ServeEngine(tlm, tparams, max_batch=4, max_seq=32, page_size=4,
                          device="cpu", decode_impl="gather",
                          cache_backend=backend,
                          prefix_sharing=prefix_sharing)
        rows[backend] = []

        def decode(view, run=eng._decode, eng=eng, out=rows[backend]):
            r, tok = run(view)
            out.append(r[torch.from_numpy(eng.active)].clone())
            return r, tok

        shared = []

        def alloc(*a, run=eng.kv.alloc, **kw):
            shared.append(run(*a, **kw))
            return shared[-1]

        eng._decode, eng.kv.alloc = decode, alloc
        for i, prompt, new in _workload(tcfg.vocab_size):
            eng.submit(Request(i, prompt, max_new_tokens=new))
        streams[backend] = {r.id: r.out_tokens
                            for r in eng.run_until_drained()}
        # paged with sharing: later requests read the prefix pages of an
        # earlier one (contiguous shares nothing)
        assert (max(shared) > 0) == (backend == "paged" and prefix_sharing)
    assert len(rows["paged"]) == len(rows["contiguous"]) > 0
    for k, (a, b) in enumerate(zip(rows["paged"], rows["contiguous"])):
        assert torch.equal(a, b), f"decode step {k}"
    assert streams["paged"] == streams["contiguous"]
    assert len(streams["paged"]) == 8


# -------------------------------------------------- the north-star gate ----

def _jax_launcher_requests(n, vocab, new_tokens):
    """The JAX launcher's request draw (``repro.launch.serve``, greedy)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        prompt = rng.integers(0, vocab, rng.integers(4, 12)).astype(np.int32)
        out.append(JRequest(i, prompt, max_new_tokens=new_tokens))
    return out


@pytest.mark.parametrize("backend", ["paged", "contiguous"])
def test_launcher_streams_match_jax_engine(backend, capsys):
    """The north star: the port's launcher path (``parse_args``,
    ``serve``) on the JAX launcher's weights, through ``from_jax``, and
    the JAX engine with the JAX launcher's defaults (16 requests,
    max_batch 4, max_seq 128, 16 new tokens, reduced fp32) emit the same
    greedy streams."""
    jcfg, jlm, jparams, _, tlm, tparams = setup()
    args = tlaunch.parse_args(["--device", "cpu", "--cache-backend",
                               backend])
    assert (args.arch, args.reduced, args.requests, args.max_batch,
            args.max_seq, args.new_tokens, args.temperature) == (
        "qwen3-4b", True, 16, 4, 128, 16, 0.0)
    jreqs = _jax_launcher_requests(16, jcfg.vocab_size, 16)
    treqs = tlaunch.draw_requests(args, jcfg.vocab_size)
    assert [r.prompt.tolist() for r in treqs] == \
        [r.prompt.tolist() for r in jreqs]
    assert [r.sampling.seed for r in treqs] == list(range(16))
    jeng = JServeEngine(jlm, jparams, 4, 128, cache_backend=backend)
    for r in jreqs:
        jeng.submit(r)
    exp = {r.id: r.out_tokens for r in jeng.run_until_drained()}
    eng = tlaunch.serve(args, None, "cpu", params=tparams)
    assert f"kv cache [{backend}]" in capsys.readouterr().out
    assert eng.kv.backend == backend
    got = {r.id: r.out_tokens for r in eng.finished}
    assert all(len(s) == 16 for s in got.values())
    ties = _assert_streams_match(tlm, tparams,
                                 {r.id: r.prompt for r in jreqs}, got, exp)
    print(f"{backend}: {ties} of 16 streams equal only by the tie rule")
    assert ties == 0


# ------------------------------------------------------------ rollouts ----

@pytest.mark.parametrize("name", ARCHS)
def test_32_token_rollouts_over_dense_cache_match_jax(name):
    """Two ragged prompts prefilled into the raw dense cache of each
    package, then 32 greedy decode steps: the logits agree to 2e-5 at every
    step, and the port's greedy token is JAX's except at a top-2 gap below
    1e-4 (both then continue from JAX's token)."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup(name)
    b, s, steps = 2, 48, 32
    rng = np.random.default_rng(31)
    lens = np.array([5, 9], np.int32)
    tokens = np.zeros((b, 16), np.int32)
    for j, n in enumerate(lens):
        tokens[j, :n] = rng.integers(0, jcfg.vocab_size, n)
    jl, _, jpre = jlm.forward(jparams, {"tokens": jnp.asarray(tokens)},
                              collect_cache=True)
    tl, tpre = tlm.forward(tparams, torch.from_numpy(tokens).long(),
                           collect_cache=True)
    jcache = jlm.init_cache(b, s, dtype=jnp.float32)
    tcache = tlm.init_cache(b, s, backend=None, device="cpu")
    for k in ("k", "v"):
        jcache["layers"][k] = jcache["layers"][k].at[:, :, :16].set(
            jpre["layers"][k])
        tcache["layers"][k][:, :, :16] = tpre["layers"][k]
    jstep = jax.jit(jlm.decode_step)
    idx = np.arange(b)
    exp = np.asarray(jl)[idx, lens - 1, :jcfg.vocab_size]
    got = tl[idx, lens - 1, :tcfg.vocab_size].numpy()
    pos = lens.copy()
    ties = 0
    for t in range(steps + 1):
        np.testing.assert_allclose(got, exp, **TOL)
        top2 = np.sort(exp, axis=-1)[:, -2:]
        same = got.argmax(-1) == exp.argmax(-1)
        assert (same | (top2[:, 1] - top2[:, 0] < GAP)).all(), t
        ties += int((~same).sum())
        if t == steps:
            break
        nxt = exp.argmax(-1).astype(np.int32)[:, None]
        jlog, jcache = jstep(jparams, jnp.asarray(nxt), jcache,
                             jnp.asarray(pos))
        tlog, tcache = tlm.decode_step(tparams, torch.from_numpy(nxt).long(),
                                       tcache, torch.from_numpy(pos))
        exp = np.asarray(jlog)[:, -1, :jcfg.vocab_size]
        got = tlog[:, -1, :tcfg.vocab_size].numpy()
        pos = pos + 1
    print(f"{name}: {ties} greedy steps of {b * (steps + 1)} equal only "
          "by the tie rule")
    assert ties == 0
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][k].numpy(),
                                   np.asarray(jcache["layers"][k]), **TOL)


# ------------------------------------------------ the static step inputs ----

def test_decode_view_table_is_one_tensor_refreshed_on_alloc_and_free():
    _, _, _, tcfg, _, _ = setup()
    kv = PagedCache(tcfg, 3, 32, page_size=4, device="cpu",
                    dtype=torch.float32)
    table = kv.decode_view()["page_table"]
    assert table.dtype == torch.int32 and tuple(table.shape) == (3, 8)
    prompt = np.arange(9, dtype=np.int32)
    for change in (lambda: kv.alloc(0, 9, prefix=prompt),
                   lambda: kv.alloc(2, 20, prefix=prompt),
                   lambda: kv.free(0), lambda: kv.alloc(1, 32),
                   lambda: kv.free(2), lambda: kv.free(1)):
        change()
        view = kv.decode_view()
        assert view["page_table"] is table
        assert np.array_equal(table.numpy(), kv.page_table)
    assert not kv.page_table.any()


def test_fused_step_inputs_are_static_buffers_and_counts_keep_meaning():
    """On the CPU the engine runs the eager step over the same static
    buffers the card's CUDA graph reads (no graph); ``launches_recorded``
    takes a capture's counts back out and ``count_replay`` adds them."""
    _, _, _, tcfg, tlm, tparams = setup()
    eng = ServeEngine(tlm, tparams, max_batch=3, max_seq=32, page_size=4,
                      device="cpu")
    assert eng._graph is None and eng.graph_stats is None
    bufs = (eng._tokens.dev, eng._positions.dev, eng._active.dev,
            eng.kv.decode_view()["page_table"])
    for i, prompt, new in _workload(tcfg.vocab_size, n=5):
        eng.submit(Request(i, prompt, max_new_tokens=new))
    seen = []
    while eng.step() or eng.queue:
        seen.append((eng._positions.dev.clone(), eng._active.dev.clone()))
        assert (eng._tokens.dev, eng._positions.dev, eng._active.dev,
                eng.kv.decode_view()["page_table"]) == bufs
    assert len(eng.finished) == 5 and len(seen) > 5
    assert any(bool(a.any()) and not bool(a.all()) for _, a in seen)
    before = ops.launch_counts()
    with ops.launches_recorded() as rec:
        ops.KERNELS["rmsnorm_rows"].launches += 3
        ops.KERNELS["paged_flash_decode"].launches += 2
    assert rec == {"rmsnorm_rows": 3, "paged_flash_decode": 2}
    assert ops.launch_counts() == before
    ops.count_replay(rec)
    after = ops.launch_counts()
    assert after["rmsnorm_rows"] == before["rmsnorm_rows"] + 3
    assert after["paged_flash_decode"] == before["paged_flash_decode"] + 2
    ops.count_replay({k: -v for k, v in rec.items()})


def test_launch_serve_contiguous_on_cpu():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--cache-backend", "contiguous", "--requests", "4",
         "--max-batch", "2", "--max-seq", "32", "--new-tokens", "4"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "served 4 requests (4 completed), 16 tokens" in out
    assert "(1.00/iteration)" in out
    assert "kv cache [contiguous]: " in out and " pages of " not in out
    assert "decode impl" not in out
