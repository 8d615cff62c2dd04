"""The port's serve engine: greedy streams against the JAX ``ServeEngine`` on
the same weights and requests, allocator invariants every step, the
one-dispatch-per-iteration invariant, seeded streams independent of batch
composition, sampling against the JAX sampler, the launch entry point, and
the guards that keep the port free of JAX and off the CPU unless asked."""
import dataclasses
import functools
import re
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
from repro.serve import filtered_probs as jfiltered_probs
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.core import Autopilot, MetricsRegistry, SimCluster
from repro_torch.core.health import _measure_gemm_gflops, _measure_h2d_gbps
from repro_torch.models import LM
from repro_torch.models.params import from_jax
from repro_torch.serve import (Request, SamplingParams, ServeEngine,
                               filtered_probs, sample_batch)
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def setup(name="qwen3-4b"):
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


def _port_engine(tlm, tparams, **kw):
    kw = {"max_batch": 4, "max_seq": 32, "page_size": 4, "num_pages": 16,
          **kw}
    return ServeEngine(tlm, tparams, device="cpu", **kw)


def test_greedy_streams_match_jax_engine():
    """8 ragged requests with shared prefixes through a tight 16-page pool
    (admissions defer): the port's streams equal the JAX engine's.  A
    divergence is allowed only at a step whose top-2 logit gap is < 1e-4."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    work = _workload(jcfg.vocab_size)
    jeng = JServeEngine(jlm, jparams, max_batch=4, max_seq=32, page_size=4,
                        num_pages=16)
    teng = _port_engine(tlm, tparams)
    for i, prompt, new in work:
        jeng.submit(JRequest(i, prompt, max_new_tokens=new))
        teng.submit(Request(i, prompt, max_new_tokens=new))
    jout = {r.id: r.out_tokens for r in jeng.run_until_drained()}
    tout = {r.id: r.out_tokens for r in teng.run_until_drained()}
    assert teng.reg.counter("serve_admission_deferred_total").get() > 0
    assert sorted(tout) == sorted(jout) == list(range(8))
    for i, prompt, _ in work:
        a, b = tout[i], jout[i]
        if a == b:
            continue
        t = next(k for k in range(len(a)) if a[k] != b[k])
        seq = np.concatenate([prompt, np.asarray(a[:t], np.int32)])
        logits, _ = tlm.forward(tparams, torch.from_numpy(seq)[None].long())
        top2 = logits[0, -1, :tcfg.vocab_size].topk(2).values
        assert float(top2[0] - top2[1]) < 1e-4, (
            f"request {i} diverges at token {t}: {a} vs {b}")


def test_engine_invariants_every_step_and_pool_drains():
    _, _, _, _, tlm, tparams = setup()
    eng = _port_engine(tlm, tparams)
    for i, prompt, new in _workload(512, seed=4):
        eng.submit(Request(i, prompt, max_new_tokens=new))
    shared = 0
    while eng.step() or eng.queue:
        eng.kv.verify()
        shared = max(shared, eng.kv.memory_stats().pages_shared)
    eng.kv.verify()
    assert shared > 0, "the workload's common prefix was never shared"
    assert len(eng.finished) == 8
    assert all(r.status == "completed" for r in eng.finished)
    assert eng.kv.memory_stats().pages_in_use == 0
    reg = eng.reg
    assert reg.counter("serve_decode_dispatches_total").get() == \
        reg.counter("serve_iterations_total").get() > 0
    assert reg.gauge("serve_kv_pages_in_use").get() == 0
    assert reg.counter("serve_tokens_total").get() == \
        sum(len(r.out_tokens) for r in eng.finished)


def test_metric_names_are_documented():
    """Every metric the port's engine registers is a row of
    docs/telemetry.md with the same type."""
    _, _, _, _, tlm, tparams = setup()
    doc = dict(re.findall(r"^\|\s*`(serve_\w+)`\s*\|\s*(\w+)\s*\|",
                          (ROOT / "docs" / "telemetry.md").read_text(), re.M))
    reg = _port_engine(tlm, tparams).reg
    ours = {n: m.kind for n, m in reg._metrics.items()}
    assert ours and all(doc.get(n) == kind for n, kind in ours.items())


def test_seeded_stream_same_alone_and_in_full_batch():
    _, _, _, tcfg, tlm, tparams = setup()
    hot = SamplingParams(temperature=0.9, top_k=40, top_p=0.9, seed=17)
    prompt = np.arange(3, 12, dtype=np.int32)

    def run(others):
        eng = _port_engine(tlm, tparams, num_pages=None)
        eng.submit(Request(0, prompt, max_new_tokens=8, sampling=hot))
        for i, p, new in _workload(tcfg.vocab_size, n=others, seed=5):
            eng.submit(Request(i + 1, p, max_new_tokens=new,
                               sampling=SamplingParams(temperature=0.7,
                                                       seed=i)))
        return next(r.out_tokens for r in eng.run_until_drained()
                    if r.id == 0)

    assert run(0) == run(3)


def test_filtered_probs_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (4, 64)).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_k = np.array([0, 5, 0, 12], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.6], np.float32)
    exp = jfiltered_probs(jnp.asarray(logits), jnp.asarray(temp),
                          jnp.asarray(top_k), jnp.asarray(top_p))
    got = filtered_probs(torch.from_numpy(logits), torch.from_numpy(temp),
                         torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=2e-5,
                               atol=2e-6)


def test_sampling_draws_follow_filtered_distribution():
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]] * 2)
    temp = torch.tensor([0.0, 1.0])
    top_k, top_p = torch.tensor([0, 4]), torch.tensor([1.0, 1.0])
    p = filtered_probs(logits, temp, top_k, top_p)[1]
    draws = np.array([int(sample_batch(logits, temp, top_k, top_p,
                                       torch.tensor([0, 9]),
                                       torch.tensor([s, s]))[1])
                      for s in range(1000)])
    freq = np.bincount(draws, minlength=6) / len(draws)
    assert freq[4] == freq[5] == 0                  # cut by top-k
    np.testing.assert_allclose(freq, p.numpy(), atol=0.05)  # > 3 sigma
    greedy = sample_batch(logits, temp, top_k, top_p, torch.tensor([0, 9]),
                          torch.tensor([1, 1]))
    assert int(greedy[0]) == 0


def test_nonfinite_logits_raise():
    """An all-NaN final norm makes every logit row non-finite.  No error is
    raised any more: as in the JAX engine, each request is recovered by
    recompute until its retries run out, then dead-lettered with the
    reason on it; statuses, errors, retries and the fault counters equal
    the JAX engine's."""
    _, _, jparams, _, tlm, tparams = setup()
    jlm = setup()[1]
    bad = {**tparams, "final_norm": {"scale": torch.full_like(
        tparams["final_norm"]["scale"], float("nan"))}}
    jbad = {**jparams, "final_norm": {"scale": jnp.full_like(
        jparams["final_norm"]["scale"], jnp.nan)}}
    out = []
    for eng, make in ((_port_engine(tlm, bad, max_retries=2), Request),
                      (JServeEngine(jlm, jbad, max_batch=4, max_seq=32,
                                    page_size=4, num_pages=16,
                                    max_retries=2), JRequest)):
        for i in range(3):
            eng.submit(make(i, np.arange(5 + i, dtype=np.int32),
                            max_new_tokens=3))
        done = eng.run_until_drained(max_iters=200)
        out.append(([(r.id, r.status, r.error, r.retries, r.out_tokens)
                     for r in sorted(done, key=lambda r: r.id)],
                    eng.reg.counter("serve_stream_retries_total").get(
                        {"reason": "nonfinite_logits"}),
                    eng.reg.counter("serve_dead_letter_total").get(
                        {"reason": "nonfinite_logits"}),
                    eng.reg.gauge("serve_streams_quarantined").get()))
    assert out[0] == out[1]
    reqs, retries, dead, quarantined = out[0]
    assert [r[1] for r in reqs] == ["dead_letter"] * 3
    assert all(r[3] == 3 and r[4] == [] and "nonfinite_logits" in r[2]
               for r in reqs)
    assert (retries, dead, quarantined) == (9, 3, 0)


def _run(code_or_args, **kw):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *code_or_args],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300, **kw)


def test_launch_serve_runs_on_cpu():
    res = _run(["-m", "repro_torch.launch.serve", "--device", "cpu",
                "--reduced", "--requests", "4", "--max-batch", "2",
                "--max-seq", "32", "--new-tokens", "4"])
    assert res.returncode == 0, res.stderr
    assert "served 4 requests (4 completed), 16 tokens" in res.stdout
    assert "(1.00/iteration)" in res.stdout


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "import repro_torch.models.moe, repro_torch.models.encdec\n"
        "import repro_torch.parallel.collectives, repro_torch.parallel.mesh\n"
        "import repro_torch.parallel.sharding, repro_torch.parallel.tpmm\n"
        "import repro_torch.parallel.seqattn, repro_torch.parallel.epmoe\n"
        "import repro_torch.parallel.compression\n"
        "import repro_torch.parallel.pipeline, repro_torch.launch.pp_dryrun\n"
        "import repro_torch.configs.shapes, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.mesh, repro_torch.roofline.kernels\n"
        "import repro_torch.roofline.analysis, repro_torch.roofline.report\n"
        "import repro_torch.roofline.collectives\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    # 35, the ten of repro_torch.core, models.moe and models.encdec, the
    # nine of parallel training (parallel.collectives, mesh, sharding,
    # tpmm, seqattn, epmoe, compression, pipeline and launch.pp_dryrun),
    # and the dry-run's eight (configs.shapes, launch.dryrun, launch.mesh,
    # and roofline with its kernels, analysis, report and collectives)
    assert int(res.stdout) >= 56 + 8


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, _, tcfg, tlm, tparams = setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(tlm, tparams, max_batch=2, max_seq=16)
    res = _run(["-m", "repro_torch.launch.serve", "--requests", "1"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    # Autopilot's probes: on the card unless the CPU is asked for
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Autopilot(SimCluster(1), MetricsRegistry(), measure_real=True)
    for probe in (_measure_gemm_gflops, _measure_h2d_gbps):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe()
    assert Autopilot(SimCluster(1), MetricsRegistry()).device is None
