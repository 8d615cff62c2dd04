"""The vlm family in the port (internvl2-2b: the dense GQA decoder behind a
stub ViT's patch embeddings) against the JAX package on the CPU: the
config, ``img_pos`` and ``embed_inputs``, the forward, prefill cache and
loss with image embeddings, the image's effect on the text logits; the
serve engine in lockstep with the JAX engine (slots, positions, page
tables and counters after every step, then streams) with a seeded image
per request over native pages, int8 pages and the contiguous cache; no
prefix sharing and no prefix-store lookup for image prompts; chunked
prefill refused with JAX's message; a preempted vlm request resumed to
JAX's stream; and the serve launcher on JAX's workload and weights.

A reduced internvl2-2b (2 layers, 8 image positions) in fp32, JAX weights
from ``key(0)`` with ``img_pos`` redrawn from a seed (JAX zeros it at init,
which would hide a dropped position table), carried over by ``from_jax``.

The JAX engine casts a request's image to the dtype of the first leaf of
its cache state, which for int8 pages is the int8 K pool: its int8 runs see
each image truncated to integers (ROADMAP Queue 3).  The port casts images
to the compute dtype; the int8 lockstep hands it the truncated image that
JAX's engine computes with, and a check shows the truncation is real."""
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

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.configs import CONFIGS as JCONFIGS
from repro.models import LM as JLM
from repro.models import ForwardOpts as JOpts
from repro.models.lm import text_len as jtext_len
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.launch import serve as tlaunch
from repro_torch.models import LM
from repro_torch.models.lm import text_len
from repro_torch.models.params import from_jax
from repro_torch.train.optimizer import tree_leaves
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NAME = "internvl2-2b"
FWD = dict(rtol=2e-5, atol=2e-5)
MODS = (jserve, tserve)
COUNTERS = ("serve_admission_deferred_total", "serve_preemptions_total",
            "serve_prefill_dispatches_total", "serve_prefill_tokens_total",
            "serve_decode_dispatches_total", "serve_tokens_total")


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = dataclasses.replace(JCONFIGS[NAME].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS[NAME].reduced(), dtype="float32")
    jlm = JLM(jcfg)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.key(0)))
    rng = np.random.default_rng(41)
    tree["img_pos"] = rng.normal(0, 0.5, tree["img_pos"].shape).astype(
        np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax(tree, tcfg, device="cpu")
    return jcfg, jlm, jparams, tcfg, LM(tcfg), tparams


def _image(seed, n=1):
    cfg = setup()[0]
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, cfg.num_image_tokens, cfg.d_model)).astype(
        np.float32)


def _batch(seed, b=2, s=24):
    cfg = setup()[0]
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "img_embeds": _image(seed + 100, b)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ----------------------------------------------------------------- model ---

def test_config_copy_equals_jax():
    j, t = JCONFIGS[NAME], TCONFIGS[NAME]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.param_count() == t.param_count()
    for s in (64, 300, 512):
        assert text_len(t, s) == jtext_len(j, s)
    assert text_len(TCONFIGS["qwen3-4b"], 64) == 64


def test_forward_prefill_and_loss_match_jax():
    """Logits over the image and text positions, the prefill's K/V (image
    rows first) and its last row, and the loss (image logits dropped)."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    batch = _batch(1)
    opts = JOpts(attn_impl="dense", remat="none")
    jl, _, jcache = jlm.forward(jparams, batch, opts, collect_cache=True)
    tb = _t(batch)
    with torch.no_grad():
        tl, tcache = tlm.forward(tparams, tb["tokens"].long(),
                                 collect_cache=True,
                                 img_embeds=tb["img_embeds"])
        last, pcache = tlm.prefill(tparams, tb["tokens"].long(),
                                   img_embeds=tb["img_embeds"])
        tloss, tm = tlm.loss(tparams, tb)
    assert tl.shape[1] == jcfg.num_image_tokens + 24
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1:], **FWD)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **FWD)
        assert torch.equal(pcache["layers"][key], tcache["layers"][key])
    jloss, jm = jlm.loss(jparams, batch, opts)
    for key in ("loss", "nll", "z_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **FWD)
    with pytest.raises(ValueError, match="img_embeds"):
        tlm.loss(tparams, {k: v for k, v in tb.items() if k != "img_embeds"})


def test_image_changes_the_text_logits():
    """JAX's ``test_vlm_image_tokens_change_text_logits``, and the text
    logits move as JAX's do."""
    _, jlm, jparams, _, tlm, tparams = setup()
    batch = _batch(2)
    moved = dict(batch, img_embeds=batch["img_embeds"] + 1.0)
    n = setup()[0].num_image_tokens
    outs = []
    for b in (batch, moved):
        with torch.no_grad():
            tl, _ = tlm.forward(tparams, torch.from_numpy(b["tokens"]).long(),
                                img_embeds=torch.from_numpy(b["img_embeds"]))
        jl, _, _ = jlm.forward(jparams, b, JOpts(attn_impl="dense"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
        outs.append(tl[:, n:])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


# ---------------------------------------------------------------- engine ---

def engine(mod, **kw):
    _, jlm, jparams, _, tlm, tparams = setup()
    if mod is jserve:
        return jserve.ServeEngine(jlm, jparams, **kw)
    return tserve.ServeEngine(tlm, tparams, device="cpu", **kw)


def snapshot(eng):
    snap = ([None if r is None else r.id for r in eng.slot_req],
            [r.id for r in eng.queue], eng.active.tolist(),
            eng.slot_pos.tolist(),
            {c: sorted(eng.reg.counter(c).labels_values())
             for c in COUNTERS})
    if eng.kv.backend == "paged":
        st = eng.kv.memory_stats()
        snap += (eng.kv.page_table.tolist(), st.pages_in_use,
                 st.pages_shared)
    return snap


def lockstep(make_engine, arrivals, max_iters=200, port_image=None):
    """Drive a JAX and a port engine through ``arrivals`` ({iteration:
    [(id, prompt, max_new, image, tenant)]}), equal snapshots after every
    step; ``port_image`` maps the image the port is handed.  Returns both
    engines once drained."""
    engs = [make_engine(mod) for mod in MODS]
    last = max(arrivals)
    for it in range(max_iters):
        for eng, mod in zip(engs, MODS):
            for i, prompt, new, img, tenant in arrivals.get(it, []):
                if mod is tserve and port_image is not None \
                        and img is not None:
                    img = port_image(img)
                eng.submit(mod.Request(i, prompt.copy(), max_new_tokens=new,
                                       img_embeds=img, tenant=tenant))
        live = [eng.step() for eng in engs]
        assert snapshot(engs[1]) == snapshot(engs[0]), f"step {it}"
        assert live[0] == live[1]
        if it >= last and not any(live) and not engs[0].queue:
            break
    else:
        raise AssertionError("the engines did not drain")
    streams = [sorted((r.id, r.status, tuple(r.out_tokens), r.preemptions)
                      for r in e.finished) for e in engs]
    assert streams[1] == streams[0]
    if engs[1].kv.backend == "paged":
        engs[1].kv.verify()
    return engs


def _arrivals(seed=5, tenant="default"):
    """Four requests, three with their own image and one without (zeros),
    two arriving at iteration 3 while the first decode."""
    rng = np.random.default_rng(seed)
    vocab = setup()[0].vocab_size
    imgs = _image(seed, 3)
    reqs = [(i, rng.integers(0, vocab, n).astype(np.int32), new,
             imgs[i] if i < 3 else None, tenant)
            for i, (n, new) in enumerate(((5, 8), (11, 6), (3, 9), (7, 5)))]
    return {0: reqs[:2], 3: reqs[2:]}


def _trunc(img):
    return np.trunc(img).astype(np.float32)


@pytest.mark.parametrize("backend,kv_dtype", [("paged", "native"),
                                              ("paged", "int8"),
                                              ("contiguous", "native")])
def test_engine_streams_and_counters_match_jax(backend, kv_dtype):
    kw = dict(max_batch=2, max_seq=48, cache_backend=backend,
              kv_dtype=kv_dtype)
    if backend == "paged":
        kw["page_size"] = 8
    engs = lockstep(lambda m: engine(m, **kw), _arrivals(),
                    port_image=_trunc if kv_dtype == "int8" else None)
    assert all(len(r.out_tokens) == r.max_new_tokens
               for r in engs[1].finished)
    assert engs[1].img_len == 8


def test_int8_jax_engine_truncates_images():
    """The reference quirk the int8 lockstep accounts for: JAX's int8
    engine serves an image and its integer truncation alike, and another
    image than its native engine does."""
    kw = dict(max_batch=2, max_seq=48, page_size=8)
    out = {}
    for name, kv, img in (("x", "int8", None), ("trunc", "int8", _trunc),
                          ("native", "native", None)):
        eng = engine(jserve, kv_dtype=kv, **kw)
        for i, prompt, new, im, _ in _arrivals()[0] + _arrivals()[3]:
            eng.submit(jserve.Request(
                i, prompt.copy(), max_new_tokens=new,
                img_embeds=im if img is None or im is None else img(im)))
        out[name] = sorted((r.id, r.out_tokens)
                           for r in eng.run_until_drained())
    assert out["x"] == out["trunc"]
    assert out["x"] != out["native"]


def test_image_prompts_share_no_prefix_and_skip_the_store():
    """Two requests with the same prompt and image: a dense engine would
    share the prefix pages; the vlm engine shares none and never looks the
    prefix store up, as JAX's does."""
    prompt = np.arange(1, 40, dtype=np.int32)
    img = _image(9)[0]
    arrivals = {0: [(0, prompt, 4, img, "default")],
                2: [(1, prompt, 4, img, "default")]}
    kw = dict(max_batch=2, max_seq=64, page_size=8, host_pages=16)
    engs = lockstep(lambda m: engine(m, **kw), arrivals)
    for eng in engs:
        assert eng.reg.gauge("serve_kv_pages_shared").get() == 0
    assert engs[1].kv.memory_stats().pages_shared == 0
    stats = engs[1].kv.store.stats()
    assert stats["hits"] == stats["misses"] == 0
    assert engs[0].kv.store.stats()["hits"] == 0


def test_chunked_prefill_refused_with_jax_message():
    msgs = []
    for mod in MODS:
        with pytest.raises(ValueError) as e:
            engine(mod, max_batch=2, max_seq=64, page_size=8,
                   prefill_chunk=8)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "VLM image-embed prefixes prefill whole-prompt" in msgs[1]
    with pytest.raises(ValueError, match="image tokens"):
        engine(tserve, max_batch=1, max_seq=16).submit(tserve.Request(
            0, np.arange(1, 9, dtype=np.int32)))


def test_preempted_vlm_request_resumes_to_jax_stream():
    """Two bulk vlm decodes fill both slots; a chat request arriving at
    iteration 4 preempts one, which resumes by a prefill of its image,
    prompt and emitted tokens, at its image-offset position."""
    rng = np.random.default_rng(7)
    vocab = setup()[0].vocab_size
    imgs = _image(13, 3)
    ps = [rng.integers(0, vocab, n).astype(np.int32) for n in (10, 10, 6)]
    arrivals = {0: [(i, ps[i], 12, imgs[i], "bulk") for i in range(2)],
                4: [(2, ps[2], 4, imgs[2], "chat")]}

    def make(m):
        ten = m.TenancyConfig([m.TenantSpec("chat", "interactive"),
                               m.TenantSpec("bulk", "batch")])
        return engine(m, max_batch=2, max_seq=64, page_size=8, num_pages=14,
                      tenancy=ten)
    engs = lockstep(make, arrivals)
    pre = [r for r in engs[1].finished if r.preemptions]
    assert pre and all(len(r.out_tokens) == 12 for r in pre)


# -------------------------------------------------------------- launcher ---

def test_launcher_serves_internvl2_like_the_jax_engine(capsys):
    """The port's serve launcher path with ``--arch internvl2-2b`` on the
    JAX weights gives the JAX engine's greedy streams for the JAX
    launcher's requests, which carry no image (zeros)."""
    jcfg, jlm, jparams, _, _, tparams = setup()
    args = tlaunch.parse_args(["--device", "cpu", "--arch", NAME,
                               "--requests", "6", "--new-tokens", "6"])
    rng = np.random.default_rng(0)
    jeng = jserve.ServeEngine(jlm, jparams, args.max_batch, args.max_seq)
    for i in range(6):
        prompt = rng.integers(0, jcfg.vocab_size,
                              rng.integers(4, 12)).astype(np.int32)
        jeng.submit(jserve.Request(i, prompt, max_new_tokens=6))
    exp = {r.id: r.out_tokens for r in jeng.run_until_drained()}
    eng = tlaunch.serve(args, None, "cpu", params=tparams)
    assert "served 6 requests (6 completed)" in capsys.readouterr().out
    assert {r.id: r.out_tokens for r in eng.finished} == exp


def test_launchers_run_on_cpu(tmp_path):
    """``repro_torch.launch.serve --arch internvl2-2b`` serves; the train
    launcher fails as JAX's does, on the image embeddings its token
    loader does not make, naming them."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "TMPDIR": str(tmp_path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--arch", NAME, "--requests", "3", "--new-tokens", "3"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "served 3 requests (3 completed), 9 tokens" in res.stdout
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--arch", NAME, "--steps", "1", "--batch", "2",
         "--seq", "32"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    assert res.returncode != 0
    assert "ValueError" in res.stderr and "img_embeds" in res.stderr
    assert "family=vlm" in res.stdout


def test_port_params_carry_img_pos():
    _, _, jparams, tcfg, _, tparams = setup()
    assert tparams["img_pos"].dtype == torch.float32
    np.testing.assert_array_equal(tparams["img_pos"].numpy(),
                                  np.asarray(jparams["img_pos"]))
    assert len(tree_leaves(tparams)) == len(jax.tree.leaves(jparams))
