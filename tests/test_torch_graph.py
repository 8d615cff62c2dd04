"""The fused decode step as one CUDA graph on a card (``-m gpu``): a
single-card ``ServeEngine`` captures its step when it is built and replays
it every decode iteration; ``cuda_graph=False`` runs the same step eagerly.
Without a card every test here skips; the file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_graph.py

Gates: graph and eager engines give bitwise-equal logit rows at every
decode step and equal streams over native pages, int8 pages, the gathered
read and the contiguous cache, and with chunked prefill over native and
int8 pages, also with rows sampled at temperature > 0; launch counts are
exact after replays; a replay with a slot shielded mid-prefill equals the
eager step bitwise and leaves that slot's pages alone; chunk dispatches
between replays keep the graph's operands; a pool re-allocated after
capture raises at the next replay; a capture that fails raises."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.serve import Request, SamplingParams, ServeEngine

KINDS = {"native": {}, "int8": {"kv_dtype": "int8"},
         "gather": {"decode_impl": "gather"},
         "contiguous": {"cache_backend": "contiguous"},
         "chunked": {"prefill_chunk": 8, "prefill_budget": 16},
         "chunked-int8": {"prefill_chunk": 8, "prefill_budget": 16,
                          "kv_dtype": "int8"}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph captures the port's "
                    "kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _model(dtype="bfloat16"):
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), dtype=dtype)
    lm = LM(cfg)
    return lm, lm.init(3, device="cuda")


def _engine(kind, graph, dtype="bfloat16", **kw):
    lm, params = _model(dtype)
    return ServeEngine(lm, params, max_batch=4, max_seq=64, page_size=8,
                       device="cuda", cuda_graph=graph,
                       **{**KINDS[kind], **kw})


def _requests(vocab, sampled=False):
    """10 ragged prompts of 5-40 tokens, every third opening with the same
    16-token prefix; with ``sampled`` every other request draws at
    temperature 0.8 from its own seed."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, 16)
    out = []
    for i in range(10):
        prompt = rng.integers(0, vocab, int(rng.integers(5, 41)))
        if i % 3 == 0:
            prompt = np.concatenate([prefix, prompt[:8]])
        sp = SamplingParams(temperature=0.8 if sampled and i % 2 else 0.0,
                            top_k=20, top_p=0.9, seed=i)
        out.append(Request(i, prompt.astype(np.int32),
                           max_new_tokens=int(rng.integers(6, 14)),
                           sampling=sp))
    return out


def _serve(eng, sampled=False):
    """Serve the requests; returns the streams and the live rows of every
    decode step (from the replay's rows, or the eager step's)."""
    rows = []
    if eng._graph is not None:
        def replay(view, run=eng._replay):
            out = run(view)
            rows.append(out[0][torch.from_numpy(eng.active).cuda()].clone())
            return out
        eng._replay = replay
    else:
        def decode(view, run=eng._decode):
            out = run(view)
            rows.append(out[0][torch.from_numpy(eng.active).cuda()].clone())
            return out
        eng._decode = decode
    for r in _requests(eng.lm.cfg.vocab_size, sampled):
        eng.submit(r)
    done = eng.run_until_drained()
    assert len(done) == 10 and all(r.status == "completed" for r in done)
    return {r.id: r.out_tokens for r in done}, rows


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(KINDS))
def test_graph_step_equals_eager_step_bitwise(kind):
    _card()
    graph = _engine(kind, True)
    eager = _engine(kind, False)
    assert graph._graph is not None and eager._graph is None
    assert graph.graph_stats["pool_bytes"] >= 0
    got, got_rows = _serve(graph)
    exp, exp_rows = _serve(eager)
    decodes = graph.reg.counter("serve_decode_dispatches_total").get()
    assert len(got_rows) == len(exp_rows) == decodes > 0
    for k, (a, b) in enumerate(zip(got_rows, exp_rows)):
        assert torch.equal(a, b), f"{kind}: decode step {k} differs"
    assert got == exp


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["native", "contiguous"])
def test_graph_with_sampled_rows_equals_eager(kind):
    """Greedy rows come from the replay; rows at temperature > 0 are drawn
    eagerly from the replay's rows, as the eager engine draws them."""
    _card()
    got, _ = _serve(_engine(kind, True), sampled=True)
    exp, _ = _serve(_engine(kind, False), sampled=True)
    assert got == exp


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(KINDS))
def test_graph_launch_counts_are_exact(kind):
    """Per replay the graph counts what it captured: K1 once a layer (none
    over the contiguous cache or the gathered read), K3 at every norm;
    each bf16 whole-prompt prefill dispatch launches K2 once a layer, each
    chunk dispatch K3 at every norm and no K2."""
    _card()
    eng = _engine(kind, True)
    cfg = eng.lm.cfg
    L = cfg.num_layers
    norms = L * (2 + 2 * cfg.qk_norm) + 1
    k1 = None
    if eng.kv.backend == "paged" and eng.decode_impl == "kernel":
        k1 = "paged_flash_decode" + ("_int8" if eng.kv.quantized else "")
    assert eng._graph_launches == {"rmsnorm_rows": norms,
                                   **({k1: L} if k1 else {})}
    replays = []

    def replay(view, run=eng._replay):
        replays.append(1)
        return run(view)

    eng._replay = replay
    ops.reset_launch_counts()
    _serve(eng)
    decodes = eng.reg.counter("serve_decode_dispatches_total").get()
    prefills = eng.reg.counter("serve_prefill_dispatches_total").get()
    assert len(replays) == decodes
    want = {name: 0 for name in ops.KERNELS}
    want.update({"flash_attention_bhsd": 0 if eng.chunk else prefills * L,
                 "rmsnorm_rows": (decodes + prefills) * norms})
    if k1:
        want[k1] = decodes * L
    assert ops.launch_counts() == want
    if eng.chunk:
        assert eng.reg.counter("serve_prefill_chunks_total").get() > prefills
        assert eng.reg.counter("serve_decode_stall_iters").get() == 0


def _mid_prefill(kind):
    """A chunked engine (chunks of 8, one a step) with two live streams and
    a 40-token prompt half landed: returns (engine, its slot)."""
    eng = _engine(kind, True, prefill_chunk=8)
    vocab = eng.lm.cfg.vocab_size
    rng = np.random.default_rng(5)
    for i in range(2):
        eng.submit(Request(i, rng.integers(0, vocab, 6).astype(np.int32),
                           max_new_tokens=30))
    eng.step()
    eng.step()
    eng.submit(Request(9, rng.integers(0, vocab, 40).astype(np.int32),
                       max_new_tokens=4))
    eng.step()
    eng.step()
    (slot, st), = eng.prefilling.items()
    assert 0 < st.done < 40 and not eng.active[slot]
    return eng, slot


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["native", "int8"])
def test_replay_with_slot_shielded_mid_prefill_equals_eager(kind):
    """With a slot mid-prefill (inactive, its table row shielded to
    scratch) one replay's (B, V) rows are bitwise the eager step's on the
    same static inputs, and neither touches the slot's landed pages."""
    _card()
    eng, slot = _mid_prefill(kind)
    view = eng.kv.decode_view()
    assert not view["page_table"][slot].any()
    pages = torch.as_tensor(eng.kv._slot_pages[slot], device="cuda").long()
    before = {n: t[:, pages].clone() for n, t in eng.kv.state["layers"].items()}
    eager, _ = eng._decode(view)
    replayed, _ = eng._replay(view)
    assert torch.equal(eager, replayed)
    for name, t in eng.kv.state["layers"].items():
        assert torch.equal(t[:, pages], before[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["native", "int8"])
def test_chunk_dispatch_between_replays_keeps_graph_operands(kind):
    """A chunk dispatch writes the pools in place between two replays: the
    pools' and the table's pointers stay the captured ones, so every later
    replay runs, and the run drains."""
    _card()
    eng, slot = _mid_prefill(kind)
    ptrs = eng._graph_ptrs
    for _ in range(4):
        chunks = eng.reg.counter("serve_prefill_chunks_total").get()
        eng.step()
        assert eng._operand_ptrs(eng.kv.decode_view()) == ptrs
        if slot not in eng.prefilling:
            break
        assert eng.reg.counter("serve_prefill_chunks_total").get() > chunks
    assert slot not in eng.prefilling and eng.active[slot]
    done = eng.run_until_drained()
    assert len(done) == 3 and all(r.status == "completed" for r in done)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["native", "int8", "contiguous"])
def test_pool_reallocated_after_capture_raises(kind):
    _card()
    eng = _engine(kind, True)
    layers = eng.kv.state["layers"]
    name = "k_scale" if kind == "int8" else "v"
    layers[name] = layers[name].clone()
    eng.submit(Request(0, np.arange(1, 9, dtype=np.int32),
                       max_new_tokens=4))
    with pytest.raises(RuntimeError, match="re-allocated after"):
        eng.run_until_drained()


@pytest.mark.gpu
def test_failed_capture_raises(monkeypatch):
    """A step that fails under capture raises from the constructor with its
    cause; nothing falls back to the eager step."""
    _card()
    run = ServeEngine._decode

    def failing(self, view):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("cannot be captured")
        return run(self, view)

    monkeypatch.setattr(ServeEngine, "_decode", failing)
    with pytest.raises(RuntimeError,
                       match="capturing the fused decode step") as err:
        _engine("native", True)
    assert "cannot be captured" in str(err.value.__cause__)
    eng = _engine("native", False)           # eager only when asked
    assert eng._graph is None
