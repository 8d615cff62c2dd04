"""2-D batch x pages meshes in the port (``--mesh DxM``; ``PoolGroup`` over
a rank's model group, ``dp_group`` over its dp group) and the host tier
behind split pools, against the JAX package on the CPU: ``parse_mesh``
against the JAX launcher's parser; ``dp_rows``; four gloo ranks as a 2x2
mesh (built by the launcher's ``join_pool_group``) serving whole-prompt
and chunked, native and int8, also with the host tier, against the
single-rank port and, native, the JAX engine on
``make_mesh((2, 2), ('data', 'model'))`` in a subprocess with four
devices; the same ranks as two pairs of a 1-D split with the host tier,
whose stores must equal the JAX engine's single store; and
``repro_torch.launch.serve --mesh 2x2`` under ``torch.distributed.run``.
The D replicas of each pool shard must be bitwise equal, and every rank's
store the same.  The 2-layer reduced llama3.2-3b of the JAX sharded suite,
fp32."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve as jlaunch
from repro_torch.launch import serve as tlaunch
from repro_torch.parallel import PoolGroup
from repro_torch.parallel.pagedkv import dp_rows
from test_torch_contiguous import ROOT
from test_torch_sharded import _env, _free_port
from test_torch_tenancy import (MODS, engine, model,  # noqa: F401
                                one_torch_thread)


def test_parse_mesh_matches_jax_launcher():
    """Every ``--mesh`` form parses to the JAX launcher's (D, M), and an
    unknown axis exits with its message."""
    for spec in ("0", "4", "2x2", " 2X4 ", "2,2", "dp=2,model=2",
                 "model=4", "dp=1,model=2"):
        assert tlaunch.parse_mesh(spec) == jlaunch._parse_mesh(spec), spec
    msgs = []
    for parse in (tlaunch.parse_mesh, jlaunch._parse_mesh):
        with pytest.raises(SystemExit) as e:
            parse("dp=2,pipe=2")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "unknown axes ['pipe']" in msgs[0]


def test_dp_rows_split_the_batch_when_it_divides():
    """Replica d of D attends rows [d·B/D, (d+1)·B/D) when D > 1 divides
    the batch (the JAX ``_dp_or_none``); otherwise every row."""
    assert dp_rows(None, 4) is None
    assert dp_rows(PoolGroup(None, 0, 1), 4) is None
    assert dp_rows(PoolGroup(None, 1, 2), 4) == slice(2, 4)
    assert dp_rows(PoolGroup(None, 0, 2), 4) == slice(0, 2)
    assert dp_rows(PoolGroup(None, 1, 2), 3) is None
    assert dp_rows(PoolGroup(None, 3, 4), 8) == slice(6, 8)


# -------------------------------------------------------- gloo ranks ----

def _ragged(vocab):
    """The JAX 2-D mesh test's workload (``test_serve_sharded.py``)."""
    rng = np.random.default_rng(47)
    return [(i, rng.integers(0, vocab, int(rng.integers(2, 14))).tolist(),
             int(rng.integers(3, 7))) for i in range(8)]


def _shared(vocab, n=12, seed=29):
    """Two recurring 8-token system prompts (the JAX conformance suite's
    host-tier workload): offloads and prefetch hits on the same run."""
    rng = np.random.default_rng(seed)
    sys_prompts = [list(range(8)), [(i + 101) % vocab for i in range(8)]]
    reqs = []
    for i in range(n):
        if i % 3 == 2:
            prompt = rng.integers(0, vocab, int(rng.integers(2, 10))).tolist()
        else:
            prompt = sys_prompts[i % 2] + rng.integers(
                0, vocab, int(rng.integers(1, 5))).tolist()
        reqs.append((i, prompt, int(rng.integers(3, 7))))
    return reqs


def _work(vocab):
    """name -> (mesh kind, requests, engine keywords)."""
    base = dict(max_batch=4, max_seq=32, page_size=4)
    work = {}
    for kv in ("native", "int8"):
        for chunk in (0, 4):
            tag = f"{kv}-{'chunked' if chunk else 'whole'}"
            work[f"2d-{tag}"] = ("2d", _ragged(vocab), dict(
                base, num_pages=16, kv_dtype=kv, prefill_chunk=chunk))
            work[f"2d-host-{tag}"] = ("2d", _shared(vocab), dict(
                base, kv_dtype=kv, prefill_chunk=chunk, host_pages=32))
            work[f"1d-host-{tag}"] = ("1d", _shared(vocab), dict(
                base, kv_dtype=kv, prefill_chunk=chunk, host_pages=32))
    return work


RANK = """
import hashlib, json, os, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.serve import join_pool_group
from repro_torch.models import LM
from repro_torch.parallel import PoolGroup
from repro_torch.serve import Request, ServeEngine
rank, port, params_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
work = json.loads(sys.argv[4])
os.environ.update(RANK=str(rank), WORLD_SIZE='4', MASTER_ADDR='localhost',
                  MASTER_PORT=port)
group, dp_group, _ = join_pool_group(2, 2, 'cpu')
assert (group.rank, group.size, dp_group.rank, dp_group.size) == \\
    (rank % 2, 2, rank // 2, 2)
# the same ranks as two 1-D pairs: ranks 0, 1 and ranks 2, 3
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
pair = PoolGroup(pairs[rank // 2], rank % 2, 2)
params, cfg = torch.load(params_path, weights_only=False)
lm = LM(cfg)
out = {}
for name, (kind, reqs, kw) in work.items():
    groups = (dict(pool_group=group, dp_group=dp_group) if kind == '2d'
              else dict(pool_group=pair))
    eng = ServeEngine(lm, params, device='cpu', verify_cache=True,
                      **groups, **kw)
    for i, p, k in reqs:
        eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=k))
    done = eng.run_until_drained()
    st = eng.kv.memory_stats()
    assert st.pages_in_use == 0 and st.mesh_chips == 2
    # the pages requests own: not scratch page 0 (its row 0 takes every
    # parked slot's write at once, in no set order) nor the sink page
    lo = 1 if eng.kv.pool_group.rank == 0 else 0
    pools = hashlib.sha256(b''.join(
        t[:, lo:eng.kv.pages_per_chip].contiguous().view(torch.uint8)
        .numpy().tobytes()
        for t in eng.kv.state['layers'].values())).hexdigest()
    res = {'streams': {r.id: r.out_tokens for r in done}, 'pools': pools,
           'skipped': eng.reg.counter(
               'serve_prefill_chunks_skipped_total').get()}
    store = eng.kv.store
    if store is not None:
        res['store'] = [store.stats(), [k.hex() for k in store.keys()],
                        hashlib.sha256(b''.join(
                            v.contiguous().view(torch.uint8).numpy().tobytes()
                            for v in store.tier._slabs.values())).hexdigest()]
    out[name] = res
dist.destroy_process_group()
print('RESULT ' + json.dumps(out))
"""

JAX_2D = """
import json
out = {}
mesh = make_mesh((2, 2), ('data', 'model'))
for name, (reqs, kw) in WORK.items():
    eng = ServeEngine(lm, params, cache_backend='paged', mesh=mesh,
                      dp_axis='data', **kw)
    for i, p, n in reqs:
        eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=n))
    out[name] = {r.id: r.out_tokens for r in eng.run_until_drained()}
print('STREAMS ' + json.dumps(out))
"""


def _single_rank(work):
    """The single-rank port (and, with a tier, its store's stats and key
    order) on every workload."""
    out = {}
    for name, (_, reqs, kw) in work.items():
        eng = engine(MODS[1], **kw)
        for i, p, k in reqs:
            eng.submit(MODS[1].Request(i, np.asarray(p, np.int32),
                                       max_new_tokens=k))
        res = {"streams": {str(r.id): r.out_tokens
                           for r in eng.run_until_drained()}}
        if eng.kv.store is not None:
            res["store"] = [eng.kv.store.stats(),
                            [k.hex() for k in eng.kv.store.keys()]]
        out[name] = res
    return out


def _jax_single_store(reqs, kw):
    """The JAX engine's outcome and store (stats, key order) on one
    device: what every rank's store must equal."""
    eng = engine(MODS[0], **kw)
    for i, p, k in reqs:
        eng.submit(MODS[0].Request(i, np.asarray(p, np.int32),
                                   max_new_tokens=k))
    done = eng.run_until_drained()
    return ({str(r.id): r.out_tokens for r in done},
            [eng.kv.store.stats(), [k.hex() for k in eng.kv.store.keys()]])


def test_2x2_gloo_ranks_match_jax_2d_mesh_and_single_rank(tmp_path, subproc):
    """Four gloo ranks, rank r at (r // 2, r % 2): as a 2x2 mesh, whole and
    chunked, native and int8, with and without the host tier; then as two
    1-D pairs with the tier.  Every rank emits the same streams (the
    engine's check runs over the whole world), equal to the single-rank
    port's; the 2x2 native streams equal the JAX engine's on a 2x2
    ('data', 'model') mesh; each pool shard is bitwise equal on its two
    dp replicas; every rank's store (stats, key order, slab bytes) is the
    same, and its stats and keys are the single-rank port's and, native,
    the JAX engine's single store."""
    _, _, _, tlm, tparams = model()
    vocab = tlm.cfg.vocab_size
    params_path = tmp_path / "params.pt"
    torch.save((tparams, tlm.cfg), params_path)
    work = _work(vocab)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(port), str(params_path),
         json.dumps(work)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(), cwd=ROOT) for r in range(4)]
    try:
        jax_work = {name: (reqs, kw) for name, (kind, reqs, kw)
                    in work.items() if name in ("2d-native-whole",
                                                "2d-native-chunked")}
        jax_2d = json.loads(next(
            line for line in subproc(f"WORK = {jax_work!r}\n" + JAX_2D_HEAD
                                     + JAX_2D, devices=4,
                                     timeout=300).splitlines()
            if line.startswith("STREAMS "))[8:])
        single = _single_rank(work)
        jax_stores = {name: _jax_single_store(reqs, kw)
                      for name, (kind, reqs, kw) in work.items()
                      if name in ("1d-host-native-whole",
                                  "1d-host-native-chunked")}
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    results = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("RESULT "))[7:])
               for out, _ in outs]
    for name, (kind, _, _) in work.items():
        runs = [r[name] for r in results]
        assert all(run["streams"] == runs[0]["streams"] for run in runs)
        assert runs[0]["streams"] == single[name]["streams"], name
        if name in jax_2d:
            assert runs[0]["streams"] == jax_2d[name], name
        if kind == "2d":
            # shard m on replicas d = 0 and 1: ranks m and m + 2
            assert runs[0]["pools"] == runs[2]["pools"], name
            assert runs[1]["pools"] == runs[3]["pools"], name
        if "store" in runs[0]:
            assert all(run["store"] == runs[0]["store"] for run in runs)
            assert runs[0]["store"][:2] == single[name]["store"], name
            assert runs[0]["store"][0]["hits"] > 0, name
        if name in jax_stores:
            streams, store = jax_stores[name]
            assert runs[0]["streams"] == streams, name
            assert runs[0]["store"][:2] == store, name
    assert any(results[0][name]["skipped"] for name in work
               if "host" in name and "chunked" in name)


JAX_2D_HEAD = """
import dataclasses, jax, numpy as np
from repro.configs import CONFIGS
from repro.models import LM
from repro.parallel.mesh import make_mesh
from repro.serve import Request, ServeEngine
cfg = dataclasses.replace(CONFIGS['llama3.2-3b'].reduced(), dtype='float32',
                          num_layers=2)
lm = LM(cfg)
params = lm.init(jax.random.key(0))
"""


def _launch_lines(text):
    """The launcher lines that carry no time."""
    keep = []
    for line in text.splitlines():
        if line.startswith("served "):
            keep.append(line.split(" in ")[0])
        elif line.startswith(("host tier [", "chunked prefill [")):
            keep.append(line)
    return keep


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
def test_launch_serve_mesh_2x2_under_torchrun(chunk, capsys):
    """``torch.distributed.run --nproc-per-node 4`` of the serve entry point
    with ``--mesh 2x2`` and the persistent store on the CPU: rank 0 alone
    prints the summary, which names the split and the dp replicas, and
    whose outcome, host-tier and chunk lines are the single-process
    launcher's on the same flags."""
    flags = ["--device", "cpu", "--reduced", "--requests", "6",
             "--max-batch", "4", "--max-seq", "32", "--new-tokens", "4",
             "--page-size", "4", "--host-pages", "16", "--prefix-store",
             "--prefill-chunk", str(chunk)]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.serve", "--mesh", "2x2"] + flags,
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("served 6 requests (6 completed)") == 1
    assert "sharded over 2 ranks" in res.stdout
    assert "replicated over 2 dp replicas" in res.stdout
    tlaunch.main(flags)
    single = capsys.readouterr().out
    assert _launch_lines(res.stdout) == _launch_lines(single)
    assert any(line.startswith("host tier [16 pages, persistent store]")
               for line in _launch_lines(single))
