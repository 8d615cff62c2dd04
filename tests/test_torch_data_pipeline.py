"""The port's sequence packing and background prefetch against the JAX
package's (``repro.data.pipeline``): ``pack_documents`` byte-equal on the
fixed case of the JAX tests, on a seeded numpy sweep and, where hypothesis
is installed, on drawn documents; ``PrefetchLoader`` yields JAX's
``(step, batch)`` sequence from ``start_step`` and ``close()`` joins its
thread."""
import numpy as np
import pytest

from repro import data as jdata_pkg
from repro.data import pipeline as jdata
from repro_torch import data as tdata_pkg
from repro_torch.data import pipeline as tdata
from test_torch_tenancy import one_torch_thread  # noqa: F401

try:                    # optional dev dependency (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

KEYS = ("tokens", "labels", "loss_mask")


def _assert_byte_equal(docs, seq_len, eos_id, pad_id=0):
    ours = tdata.pack_documents(docs, seq_len, eos_id, pad_id)
    theirs = jdata.pack_documents(docs, seq_len, eos_id, pad_id)
    assert sorted(ours) == sorted(theirs) == sorted(KEYS)
    for key in KEYS:
        assert ours[key].dtype == theirs[key].dtype, key
        assert ours[key].shape == theirs[key].shape, key
        assert ours[key].tobytes() == theirs[key].tobytes(), key


def test_exports_match_jax():
    assert sorted(tdata_pkg.__all__) == sorted(jdata_pkg.__all__)


def test_pack_documents_fixed_case_byte_equal_to_jax():
    """The case of ``tests/test_extensions.py``'s packing test, and a
    document longer than a row."""
    docs = [np.arange(1, 6), np.arange(10, 13), np.arange(20, 29)]
    _assert_byte_equal(docs, 12, 0)
    _assert_byte_equal(docs + [np.arange(30, 60)], 12, 0, pad_id=3)


@pytest.mark.parametrize("seed", range(8))
def test_pack_documents_seeded_sweep_byte_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        docs = [rng.integers(1, 500, rng.integers(1, 40)).astype(np.int32)
                for _ in range(rng.integers(1, 12))]
        _assert_byte_equal(docs, int(rng.integers(4, 64)),
                           int(rng.integers(0, 500)),
                           int(rng.integers(0, 3)))


if HAVE_HYPOTHESIS:
    @given(st.lists(st.lists(st.integers(1, 1000), min_size=1, max_size=70),
                    min_size=1, max_size=12),
           st.integers(2, 64), st.integers(0, 1000))
    @settings(max_examples=60, deadline=None)
    def test_pack_documents_drawn_documents_byte_equal_to_jax(docs, seq_len,
                                                              eos_id):
        _assert_byte_equal([np.asarray(d, np.int32) for d in docs], seq_len,
                           eos_id)
else:                                       # pragma: no cover
    def test_pack_documents_drawn_documents_byte_equal_to_jax():
        pytest.importorskip("hypothesis")


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    toks = tdata.synthetic_corpus(40_000, 512, seed=4)
    tdata.write_token_shards(d, toks, shard_tokens=8192)
    cfg = dict(batch_size=4, seq_len=32, seed=9)
    return (tdata.DeterministicLoader(tdata.TokenDataset(d),
                                      tdata.LoaderConfig(**cfg)),
            jdata.DeterministicLoader(jdata.TokenDataset(d),
                                      jdata.LoaderConfig(**cfg)))


@pytest.mark.parametrize("depth,start_step", [(1, 0), (2, 5), (4, 17)])
def test_prefetch_loader_yields_jax_sequence_and_close_joins(
        loaders, depth, start_step):
    ours_loader, jax_loader = loaders
    ours = tdata.PrefetchLoader(ours_loader, depth=depth,
                                start_step=start_step)
    theirs = jdata.PrefetchLoader(jax_loader, depth=depth,
                                  start_step=start_step)
    try:
        assert ours.q.maxsize == theirs.q.maxsize == depth
        for i in range(6):
            (s, a), (t, b) = next(ours), next(theirs)
            assert s == t == start_step + i
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
                assert a[key].tobytes() == \
                    ours_loader.batch_at(s)[key].tobytes()
    finally:
        ours.close()
        theirs.close()
    assert not ours._thread.is_alive()
