"""Tokenized-dataset pipeline of the port: memmap-backed binary shards,
deterministic sharded reads per data-parallel rank, sequence packing and
background prefetch.  A copy, in numpy and the standard library only, of
the JAX package's ``data/pipeline.py`` (the port imports nothing of it),
so the same corpus, seed and step give byte-identical batches in both.

Determinism contract: ``batch_at(step)`` is a pure function of (step, seed,
topology), so a job restarted from a checkpoint consumes exactly the token
stream it would have seen without the failure."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator

import numpy as np


def write_token_shards(directory: str, tokens: np.ndarray,
                       shard_tokens: int = 1 << 20) -> list:
    """Write a flat uint32 token stream into .bin shards + index."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(0, len(tokens), shard_tokens):
        p = d / f"tokens_{i // shard_tokens:06d}.bin"
        tokens[i:i + shard_tokens].astype(np.uint32).tofile(p)
        paths.append(p)
    (d / "index.txt").write_text(
        "\n".join(f"{p.name} {p.stat().st_size // 4}" for p in paths))
    return paths


def synthetic_corpus(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Zipf-ish synthetic token stream (markov-free but skewed like text)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab, size=n_tokens, p=probs).astype(np.uint32)


class TokenDataset:
    """Memmap view over the shard directory."""

    def __init__(self, directory: str):
        d = Path(directory)
        index = [(line.split()[0], int(line.split()[1]))
                 for line in (d / "index.txt").read_text().splitlines()]
        self.maps = [np.memmap(d / name, np.uint32, "r", shape=(n,))
                     for name, n in index]
        self.total = sum(len(m) for m in self.maps)
        self._starts = np.cumsum([0] + [len(m) for m in self.maps])

    def slice(self, start: int, length: int) -> np.ndarray:
        start = start % max(self.total - length - 1, 1)
        out = np.empty(length + 1, np.uint32)
        got = 0
        while got <= length:
            si = int(np.searchsorted(self._starts, start, "right") - 1)
            m = self.maps[si]
            off = start - self._starts[si]
            take = min(len(m) - off, length + 1 - got)
            out[got:got + take] = m[off:off + take]
            got += take
            start += take
        return out


@dataclass
class LoaderConfig:
    batch_size: int            # global batch (sequences)
    seq_len: int
    dp_rank: int = 0
    dp_size: int = 1
    seed: int = 0


class DeterministicLoader:
    """Sharded deterministic loader: rank r reads rows [r::dp_size] of the
    global batch for any step, from any restart point."""

    def __init__(self, dataset: TokenDataset, cfg: LoaderConfig):
        if cfg.batch_size % cfg.dp_size:
            raise ValueError(f"batch {cfg.batch_size} is not a multiple of "
                             f"dp_size {cfg.dp_size}")
        self.ds = dataset
        self.cfg = cfg
        self.local_bs = cfg.batch_size // cfg.dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        starts = rng.integers(0, max(self.ds.total - c.seq_len - 1, 1),
                              size=c.batch_size)
        mine = starts[c.dp_rank::c.dp_size]
        toks = np.stack([self.ds.slice(int(s), c.seq_len) for s in mine])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def pack_documents(docs: list, seq_len: int, eos_id: int,
                   pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Sequence packing: greedy first-fit of documents into fixed-length rows
    with EOS separators and a loss mask that excludes padding and the token
    that would predict across a document boundary.

    Returns {"tokens", "labels"} (n_rows, seq_len) int32 and "loss_mask"
    (n_rows, seq_len) float32."""
    rows: list = []
    row: list = []
    boundaries: list = []
    row_bounds: list = []
    for doc in docs:
        need = len(doc) + 1
        if len(row) + need > seq_len + 1 and row:
            rows.append(row)
            row_bounds.append(boundaries)
            row, boundaries = [], []
        row.extend(list(doc) + [eos_id])
        boundaries.append(len(row) - 1)
    if row:
        rows.append(row)
        row_bounds.append(boundaries)

    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    labels = np.full((n, seq_len), pad_id, np.int32)
    mask = np.zeros((n, seq_len), np.float32)
    for i, (r, bnds) in enumerate(zip(rows, row_bounds)):
        r = r[:seq_len + 1]
        toks = np.asarray(r[:-1] if len(r) > seq_len else r, np.int32)
        tokens[i, :len(toks)] = toks[:seq_len]
        lab = np.asarray(r[1:len(toks) + 1], np.int32)
        labels[i, :len(lab)] = lab
        mask[i, :len(lab)] = 1.0
        for b in bnds:                       # don't predict across docs
            if 0 <= b < seq_len:
                mask[i, b] = 0.0
    return {"tokens": tokens, "labels": labels, "loss_mask": mask}


class PrefetchLoader:
    """Background-thread prefetch: a daemon thread fills a queue of
    ``depth`` ``(step, batch)`` pairs from ``loader.batch_at``, starting at
    ``start_step``; ``next()`` takes the next pair, ``close()`` stops the
    thread, drains the queue and joins the thread."""

    def __init__(self, loader: DeterministicLoader, depth: int = 2,
                 start_step: int = 0):
        self.loader = loader
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.loader.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
