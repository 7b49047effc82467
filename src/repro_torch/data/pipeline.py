"""Token data pipeline: synthetic + memmap sources, shard-aware,
background-prefetched.

``TokenSource`` implementations produce (tokens, targets) numpy batches
for *this host's shard* of the global batch.  ``Prefetcher`` keeps N
batches in flight on a worker thread so a slow source never stalls the
step (the local half of straggler mitigation; the distributed half is
the datafeed service's replicated RPC issue).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class ShardInfo:
    host_id: int = 0
    num_hosts: int = 1


class SyntheticSource:
    """Deterministic zipf-ish token stream (reproducible per host/step)."""

    def __init__(self, vocab: int, seq_len: int, batch_per_host: int,
                 shard: ShardInfo = ShardInfo(), seed: int = 0,
                 frontend: Optional[tuple] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch_per_host
        self.shard = shard
        self.seed = seed
        self.frontend = frontend            # (frontend_seq, frontend_dim)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.shard.host_id)
        # zipf-flavored distribution clipped to the vocab
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = (z % (self.vocab - 2)) + 1
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }
        if self.frontend:
            fs, fd = self.frontend
            batch["frontend"] = rng.standard_normal(
                (self.batch, fs, fd)).astype(np.float32) * 0.1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapSource:
    """Flat binary token file (uint16/uint32), sampled in contiguous
    windows — the standard packed-corpus layout."""

    def __init__(self, path: str, vocab: int, seq_len: int,
                 batch_per_host: int, dtype=np.uint16,
                 shard: ShardInfo = ShardInfo(), seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch_per_host
        self.shard = shard
        self.seed = seed
        self.n_windows = (len(self.data) - 1) // seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.shard.host_id)
        idx = rng.integers(0, self.n_windows, size=self.batch)
        toks = np.stack([
            np.asarray(self.data[i * self.seq_len:
                                 i * self.seq_len + self.seq_len + 1])
            for i in idx]).astype(np.int32)
        toks = np.clip(toks, 0, self.vocab - 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Runs a source iterator on a daemon thread, N batches ahead."""

    def __init__(self, source, depth: int = 2):
        self._it = iter(source)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except Exception as e:                      # surface in next()
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
