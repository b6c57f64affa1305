# Port copy of src/repro/data/pipeline.py: host-only, logic unchanged.
"""Sharded synthetic token pipeline with host-side prefetch.

Real runs would plug a tokenized corpus reader into the same interface; here
the generator is a seeded LCG-keyed synthetic stream with Zipfian token
frequencies (so cross-entropy actually decreases during the example runs and
compression benchmarks see realistic token-id entropy).

Multi-host layout: each process yields only its ``process_index`` slice of the
global batch (data parallelism across hosts); within a process the batch is
one host array per input, which the trainer copies to its device. A background
thread keeps ``prefetch`` batches ready so host data generation overlaps
device compute.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "PrefetchIterator"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_hosts: int = 1
    host_index: int = 0


class SyntheticTokens:
    """Deterministic, restartable synthetic token stream."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.step = 0
        # Zipf-ish stationary distribution over the vocab
        rng = np.random.RandomState(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()
        self._perm = rng.permutation(cfg.vocab)

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for ``step`` (restart-safe: pure function of (seed, step, host))."""
        c = self.cfg
        rng = np.random.RandomState((c.seed * 1_000_003 + step) * 31 + c.host_index)
        toks = rng.choice(c.vocab, size=(self.host_batch, c.seq_len + 1), p=self._p)
        toks = self._perm[toks].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1


class PrefetchIterator:
    """Host prefetch thread: overlaps batch synthesis with device compute."""

    def __init__(self, it: Iterator, prefetch: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            self._q.put(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
