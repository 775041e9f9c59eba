"""Data pipeline: deterministic, host-local, restart-safe.

A copy of the reference's ``repro.train.data`` (numpy only), so the port's
batches are bitwise the reference's.  Batches are a pure function of
(step, host_id, shape): a restarted or replaced host regenerates exactly
its stream with no coordination.  Two sources:

  * SyntheticLM — structured pseudo-text (Zipfian unigrams + a repeated-ngram
    process) so small models have something learnable to overfit;
  * corpus mode — a token array (e.g. bytes of a file) sampled in windows.

A background prefetch thread keeps `prefetch` batches ahead of the consumer;
``close`` joins it with a timeout.  ``host_id`` defaults to 0: one process
feeds one device here.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 host_id: int = 0, seed: int = 0, corpus: np.ndarray | None = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.host = host_id
        self.seed = seed
        if corpus is None:
            # small deterministic "language": Zipf unigrams with ngram reuse
            rng = np.random.default_rng(seed)
            zipf = rng.zipf(1.5, size=1 << 16).astype(np.int64) % vocab_size
            self.corpus = zipf
        else:
            self.corpus = corpus.astype(np.int64) % vocab_size

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host, step]))
        n = len(self.corpus) - self.seq - 1
        starts = rng.integers(0, n, size=self.batch)
        idx = starts[:, None] + np.arange(self.seq + 1)[None, :]
        window = self.corpus[idx]
        return {"tokens": window[:, :-1].astype(np.int32),
                "targets": window[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background thread keeping `depth` batches ready."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self.source.get_batch(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
