"""Tokenized data pipeline (a copy of ``repro.data.pipeline``, numpy
only): deterministic per-host sharding + background prefetch.  Batches
stay numpy arrays; the trainer moves them to its device.

Sources: a memory-mapped flat token file (one giant uint16/uint32 stream,
the standard packed-LM format) or a synthetic deterministic stream (CI /
benchmarks).  Every host reads only its own slice — deterministic
host-indexed sharding means a straggling or restarted host re-derives its
stream from (step, host_id) alone: no shuffle barrier, no data-server
state, which is the straggler-mitigation property the trainer relies on.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    n_hosts: int = 1
    host_id: int = 0
    token_file: Optional[str] = None
    dtype: str = "int32"
    seed: int = 1234


class TokenSource:
    """Deterministic, restartable token stream for one host."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self.tokens = None
        if cfg.token_file:
            self.tokens = np.memmap(cfg.token_file, dtype=np.uint16,
                                    mode="r")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        T = cfg.seq_len
        out = np.empty((self.local_batch, T + 1), dtype=np.int32)
        for i in range(self.local_batch):
            row = step * cfg.global_batch + cfg.host_id * self.local_batch + i
            if self.tokens is not None:
                n = len(self.tokens) - (T + 1)
                off = (row * 977) % max(1, n)
                out[i] = np.asarray(self.tokens[off:off + T + 1],
                                    dtype=np.int32)
            else:
                rng = np.random.default_rng(cfg.seed + row)
                out[i] = rng.integers(0, cfg.vocab, size=T + 1,
                                      dtype=np.int32)
        return {"inputs": out[:, :-1], "labels": out[:, 1:]}


class Prefetcher:
    """Background-thread prefetch queue (keeps the accelerator fed)."""

    def __init__(self, source: TokenSource, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
