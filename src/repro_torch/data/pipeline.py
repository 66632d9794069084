"""Data pipeline: deterministic synthetic LM token streams and mmap'd
binary corpora, per-host sharding, background prefetch; the JAX package's
`repro.data.pipeline`, copied so the port imports nothing of it.

Synthetic mode generates a stationary Markov-ish token process (so the CE
loss has learnable structure), seeded per (host, step) with the same
uint64 arithmetic as the JAX package, so batch k is bit-equal across the
two packages, on every host of a job, and after a restart at step k.

Batches are numpy int32 on the host; `repro_torch.train.loop.train` moves
them to the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    kind: str = "synthetic"        # synthetic | mmap
    path: Optional[str] = None     # for mmap: flat int32 token file
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _synthetic_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Markov chain over a small state space embedded in the vocab."""
    rng = np.random.default_rng(
        np.uint64(cfg.seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(65_537) + np.uint64(cfg.host_id))
    b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab
    period = min(64, v - 1)
    base = rng.integers(0, period, size=(b, 1), dtype=np.int64)
    idx = np.arange(s + 1)[None, :]
    walk = (base + idx) % period
    noise = rng.integers(0, v, size=(b, s + 1))
    take_noise = rng.random((b, s + 1)) < 0.1
    toks = np.where(take_noise, noise, walk).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _mmap_batch(cfg: DataConfig, step: int, data: np.ndarray
                ) -> Dict[str, np.ndarray]:
    b, s = cfg.host_batch, cfg.seq_len
    n_tokens = data.shape[0]
    per_step = cfg.global_batch * (s + 1)
    start = (step * per_step + cfg.host_id * cfg.host_batch * (s + 1)) \
        % max(n_tokens - per_step - 1, 1)
    flat = data[start: start + b * (s + 1)]
    if flat.shape[0] < b * (s + 1):
        flat = np.resize(flat, b * (s + 1))
    toks = flat.reshape(b, s + 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DataIterator:
    """Step-indexed iterator with background prefetch."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._mmap = None
        if cfg.kind == "mmap":
            assert cfg.path, "mmap mode needs path"
            self._mmap = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        if self.cfg.kind == "synthetic":
            return _synthetic_batch(self.cfg, step)
        return _mmap_batch(self.cfg, step, self._mmap)

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            b = self.batch_at(s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __next__(self) -> Dict[str, np.ndarray]:
        s, b = self._q.get()
        self.step = s + 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def close(self):
        self._stop.set()
