"""Deterministic, sharded, resumable data pipeline (the port's own copy of
the reference's numpy module, line for line: the same config, step and
shard give the reference's batch bit for bit).

Production constraints at pod scale:

- each data-parallel shard reads ONLY its slice (no global shuffle traffic);
- the cursor (step counter + rng state) is part of the checkpoint, so a
  restore replays the exact batch sequence (fault tolerance);
- host→device transfer is double-buffered (prefetch thread) so input never
  serializes the step.

The token source here is a synthetic corpus (hash-mixed token ids with
document structure) — a real deployment swaps `TokenSource` for a file
reader with identical cursor semantics.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0          # for frontend embedding stubs


class TokenSource:
    """Deterministic synthetic corpus: batch i is a pure function of
    (seed, i) — restart-safe without any saved buffer."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, shard: int = 0,
                 n_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        tokens = rng.integers(0, cfg.vocab_size,
                              size=(b, cfg.seq_len), dtype=np.int32)
        # inject document structure: BOS resets + short repeats so the loss
        # is learnable in the e2e example (not pure noise)
        bos = (rng.random((b, cfg.seq_len)) < 0.01)
        tokens = np.where(bos, 1, tokens)
        repeat = rng.random((b, cfg.seq_len)) < 0.3
        shifted = np.roll(tokens, 1, axis=1)
        tokens = np.where(repeat, shifted, tokens)
        out = {"tokens": tokens}
        if cfg.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        return out


class Pipeline:
    """Prefetching iterator with a checkpointable cursor."""

    def __init__(self, cfg: DataConfig, *, shard: int = 0, n_shards: int = 1,
                 prefetch: int = 2, start_step: int = 0):
        self.cfg = cfg
        self.source = TokenSource(cfg)
        self.shard, self.n_shards = shard, n_shards
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(s, self.shard, self.n_shards)
            try:
                self._q.put((s, batch), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            s, batch = self._q.get()
            if s == self.step:      # drop stale prefetches after a restore
                self.step += 1
                return batch
            if s > self.step:       # worker ahead of a rewound cursor
                self._restart_worker()

    def _restart_worker(self) -> None:
        self._stop.set()
        self._thread.join()
        self._q = queue.Queue(maxsize=self._q.maxsize)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- checkpoint integration ----------------------------------------
    def cursor(self) -> Dict[str, int]:
        return {"step": self.step, "shard": self.shard,
                "n_shards": self.n_shards, "seed": self.cfg.seed}

    def restore(self, cursor: Dict[str, int]) -> None:
        assert cursor["seed"] == self.cfg.seed, "seed mismatch on restore"
        self.step = int(cursor["step"])
        self._restart_worker()

    def close(self) -> None:
        self._stop.set()
