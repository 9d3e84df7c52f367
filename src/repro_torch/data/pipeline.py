"""Deterministic synthetic data pipeline: document sampling, sequence
packing, host sharding, background prefetch.

A copy of ``repro/data/pipeline.py``, which is numpy only: the same
config gives the same batches, bit for bit, in either package.

Every batch is a pure function of (seed, step, host_id) — restarts resume
mid-stream with no data loss or duplication (checkpoint stores only the
step counter).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

PAD = -1
EOS = 1


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int           # per-host batch
    seed: int = 0
    mean_doc_len: int = 512
    host_id: int = 0
    n_hosts: int = 1


def _doc(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    n = max(8, int(rng.exponential(cfg.mean_doc_len)))
    toks = rng.integers(2, cfg.vocab_size, n)
    # inject learnable structure: local repetition (so loss can decrease)
    rep = rng.integers(2, 8)
    toks[rep:] = np.where(rng.random(n - rep) < 0.3, toks[:-rep], toks[rep:])
    return np.concatenate([toks, [EOS]])


def make_batch(cfg: DataConfig, step: int) -> dict:
    """Packed (inputs, labels) for ``step`` — deterministic, host-sharded."""
    out_inp = np.zeros((cfg.batch_size, cfg.seq_len), np.int32)
    out_lab = np.full((cfg.batch_size, cfg.seq_len), PAD, np.int32)
    for row in range(cfg.batch_size):
        rs = np.random.default_rng(
            (cfg.seed, step, cfg.host_id * cfg.batch_size + row))
        buf = np.empty(0, np.int64)
        while buf.size < cfg.seq_len + 1:
            buf = np.concatenate([buf, _doc(rs, cfg)])
        seq = buf[:cfg.seq_len + 1]
        out_inp[row] = seq[:-1]
        out_lab[row] = seq[1:]
    return {"tokens": out_inp, "labels": out_lab}


class Prefetcher:
    """Background-thread double buffering (the host-side input pipeline)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
