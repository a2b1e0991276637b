"""Baseline loaders the paper benchmarks against, reimplemented faithfully.

``MPLoader`` — process-based loading à la PyTorch DataLoader: N worker
processes, EACH receiving a pickled copy of the dataset object (the paper's
Table 2 startup cost and Fig 7 memory duplication), batches pickled back
over pipes, one-at-a-time deserialization in the parent (§3 "sequential
serialization").

``DecordLikeLoader`` — §5.3.4 critique: eagerly opens and decodes headers of
EVERY file at init (init time grows with dataset size, Table 4), keeps all
decoder state resident (unbounded resources), and dies on the first
malformed sample instead of skipping it.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Iterator

import numpy as np

from .codec import decode_sample, resize_nearest


def _mp_worker(dataset, hw, in_q: "mp.Queue", out_q: "mp.Queue") -> None:
    # `dataset` arrived pickled — the per-worker copy the paper measures
    while True:
        task = in_q.get()
        if task is None:
            break
        bi, indices = task
        imgs = [resize_nearest(decode_sample(dataset.read_bytes(i)), hw) for i in indices]
        batch = np.stack(imgs)
        out_q.put((bi, batch))  # pickled through the pipe (IPC cost)


class MPLoader:
    """Process-pool image loader (the PyTorch-DataLoader-shaped baseline)."""

    def __init__(self, dataset, *, batch_size=32, hw=(224, 224), num_workers=2, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.hw = hw
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.startup_s = 0.0

    def __iter__(self) -> Iterator[np.ndarray]:
        t0 = time.monotonic()
        ctx = mp.get_context("spawn")  # worker startup cost is part of the story
        in_q: mp.Queue = ctx.Queue()
        out_q: mp.Queue = ctx.Queue(self.prefetch * self.num_workers)
        procs = [
            ctx.Process(
                target=_mp_worker, args=(self.dataset, self.hw, in_q, out_q), daemon=True
            )
            for _ in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        n_batches = len(self.dataset) // self.batch_size
        for bi in range(n_batches):
            idx = list(range(bi * self.batch_size, (bi + 1) * self.batch_size))
            in_q.put((bi, idx))
        self.startup_s = time.monotonic() - t0
        try:
            pending: dict[int, np.ndarray] = {}
            next_bi = 0
            received = 0
            while received < n_batches:
                bi, batch = out_q.get()  # parent deserializes one-by-one (§3)
                pending[bi] = batch
                received += 1
                while next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
        finally:
            for _ in procs:
                in_q.put(None)
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()


class DecordLikeLoader:
    """Eager-init loader with unbounded resource usage (§5.3.4)."""

    def __init__(self, dataset, *, batch_size=8, hw=(224, 224)):
        self.batch_size = batch_size
        self.hw = hw
        t0 = time.monotonic()
        # open + decode EVERYTHING up front; fail hard on any bad sample
        self._decoded = [decode_sample(dataset.read_bytes(i)) for i in range(len(dataset))]
        self.init_s = time.monotonic() - t0

    def __iter__(self) -> Iterator[np.ndarray]:
        for bi in range(len(self._decoded) // self.batch_size):
            imgs = [
                resize_nearest(img, self.hw)
                for img in self._decoded[bi * self.batch_size : (bi + 1) * self.batch_size]
            ]
            yield np.stack(imgs)
