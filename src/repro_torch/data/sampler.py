"""Checkpointable, shard-aware sampler.

Solves the paper's §3 multi-processing critique head-on: with thread-based
loading the sampler state lives in ONE place, so "which samples have been
consumed" is exactly checkpointable — ``state_dict()`` is saved with the
model checkpoint and training resumes with no overlap and no gaps.

Deterministic shuffling: per-epoch permutation from (seed, epoch); each data
rank takes a strided slice (rank::world) of the permutation.

Shard-aware mode (``shard_sizes=...``): a uniform global shuffle visits
shards in random order per *sample*, which defeats any shard-granular cache
— every batch touches dozens of shards.  Instead the epoch order is built
as (1) shuffle the *shards*, (2) concatenate their sample ranges, (3) a
bounded-displacement local shuffle: no sample moves more than
``shard_window`` positions from its place in the shard-ordered stream.
Randomness stays good enough for SGD while any run of W consecutive
samples draws from at most ~(W + shard_window) consecutive positions of
the shard-ordered stream — i.e. a handful of shards — so the prefetcher's
local cache actually hits.  The
order is still a pure function of (seed, epoch, shard_sizes, shard_window),
so ``state_dict``/``load_state_dict`` resume stays exactly checkpointable.

Multi-rank caveat: each rank takes its strided ``rank::world`` slice AFTER
the window shuffle (that is what keeps the cross-rank partition exact), so
a run of W per-rank samples spans ~``W * world`` stream positions — the
per-rank locality window is effectively ``shard_window / world``.  Large
``world`` deployments should scale ``shard_window`` (and/or the cache byte
budget) by ``world`` to keep per-rank cache hit rates.
"""

from __future__ import annotations

import threading
from typing import Iterator, Sequence

import numpy as np


def _window_shuffle(idx: np.ndarray, window: int, rng: np.random.Generator) -> np.ndarray:
    """Bounded-displacement local shuffle: two vectorized passes of
    within-block permutations (block ``b = window // 2``; the second pass
    offset by ``b // 2`` so elements cross block boundaries).  Every element
    ends within ``window`` positions of where it started — the property the
    shard cache relies on — while staying O(n) *vectorized* (a streaming
    shuffle-buffer has the same guarantee but is an inherently sequential
    Python loop: seconds per epoch at the million-sample scale shards are
    for).  Deterministic given ``rng``."""
    n = len(idx)
    if window <= 1 or n <= 2:
        return idx
    b = max(2, min(window, n) // 2)
    out = idx.copy()
    for offset in (0, b // 2):
        core = out[offset:]
        m = len(core) - (len(core) % b)
        if m:
            core[:m] = rng.permuted(core[:m].reshape(-1, b), axis=1).reshape(-1)
        if len(core) > m:
            core[m:] = rng.permutation(core[m:])
    return out


class CheckpointableSampler:
    def __init__(
        self,
        n: int,
        *,
        batch_size: int,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        shuffle: bool = True,
        drop_last: bool = True,
        shard_sizes: Sequence[int] | None = None,
        shard_window: int = 2048,
    ):
        assert 0 <= rank < world
        if shard_sizes is not None:
            shard_sizes = [int(s) for s in shard_sizes]
            if sum(shard_sizes) != n:
                raise ValueError(
                    f"shard_sizes sum to {sum(shard_sizes)}, dataset has {n} samples"
                )
            if shard_window < 1:
                raise ValueError("shard_window must be >= 1")
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.rank = rank
        self.world = world
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.shard_sizes = shard_sizes
        self.shard_window = shard_window
        self.epoch = 0
        self.cursor = 0  # batches yielded within the current epoch (this rank)
        self._lock = threading.Lock()

    # -- iteration -----------------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self.shard_sizes and self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            starts = np.concatenate(([0], np.cumsum(self.shard_sizes)))
            shard_order = rng.permutation(len(self.shard_sizes))
            idx = np.concatenate(
                [
                    np.arange(starts[s], starts[s + 1], dtype=np.int64)
                    for s in shard_order
                ]
            )
            idx = _window_shuffle(idx, self.shard_window, rng)
            return idx[self.rank :: self.world]
        idx = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            rng.shuffle(idx)
        return idx[self.rank :: self.world]

    def batches_per_epoch(self) -> int:
        local = (self.n + self.world - 1 - self.rank) // self.world
        if self.drop_last:
            return local // self.batch_size
        return -(-local // self.batch_size)

    def __iter__(self) -> Iterator[list[int]]:
        """Infinite stream of index batches, resuming from (epoch, cursor)."""
        while True:
            with self._lock:
                epoch, start = self.epoch, self.cursor
            order = self._epoch_order(epoch)
            nb = self.batches_per_epoch()
            for bi in range(start, nb):
                batch = order[bi * self.batch_size : (bi + 1) * self.batch_size]
                # advance BEFORE yielding: the cursor means "batches handed
                # out"; a checkpoint taken mid-prefetch skips at most the
                # sink-buffered batches (bounded, documented in DESIGN §7)
                with self._lock:
                    self.cursor = bi + 1
                yield batch.tolist()
            with self._lock:
                self.epoch = epoch + 1
                self.cursor = 0

    # -- checkpointing --------------------------------------------------------
    def state_dict(self) -> dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "cursor": self.cursor,
                "seed": self.seed,
                "rank": self.rank,
                "world": self.world,
                "n": self.n,
                "batch_size": self.batch_size,
                "shard_sizes": self.shard_sizes,
                "shard_window": self.shard_window,
            }

    def load_state_dict(self, state: dict) -> None:
        assert state["n"] == self.n and state["batch_size"] == self.batch_size, (
            "sampler checkpoint does not match dataset/batch configuration"
        )
        # The epoch order is a pure function of (seed, epoch, shard_sizes,
        # shard_window): a MID-EPOCH cursor only means anything under the
        # order it was counted in, so resuming it under a different layout
        # (repacked dataset, changed window, or a pre-shard checkpoint with
        # no shard keys at all) would silently repeat some samples and skip
        # others — fail loudly instead.  A cursor of 0 consumed nothing of
        # the epoch, so any layout may resume there.
        saved_sizes = state.get("shard_sizes")  # None for pre-shard ckpts too
        layout_matches = saved_sizes == self.shard_sizes and (
            saved_sizes is None or state.get("shard_window") == self.shard_window
        )
        assert layout_matches or state["cursor"] == 0, (
            "sampler checkpoint was taken mid-epoch under a different shard "
            f"configuration (saved shard_sizes/window {saved_sizes}/"
            f"{state.get('shard_window')}, sampler has "
            f"{self.shard_sizes}/{self.shard_window}) — repacking the "
            "dataset or changing shard_window invalidates mid-epoch resume"
        )
        with self._lock:
            self.epoch = state["epoch"]
            self.cursor = state["cursor"]
            self.seed = state["seed"]
