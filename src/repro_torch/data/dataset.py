"""Datasets: on-disk encoded-sample stores + synthetic generators.

An ``ArrayDataset`` is a directory of ``<i>.rpr`` files (codec.py format)
plus an ``index.txt`` of relative paths — the moral equivalent of an
ImageNet directory tree.  Synthetic variants materialize deterministic
random contents so benchmarks are reproducible without real datasets.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .codec import decode_sample, encode_sample


class ArrayDataset:
    """Map-style dataset over encoded array files."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)
        index = self.root / "index.txt"
        if not index.is_file():
            raise FileNotFoundError(
                f"not an ArrayDataset directory: {self.root} has no index.txt"
            )
        self.paths = [
            self.root / line
            for line in (ln.strip() for ln in index.read_text().splitlines())
            if line
        ]

    def __len__(self) -> int:
        return len(self.paths)

    def read_bytes(self, i: int) -> bytes:
        return self.paths[i].read_bytes()

    def __getitem__(self, i: int) -> np.ndarray:
        return decode_sample(self.read_bytes(i))


class SyntheticImageDataset(ArrayDataset):
    """Random uint8 "images" (H, W, 3), zstd-encoded on disk."""

    @staticmethod
    def materialize(
        root: str | pathlib.Path,
        n: int,
        hw: tuple[int, int] = (256, 256),
        seed: int = 0,
        corrupt_every: int = 0,
    ) -> "SyntheticImageDataset":
        root = pathlib.Path(root)
        root.mkdir(parents=True, exist_ok=True)
        rng = np.random.default_rng(seed)
        names = []
        for i in range(n):
            img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            data = encode_sample(img)
            if corrupt_every and i % corrupt_every == corrupt_every - 1:
                data = b"XXXX" + data[4:]  # malformed sample (robustness tests)
            name = f"{i:06d}.rpr"
            (root / name).write_bytes(data)
            names.append(name)
        (root / "index.txt").write_text("\n".join(names))
        return SyntheticImageDataset(root)


class SyntheticTokenDataset:
    """Deterministic random token documents (variable length) — in memory,
    generated per index so 'reading' has a real decode cost profile."""

    def __init__(self, n_docs: int, vocab: int, min_len: int = 64, max_len: int = 2048, seed: int = 0):
        self.n_docs = n_docs
        self.vocab = vocab
        self.min_len = min_len
        self.max_len = max_len
        self.seed = seed
        # pre-encode a small pool of compressed docs; index i -> pool entry
        rng = np.random.default_rng(seed)
        self._pool = []
        for _ in range(min(64, n_docs)):
            ln = int(rng.integers(min_len, max_len + 1))
            doc = rng.integers(0, vocab, (ln,), dtype=np.int32)
            self._pool.append(encode_sample(doc))

    def __len__(self) -> int:
        return self.n_docs

    def _pool_index(self, i: int) -> int:
        """Deterministic (seed, i) -> pool slot via a splitmix64-style mix:
        distinct indices beyond the pool size no longer alias the same bytes
        in lockstep (``i % pool``), and two datasets that differ only in
        ``seed`` disagree on which doc index ``i`` serves — keeping
        benchmark access patterns honest."""
        h = (i + 1 + self.seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return (h ^ (h >> 31)) % len(self._pool)

    def read_bytes(self, i: int) -> bytes:
        return self._pool[self._pool_index(i)]

    def __getitem__(self, i: int) -> np.ndarray:
        return decode_sample(self.read_bytes(i))
