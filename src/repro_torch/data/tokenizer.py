"""Byte-level tokenizer (vectorized numpy, releases the GIL on bulk ops)."""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """ids = byte + n_special; specials: 0=pad, 1=bos, 2=eos."""

    PAD, BOS, EOS = 0, 1, 2
    N_SPECIAL = 3

    def __init__(self, vocab_size: int | None = None):
        self.vocab_size = vocab_size or (256 + self.N_SPECIAL)

    def encode(self, text: str | bytes, *, add_bos: bool = True, add_eos: bool = True) -> np.ndarray:
        raw = text.encode() if isinstance(text, str) else text
        body = np.frombuffer(raw, dtype=np.uint8).astype(np.int32) + self.N_SPECIAL
        parts = []
        if add_bos:
            parts.append(np.array([self.BOS], np.int32))
        parts.append(body)
        if add_eos:
            parts.append(np.array([self.EOS], np.int32))
        out = np.concatenate(parts)
        return np.minimum(out, self.vocab_size - 1)

    def decode(self, ids: np.ndarray) -> bytes:
        ids = np.asarray(ids)
        body = ids[(ids >= self.N_SPECIAL)] - self.N_SPECIAL
        return body.astype(np.uint8).tobytes()
