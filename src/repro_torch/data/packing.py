"""Sequence packing: pack variable-length docs into fixed (seq_len,) rows.

Emits the packed tokens + next-token labels + positions (restarting per
document) + segment ids (for the block-diagonal causal mask the attention
layers honor via ``segment_ids``) — no cross-document attention leakage,
no padding waste beyond row tails.

Two emission paths share one walk (``_emit_into``):

``add(doc)``                 — classic: returns freshly allocated row dicts;
``add_into(doc, next_slot)`` — zero-copy: writes each completed row straight
                               into an arena slab slot (``SlotRef.views()``)
                               and returns the slot tickets.  The packer
                               keeps one reusable (seq_len+1,) scratch per
                               field, so steady-state packing allocates
                               nothing per row.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np


class SequencePacker:
    def __init__(self, seq_len: int, pad_id: int = 0):
        self.seq_len = seq_len
        self.pad_id = pad_id
        self._buf: list[np.ndarray] = []
        self._buf_len = 0
        # reusable scratch: one extra token for the label shift
        n = seq_len + 1
        self._toks = np.empty(n, np.int32)
        self._segs = np.empty(n, np.int32)
        self._pos = np.empty(n, np.int32)
        self._arange = np.arange(n, dtype=np.int32)
        self._same = np.empty(seq_len, bool)

    def add(self, doc: np.ndarray) -> list[dict]:
        """Feed one document; returns zero or more completed rows."""
        out = []
        self._push(doc)
        while self._buf_len >= self.seq_len + 1:  # +1 for the label shift
            row = {
                "tokens": np.empty(self.seq_len, np.int32),
                "labels": np.empty(self.seq_len, np.int32),
                "positions": np.empty(self.seq_len, np.int32),
                "segment_ids": np.empty(self.seq_len, np.int32),
            }
            self._emit_into(row)
            out.append(row)
        return out

    def add_into(self, doc: np.ndarray, next_slot: Callable[[], Any]) -> list:
        """Feed one document, writing completed rows into slab slots.

        ``next_slot()`` must return a ticket exposing ``views()`` (e.g.
        ``repro.data.arena.SlotRef``); the completed tickets are returned in
        emission order.
        """
        out = []
        self._push(doc)
        while self._buf_len >= self.seq_len + 1:
            ref = next_slot()
            self._emit_into(ref.views())
            out.append(ref)
        return out

    # ------------------------------------------------------------------
    def _push(self, doc: np.ndarray) -> None:
        self._buf.append(doc.astype(np.int32))
        self._buf_len += len(doc)

    def _emit_into(self, out: Mapping[str, np.ndarray]) -> None:
        """Fill one packed row into ``out``'s (seq_len,) arrays in place."""
        L = self.seq_len
        toks, segs, pos = self._toks, self._segs, self._pos
        write = 0
        seg = 0
        while write < L + 1:
            head = self._buf[0]
            use = min(len(head), L + 1 - write)
            toks[write : write + use] = head[:use]
            segs[write : write + use] = seg
            pos[write : write + use] = self._arange[:use]
            if use == len(head):
                self._buf.pop(0)
                self._buf_len -= use
                seg += 1
            else:
                # keep the remainder; overlap 1 token so labels stay aligned
                self._buf[0] = head[use - 1 :]
                self._buf_len -= use - 1
            write += use
        out["tokens"][:] = toks[:L]
        out["labels"][:] = toks[1 : L + 1]
        # mask labels that cross a segment boundary (next token is a new doc)
        np.equal(segs[1 : L + 1], segs[:L], out=self._same)
        np.logical_not(self._same, out=self._same)
        out["labels"][self._same] = -1
        out["positions"][:] = pos[:L]
        out["segment_ids"][:] = segs[:L]


def collate(rows: list[dict]) -> dict:
    """Stack rows into a batch, writing into one contiguous allocation per
    key (the paper's §2.1 batching rule: allocate once, copy once)."""
    out = {}
    for key in rows[0]:
        first = np.asarray(rows[0][key])
        batch = np.empty((len(rows), *first.shape), first.dtype)
        for i, r in enumerate(rows):
            batch[i] = r[key]
        out[key] = batch
    return out
