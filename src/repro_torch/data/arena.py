"""Slab arena: preallocated, recycled batch buffers (zero-copy assembly).

The hot path of a loader allocates a fresh batch slab per ``collate`` call
and copies every decoded sample twice (decode output → collate copy →
``device_put`` staging).  FFCV-style preallocation removes both: the arena
owns a small ring of batch-shaped buffers ("slabs"); producers are handed
``(slab, slot)`` assignments *before* they decode, write their output
directly into the slot, and the slab — not a Python list of arrays — is
what flows downstream.  After the device transfer the slab is released and
recycled, so steady-state batch assembly performs **zero** allocations.

Ownership model (the contract every stage obeys):

1. ``SlabArena.acquire()`` hands out a free slab; it blocks when the ring
   is exhausted, which is the arena's backpressure: a stalled consumer can
   never force more than ``num_slabs`` slabs into existence.
2. A *binder* assigns ``SlotRef(slab, slot)`` tickets in source order.
   Once every slot of a slab is assigned the slab is *sealed*.
3. The producer that fills a slot and fails must call ``ref.mark_hole()``
   (and re-raise): holes are how the arena learns a row will never arrive.
4. The ``aggregate_into`` stage consumes refs.  A slab emitted downstream
   transfers its release authority to the consumer (``DeviceTransfer``
   calls ``slab.release()`` once the H2D copy of the *next* batch has been
   issued — double buffering).  A slab fully drained by compaction
   (every live row copied into another slab) is auto-released here.
5. ``close()`` wakes any blocked ``acquire`` with ``ArenaClosed`` so
   pipeline teardown can never hang an executor thread.

Host memory comes from the arena's ``alloc``: plain ``np.empty`` for a CPU
loader, ``pinned_alloc`` for a CUDA loader.  A pinned slab keeps the torch
tensor that owns its page-locked memory beside the numpy view the decode
workers write into (``Slab.tensors``); the transfer copies from that tensor,
because a fresh ``torch.from_numpy`` over an interior pointer is not
guaranteed to be seen as pinned by the caching host allocator.

Every counter is guarded by one condition variable; refs and slabs are
plain records with no locking of their own.
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque
from typing import Any, Callable, Mapping

import numpy as np
import torch

#: Key under which an emitted batch dict carries its owning slab.  The
#: terminal transfer stage pops it; user code should never see it.
SLAB_KEY = "_slab"


#: ``alloc(shape, dtype) -> (numpy array, owning torch tensor or None)``
HostAlloc = Callable[[tuple[int, ...], Any], tuple[np.ndarray, "torch.Tensor | None"]]


def numpy_alloc(shape: tuple[int, ...], dtype: Any) -> tuple[np.ndarray, None]:
    """Pageable host memory (the CPU loader's slabs)."""
    return np.empty(shape, dtype), None


def pinned_alloc(shape: tuple[int, ...], dtype: Any) -> tuple[np.ndarray, torch.Tensor]:
    """Page-locked host memory, so the host→device copy runs asynchronously."""
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    t = torch.empty(shape, dtype=tdtype, pin_memory=True)
    return t.numpy(), t


class ArenaClosed(RuntimeError):
    """Raised by ``acquire`` when the arena was closed (pipeline teardown)."""


class SlotRef:
    """A ticket for one row of one slab, handed out before the row exists."""

    __slots__ = ("slab", "slot")

    def __init__(self, slab: "Slab", slot: int):
        self.slab = slab
        self.slot = slot

    def views(self) -> dict[str, np.ndarray]:
        """Writable views of this row, one per arena field."""
        return {k: a[self.slot] for k, a in self.slab.arrays.items()}

    def mark_hole(self) -> None:
        """Declare that this row will never be filled (producer failed)."""
        self.slab.arena._mark_hole(self.slab)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SlotRef(slab={self.slab.index}, slot={self.slot})"


class Slab:
    """One preallocated batch buffer.  All counters are arena-guarded."""

    __slots__ = (
        "arena",
        "arrays",
        "tensors",
        "capacity",
        "index",
        "in_use",
        "assigned",
        "sealed",
        "holes",
        "drained",
        "emitted",
    )

    def __init__(
        self,
        arena: "SlabArena",
        arrays: dict[str, np.ndarray],
        capacity: int,
        index: int,
        tensors: dict[str, torch.Tensor] | None = None,
    ):
        self.arena = arena
        self.arrays = arrays
        self.tensors = tensors or {}  # pinned owners of ``arrays``, by field
        self.capacity = capacity
        self.index = index
        self.in_use = False
        self._reset()

    def _reset(self) -> None:
        self.assigned = 0
        self.sealed = False
        self.holes = 0
        self.drained = 0
        self.emitted = False

    # -- batch emission ----------------------------------------------------
    def as_batch(self, n: int | None = None) -> dict[str, Any]:
        """The slab as a batch dict (views for partial batches), tagged with
        ``SLAB_KEY`` so the transfer stage can release it."""
        if n is None or n == self.capacity:
            out: dict[str, Any] = dict(self.arrays)
        else:
            out = {k: a[:n] for k, a in self.arrays.items()}
        out[SLAB_KEY] = self
        return out

    # -- lifecycle (delegate to the arena's lock) --------------------------
    def mark_emitted(self) -> None:
        self.arena._mark_emitted(self)

    def consume_row(self) -> None:
        """One live row was copied out of (or dropped from) this slab."""
        self.arena._consume_row(self)

    def force_seal(self) -> None:
        self.arena._force_seal(self)

    def release(self) -> None:
        self.arena.release(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Slab(#{self.index}, cap={self.capacity}, assigned={self.assigned},"
            f" holes={self.holes}, drained={self.drained}, emitted={self.emitted})"
        )


class SlabArena:
    """A ring of ``num_slabs`` preallocated batch buffers.

    ``spec`` maps field name → (per-item shape, dtype); every slab holds one
    ``(batch_size, *shape)`` array per field, allocated exactly once at
    construction by ``alloc``.
    """

    def __init__(
        self,
        spec: Mapping[str, tuple[tuple[int, ...], Any]],
        *,
        batch_size: int,
        num_slabs: int = 4,
        alloc: HostAlloc = numpy_alloc,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if num_slabs < 2:
            raise ValueError("num_slabs must be >= 2 (double buffering needs two)")
        self.batch_size = batch_size
        self.num_slabs = num_slabs
        self.spec = dict(spec)
        self._cond = threading.Condition()
        self._closed = False
        self._free: deque[Slab] = deque()
        self._slabs: list[Slab] = []
        for i in range(num_slabs):
            arrays, tensors = {}, {}
            for k, (shape, dtype) in self.spec.items():
                arrays[k], owner = alloc((batch_size, *shape), dtype)
                if owner is not None:
                    tensors[k] = owner
            slab = Slab(self, arrays, batch_size, i, tensors)
            self._slabs.append(slab)
            self._free.append(slab)
        self.bytes_allocated = sum(
            a.nbytes for s in self._slabs for a in s.arrays.values()
        )
        self.acquires = 0  # lifetime acquire count (reuse = acquires - num_slabs)

    # -- core ring ---------------------------------------------------------
    @property
    def slabs_in_flight(self) -> int:
        with self._cond:
            return self.num_slabs - len(self._free)

    def _take_locked(self) -> Slab:
        """Check a free slab out of the ring; caller holds the lock."""
        slab = self._free.popleft()
        slab._reset()
        slab.in_use = True
        self.acquires += 1
        return slab

    def try_acquire(self) -> Slab | None:
        """Non-blocking acquire: a slab, or None if the ring is exhausted."""
        with self._cond:
            if self._closed:
                raise ArenaClosed("arena closed")
            if not self._free:
                return None
            return self._take_locked()

    def acquire(self, timeout: float | None = None) -> Slab:
        """Take a free slab, blocking (with backpressure) until one exists.

        Raises ``ArenaClosed`` if the arena is (or becomes) closed while
        waiting, and ``TimeoutError`` on timeout.
        """
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._free or self._closed, timeout=timeout
            ):
                raise TimeoutError(f"no free slab after {timeout}s")
            if self._closed:
                raise ArenaClosed("arena closed")
            return self._take_locked()

    def release(self, slab: Slab) -> None:
        with self._cond:
            self._release_locked(slab)

    def _release_locked(self, slab: Slab) -> None:
        if not slab.in_use:
            raise RuntimeError(f"double release of {slab!r}")
        slab.in_use = False
        self._free.append(slab)
        self._cond.notify_all()

    def close(self) -> None:
        """Wake all blocked ``acquire`` calls; buffers stay valid (in-flight
        batches keep working) but no new slab can be acquired."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def seal_pending(self) -> None:
        """Force-seal every in-use, still-unsealed slab (end-of-stream).

        When the final items of a stream all fail upstream, the binder has
        assigned them slots in a slab it never finished — no ref reaches
        the aggregate stage, so nothing downstream ever seals that slab and
        its hole accounting can't recycle it.  Once EOF has propagated (the
        queues preserve order, so no ref can still be in flight) sealing
        everything pending is safe and lets ``_maybe_autorelease`` reclaim
        fully-holed slabs instead of pinning them until teardown."""
        with self._cond:
            for slab in self._slabs:
                if slab.in_use and not slab.sealed:
                    slab.sealed = True
                    self._maybe_autorelease(slab)

    # -- slab accounting (all under the one lock) --------------------------
    def _maybe_autorelease(self, slab: Slab) -> None:
        """A sealed, never-emitted slab whose rows are all holes or drained
        has no owner downstream — recycle it here."""
        if (
            slab.in_use
            and slab.sealed
            and not slab.emitted
            and slab.holes + slab.drained >= slab.assigned
        ):
            self._release_locked(slab)

    def _mark_hole(self, slab: Slab) -> None:
        with self._cond:
            slab.holes += 1
            self._maybe_autorelease(slab)

    def _consume_row(self, slab: Slab) -> None:
        with self._cond:
            slab.drained += 1
            self._maybe_autorelease(slab)

    def _force_seal(self, slab: Slab) -> None:
        with self._cond:
            slab.sealed = True
            self._maybe_autorelease(slab)

    def _mark_emitted(self, slab: Slab) -> None:
        with self._cond:
            slab.emitted = True

    # -- producer-side assignment ------------------------------------------
    def _next_ref(self, state: dict[str, Any], slab: Slab | None = None) -> SlotRef:
        """Advance the (slab, slot) cursor by one; ``slab`` is the freshly
        acquired slab when the cursor had none."""
        if slab is not None:
            state["slab"], state["slot"] = slab, 0
        slab = state["slab"]
        ref = SlotRef(slab, state["slot"])
        with self._cond:
            slab.assigned += 1
        state["slot"] += 1
        if state["slot"] >= slab.capacity:
            state["slab"] = None
            slab.force_seal()
        return ref

    def slot_writer(self) -> Callable[[], SlotRef]:
        """A stateful ``next_slot()`` that walks slots in order, acquiring a
        fresh slab whenever the current one seals.  NOT thread-safe: run it
        from a single producer (a ``concurrency=1`` stage).  Blocks in
        ``acquire`` when the ring is exhausted — call it from worker threads
        (it is meant for stage functions), never from the event loop."""
        state: dict[str, Any] = {"slab": None, "slot": 0}

        def next_slot() -> SlotRef:
            slab = self.acquire() if state["slab"] is None else None
            return self._next_ref(state, slab)

        return next_slot

    #: poll period while the ring is exhausted; only paid under backpressure
    _BINDER_STALL_POLL_S = 0.002

    def binder(self) -> Callable[[Any], Any]:
        """Async pipe-stage form of ``slot_writer``: pairs each incoming item
        with its slot ticket.  Use with ``concurrency=1`` (assignment must
        follow input order).  Ticket issue runs on the event loop (cheap
        bookkeeping, no executor round-trip per item); when the ring is
        exhausted it polls with a short async sleep — the arena's
        backpressure propagating upstream without stalling the loop or
        borrowing threads the pipeline doesn't own."""
        state: dict[str, Any] = {"slab": None, "slot": 0}

        async def bind(item: Any) -> tuple[Any, SlotRef]:
            slab = None
            if state["slab"] is None:
                while (slab := self.try_acquire()) is None:
                    await asyncio.sleep(self._BINDER_STALL_POLL_S)
            return item, self._next_ref(state, slab)

        return bind

    def stats(self) -> dict[str, int]:
        with self._cond:
            return {
                "bytes_allocated": self.bytes_allocated,
                "slabs_in_flight": self.num_slabs - len(self._free),
                "num_slabs": self.num_slabs,
                "acquires": self.acquires,
            }
