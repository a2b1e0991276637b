"""Bounded, instrumented inter-stage queues (paper §5.5.3).

Stages communicate exclusively through bounded ``asyncio.Queue``s.  A full
output queue blocks the producing task, so congestion propagates from the
sink (the training loop) upstream to the source, and resolves from the sink
downward as soon as the consumer drains one item — the paper's backpressure
mechanism.  The wrapper records how long producers/consumers were blocked;
those two numbers are the core of the visibility story.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from .stats import StageStats
from .trace import NULL_TRACER


class _Sentinel:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{self.name}>"


#: End-of-stream marker.  Exactly one EOF traverses each queue, placed by a
#: stage after all of its in-flight tasks completed.
EOF = _Sentinel("EOF")


class MonitoredQueue:
    """A bounded asyncio.Queue that attributes blocking time to stages.

    ``put`` blocking is charged to the *producer* stage (backpressure);
    ``get`` blocking is charged to the *consumer* stage (starvation).

    Blocking waits are also recorded as tracer spans (category ``queue``,
    track = the scheduler thread) — only the blocking branch pays; the
    non-blocking fast path stays untouched and the clock readings are the
    ones the wait counters already took.
    """

    def __init__(self, maxsize: int, name: str = "q", tracer=None):
        self._q: asyncio.Queue[Any] = asyncio.Queue(maxsize)
        self.name = name
        self.producer_stats: StageStats | None = None
        self.consumer_stats: StageStats | None = None
        self.tracer = tracer if tracer is not None else NULL_TRACER

    # ------------------------------------------------------------------
    async def put(self, item: Any) -> None:
        if self._q.full():
            t0 = time.monotonic()
            await self._q.put(item)
            dt = time.monotonic() - t0
            if self.producer_stats is not None:
                self.producer_stats.put_wait += dt
            if self.tracer.enabled:
                self.tracer.complete(f"put_wait {self.name}", "queue", t0, dt)
        else:
            self._q.put_nowait(item)

    async def get(self) -> Any:
        if self._q.empty():
            t0 = time.monotonic()
            item = await self._q.get()
            dt = time.monotonic() - t0
            if self.consumer_stats is not None:
                self.consumer_stats.get_wait += dt
            if self.tracer.enabled:
                self.tracer.complete(f"get_wait {self.name}", "queue", t0, dt)
        else:
            item = self._q.get_nowait()
        if self.consumer_stats is not None and item is not EOF:
            self.consumer_stats.num_in += 1
        return item

    async def get_many(self, max_items: int) -> list[Any]:
        """Pull up to ``max_items`` items in ONE event-loop hop.

        This is the chunked-execution primitive — chunked pipe stages,
        aggregate stages, and the consumer-side sink drain
        (``Pipeline.get_items``) all pull through it: blocking (and the
        get_wait charge) happens only for the *first* item; everything
        already buffered is drained without touching the loop again, so the
        per-item hop cost is amortized over the chunk.  A chunk is never
        awaited full: whatever is available now is returned (latency over
        batching).  ``EOF`` is only ever the LAST element of the returned
        list — nothing follows it on the wire, and nothing is consumed
        past it.  Cancellation while awaiting the first item strands
        nothing: the sweep phase never awaits, so a cancelled ``get_many``
        has consumed either zero items or the list it returns.
        """
        if self._q.empty():
            t0 = time.monotonic()
            item = await self._q.get()
            dt = time.monotonic() - t0
            if self.consumer_stats is not None:
                self.consumer_stats.get_wait += dt
            if self.tracer.enabled:
                self.tracer.complete(f"get_wait {self.name}", "queue", t0, dt)
        else:
            item = self._q.get_nowait()
        out = [item]
        while item is not EOF and len(out) < max_items and not self._q.empty():
            item = self._q.get_nowait()
            out.append(item)
        if self.consumer_stats is not None:
            n = len(out) - (1 if out[-1] is EOF else 0)
            self.consumer_stats.num_in += n
        return out

    async def put_many(self, items: list[Any]) -> None:
        """Put a chunk of items, awaiting only while the queue is full.

        The fast path is pure ``put_nowait`` — zero awaits for a chunk that
        fits, versus one loop hop per item on the scalar path.  Blocking on
        a full queue is still per-item (that is the backpressure working,
        and it is charged to the producer as ``put_wait``).
        """
        for item in items:
            if self._q.full():
                t0 = time.monotonic()
                await self._q.put(item)
                dt = time.monotonic() - t0
                if self.producer_stats is not None:
                    self.producer_stats.put_wait += dt
                if self.tracer.enabled:
                    self.tracer.complete(f"put_wait {self.name}", "queue", t0, dt)
            else:
                self._q.put_nowait(item)

    # non-blocking helpers used by the pipeline runner -------------------
    def put_nowait_force(self, item: Any) -> None:
        """Best-effort put that never blocks (used to flush EOF on failure)."""
        try:
            self._q.put_nowait(item)
        except asyncio.QueueFull:
            # Drop one item to make room for the sentinel; the pipeline is
            # tearing down anyway.
            try:
                self._q.get_nowait()
            except asyncio.QueueEmpty:  # pragma: no cover - race safety
                pass
            self._q.put_nowait(item)

    def qsize(self) -> int:
        return self._q.qsize()

    @property
    def maxsize(self) -> int:
        return self._q.maxsize
