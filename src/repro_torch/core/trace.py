"""Flight recorder: per-thread span/instant ring buffers + Perfetto export.

The stats counters (``core.stats``) answer "how much, on average"; they
cannot answer "what happened at t=3.2s when the pipeline hiccuped".  The
``Tracer`` is the timeline half of the visibility story (paper §5.4): every
instrumented subsystem — stage phases at chunk boundaries, queue waits,
straggler detach/resolve, shard fetches, hedges, circuit breakers, device
transfers, health transitions, chaos injections — appends events into a
bounded per-thread ring buffer, and the whole flight is exported as Chrome
Trace Event Format JSON, loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing`` with one track per thread.

Design constraints, in order:

1. **Disabled cost is one attribute check.**  Every call site is gated on
   ``tracer.enabled`` (instrumented objects bind their tracer once, at
   construction, defaulting to the module-level ``NULL_TRACER`` no-op);
   nothing else runs when tracing is off.  ``benchmarks/bench_trace.py``
   gates this at ≤1% on the engine passthrough workload.
2. **No new clock reads on hot paths.**  Spans at chunk boundaries and
   queue waits reuse the ``time.monotonic()`` readings the stats counters
   already paid for (``Tracer.complete`` takes ``t0``/``dur`` instead of
   reading clocks itself).
3. **No locks on the record path.**  Each thread appends to its own
   ``deque(maxlen=...)`` ring; the registry lock is taken once per thread
   (first event) and on export.  Ring bounds make a forgotten tracer a
   bounded-memory annoyance, not a leak.

Usage::

    tracer = Tracer()                      # or: with tracing() as tracer:
    set_tracer(tracer)                     # data-layer subsystems see it
    pipe = builder.build(trace=tracer)     # engine + queues see it
    ... run ...
    tracer.export("trace.json")            # open in ui.perfetto.dev
    tracer.export_jsonl("events.jsonl")    # structured log, one event/line
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "tracing",
]


class _NullSpan:
    """Reusable no-op context manager (shared singleton; no per-call alloc)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a no-op, ``enabled`` is False.

    Instrumented code holds a reference to *some* tracer at all times (this
    one by default), so the hot-path guard is a single attribute check with
    no ``is None`` branching.
    """

    __slots__ = ()
    enabled = False

    def span(self, name: str, cat: str = "", args: dict | None = None) -> _NullSpan:
        return _NULL_SPAN

    def complete(
        self, name: str, cat: str, t0: float, dur: float, args: dict | None = None
    ) -> None:
        pass

    def instant(self, name: str, cat: str = "", args: dict | None = None) -> None:
        pass

    def counter(self, name: str, values: dict) -> None:
        pass

    def events(self) -> list:
        return []

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict | None):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: object) -> bool:
        t1 = time.monotonic()
        self._tracer.complete(self._name, self._cat, self._t0, t1 - self._t0, self._args)
        return False


class Tracer:
    """Flight recorder with one bounded event ring per thread.

    Events are 6-tuples ``(ph, name, cat, ts, dur, args)`` with ``ts``/
    ``dur`` in *seconds* on the monotonic clock (converted to Chrome's
    microseconds at export).  ``ph`` follows the Chrome Trace Event Format:
    ``"X"`` complete span, ``"i"`` instant, ``"C"`` counter.
    """

    def __init__(self, capacity_per_thread: int = 65536):
        if capacity_per_thread <= 0:
            raise ValueError("capacity_per_thread must be > 0")
        self.enabled = True
        self.capacity = int(capacity_per_thread)
        self.pid = os.getpid()
        self._epoch = time.monotonic()
        self._local = threading.local()
        self._lock = threading.Lock()
        # [(tid, thread_name, ring)] — grows by one entry per thread that
        # ever records; rings persist so a finished worker's track survives
        self._buffers: list[tuple[int, str, deque]] = []

    # -- recording (hot path) -------------------------------------------
    def _ring(self) -> deque:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            ring = deque(maxlen=self.capacity)
            with self._lock:
                self._buffers.append((t.ident or 0, t.name, ring))
            self._local.ring = ring
        return ring

    def complete(
        self, name: str, cat: str, t0: float, dur: float, args: dict | None = None
    ) -> None:
        """Record a finished span from clock readings the caller already has
        (``t0`` monotonic seconds, ``dur`` seconds) — zero extra clock reads."""
        if self.enabled:
            self._ring().append(("X", name, cat, t0, dur, args))

    def instant(self, name: str, cat: str = "", args: dict | None = None) -> None:
        if self.enabled:
            self._ring().append(("i", name, cat, time.monotonic(), 0.0, args))

    def counter(self, name: str, values: dict) -> None:
        """Record a counter sample (rendered as a stacked chart in Perfetto)."""
        if self.enabled:
            self._ring().append(("C", name, "counter", time.monotonic(), 0.0, dict(values)))

    def span(self, name: str, cat: str = "", args: dict | None = None):
        """``with tracer.span("fetch", "shard"): ...`` — measures its own
        clocks; use ``complete()`` where the caller already read them."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    # -- draining ---------------------------------------------------------
    def _snapshots(self) -> list[tuple[int, str, list]]:
        with self._lock:
            buffers = list(self._buffers)
        out = []
        for tid, tname, ring in buffers:
            for _ in range(8):
                try:
                    evs = list(ring)
                    break
                except RuntimeError:  # ring mutated mid-copy by its owner
                    continue
            else:  # pragma: no cover - pathological contention
                evs = []
            out.append((tid, tname, evs))
        return out

    def events(self) -> list[dict]:
        """All recorded events as Chrome Trace Event dicts, sorted by ts."""
        epoch = self._epoch
        rows: list[dict] = []
        for tid, tname, evs in self._snapshots():
            for ph, name, cat, ts, dur, args in evs:
                ev: dict[str, Any] = {
                    "ph": ph,
                    "name": name,
                    "cat": cat or "repro",
                    "ts": (ts - epoch) * 1e6,
                    "pid": self.pid,
                    "tid": tid,
                }
                if ph == "X":
                    ev["dur"] = dur * 1e6
                elif ph == "i":
                    ev["s"] = "t"  # thread-scoped instant
                if args:
                    ev["args"] = args
                rows.append(ev)
        rows.sort(key=lambda e: e["ts"])
        return rows

    def clear(self) -> None:
        """Drop all recorded events (rings stay registered to their threads)."""
        with self._lock:
            buffers = list(self._buffers)
        for _tid, _tname, ring in buffers:
            ring.clear()  # deque.clear is atomic under the GIL

    def __len__(self) -> int:
        return sum(len(evs) for _, _, evs in self._snapshots())

    # -- export -----------------------------------------------------------
    def to_chrome(self) -> dict:
        """The trace as a Chrome Trace Event Format object: metadata events
        naming each thread track, then the data events."""
        meta: list[dict] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": self.pid,
                "tid": 0,
                "args": {"name": "repro-pipeline"},
            }
        ]
        for tid, tname, _evs in self._snapshots():
            meta.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": self.pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        return {"traceEvents": meta + self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write Chrome Trace Event JSON; open in ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=repr)
        return path

    def export_jsonl(self, path: str) -> str:
        """Structured event log: one JSON object per line (for grep/jq and
        log shippers — same events, no Chrome framing)."""
        by_tid = {tid: tname for tid, tname, _ in self._snapshots()}
        with open(path, "w") as f:
            for ev in self.events():
                row = dict(ev)
                row["thread"] = by_tid.get(ev["tid"], "")
                f.write(json.dumps(row, default=repr) + "\n")
        return path


# -- module-level active tracer (the data-layer default) -------------------
#
# Subsystems not built by PipelineBuilder (shard prefetcher, peer sources,
# device transfer, health monitor, chaos stages) resolve their tracer from
# here at call time; ``build(trace=...)`` wires the engine/queue side
# explicitly.  Install with ``set_tracer`` or the ``tracing()`` context
# manager to capture every subsystem at once.
_active: Tracer | NullTracer = NULL_TRACER


def get_tracer() -> Tracer | NullTracer:
    """The installed process-wide tracer (``NULL_TRACER`` when off)."""
    return _active


def set_tracer(tracer: Tracer | NullTracer | None) -> Tracer | NullTracer:
    """Install ``tracer`` process-wide; returns the previous one.
    ``None`` uninstalls (restores the no-op)."""
    global _active
    prev = _active
    _active = tracer if tracer is not None else NULL_TRACER
    return prev


@contextlib.contextmanager
def tracing(
    tracer: Tracer | None = None, *, capacity_per_thread: int = 65536
) -> Iterator[Tracer]:
    """Install a tracer for the duration of the block::

        with tracing() as tracer:
            run_pipeline()
        tracer.export("trace.json")
    """
    t = tracer if tracer is not None else Tracer(capacity_per_thread)
    prev = set_tracer(t)
    try:
        yield t
    finally:
        set_tracer(prev)
