"""Pipeline: the user-facing object (paper §5.5, Listing 1).

Running an asyncio event loop is itself blocking, so it cannot live on the
main thread; a dedicated *scheduler thread* runs the loop (paper §5.5.2) and
the loop dispatches stage work to the worker thread pool.  The main thread
only ever touches the sink queue — GIL competition is confined to the main
thread and the scheduler thread, which is the paper's central scaling trick.

The sink hop itself is chunk-pullable: ``get_items(n)`` drains up to ``n``
already-buffered items in one cross-thread round trip (the consumer-side
mirror of the engine's ``pipe(..., chunk=N)``), while ``get_item`` stays the
per-item path.  Both share one timeout-resume stash, so a polling consumer
can mix them freely without losing items or the EOF.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import logging
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

from ._compat import BaseExceptionGroup, TaskGroup
from .engine import StageRuntime, StageSpec, StragglerPool
from .errors import PipelineFailure, PipelineStopped
from .queues import EOF, MonitoredQueue
from .stats import StageStatsSnapshot, format_stats
from .trace import NULL_TRACER

logger = logging.getLogger("repro.core")


class Pipeline:
    """A built, runnable data pipeline.

    Iterate it from the consumer thread::

        with pipeline.auto_stop():
            for batch in pipeline:
                ...

    The pipeline starts lazily on first iteration (or explicitly via
    ``start()``).  ``stop()`` cancels all stages, joins the scheduler thread
    and shuts down the default thread pool.
    """

    def __init__(
        self,
        specs: list[StageSpec],
        num_threads: int,
        sink_buffer_size: int,
        straggler_workers: int = 8,
        tracer=None,
    ):
        self._specs = specs
        self._num_threads = num_threads
        self._sink_buffer_size = sink_buffer_size
        self._straggler_workers = straggler_workers
        self._straggler_pool: StragglerPool | None = None
        # engine + queue spans go to this tracer (NULL_TRACER = off: one
        # attribute check per site); wire via ``build(trace=...)``
        self.tracer = tracer if tracer is not None else NULL_TRACER

        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._executor: ThreadPoolExecutor | None = None
        self._root_fut: concurrent.futures.Future | None = None
        self._root_task: asyncio.Task | None = None
        self._runtimes: list[StageRuntime] = []
        self._sink_q: MonitoredQueue | None = None
        # A get_item/get_items(timeout=...) that times out leaves its sink
        # getter running on the loop; it is kept here so the next call —
        # EITHER entry point — resumes it instead of scheduling a second
        # getter (which would leak sink items).  The getter resolves to a
        # chunk (list) of items; anything the resuming call doesn't want
        # right now waits in ``_stash``.
        self._pending_anext: concurrent.futures.Future | None = None
        # Consumer-side item stash: already-drained sink items not yet
        # handed out (a resumed chunk getter can return more than the
        # current call asked for).  Consumer-thread-only, like get_item.
        self._stash: deque[Any] = deque()
        # True once EOF has been drained from the sink: every later call
        # (after the stash empties) raises StopIteration instead of
        # scheduling a getter that would block forever.
        self._sink_eof = False
        # chunked sink drains completed (a get_items call that returned
        # items counts one chunk) — surfaced on the sink stage's stats row
        self._sink_drained_chunks = 0
        self._started = False
        self._stopped = False
        self._loop_ready = threading.Event()
        # Set by _root once the sink queue is installed (or by the root
        # future's done-callback if setup fails) — consumers block on this
        # instead of busy-polling.
        self._sink_ready = threading.Event()
        self._stop_callbacks: list[Any] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Pipeline":
        if self._started:
            return self
        if self._stopped:
            raise PipelineStopped("pipeline already stopped")
        self._started = True
        self._executor = ThreadPoolExecutor(
            max_workers=self._num_threads, thread_name_prefix="repro-worker"
        )
        if any(s.straggler_after is not None for s in self._specs):
            # one shared slow lane per pipeline: detached items from every
            # straggler stage compete for the same bounded worker set
            self._straggler_pool = StragglerPool(self._straggler_workers)
        self._thread = threading.Thread(
            target=self._thread_main, daemon=True, name="repro-scheduler"
        )
        self._thread.start()
        self._loop_ready.wait()
        assert self._loop is not None
        self._root_fut = asyncio.run_coroutine_threadsafe(self._root(), self._loop)
        # If the root coroutine dies before installing the sink queue, wake
        # any consumer blocked in get_item so it can surface the error.
        self._root_fut.add_done_callback(lambda _f: self._sink_ready.set())
        return self

    def _thread_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._loop_ready.set()
        try:
            loop.run_forever()
        finally:
            # Cancel anything still pending, then close.
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            loop.close()

    async def _root(self) -> None:
        """Wire queues to stages and run them all under one TaskGroup."""
        self._root_task = asyncio.current_task()
        assert self._executor is not None
        queues: list[MonitoredQueue] = []
        runtimes: list[StageRuntime] = []
        in_q: MonitoredQueue | None = None
        for i, spec in enumerate(self._specs):
            size = self._sink_buffer_size if i == len(self._specs) - 1 else spec.queue_size
            if i + 1 < len(self._specs):
                # a chunk-pulling consumer (chunked pipe, aggregate) can only
                # fill its chunks from what this queue holds — widen the
                # bound to the consumer's chunk so amortization actually
                # happens (items are small: indices, refs, views)
                size = max(size, self._specs[i + 1].input_chunk)
            out_q = MonitoredQueue(
                max(1, size), name=f"q:{spec.name}", tracer=self.tracer
            )
            queues.append(out_q)
            runtimes.append(
                StageRuntime(
                    spec, in_q, out_q, self._executor,
                    straggler_pool=self._straggler_pool,
                    tracer=self.tracer,
                )
            )
            in_q = out_q
        self._runtimes = runtimes
        self._sink_q = queues[-1]
        self._sink_ready.set()
        async with TaskGroup() as tg:
            for rt in runtimes:
                tg.create_task(rt.run(), name=f"stage:{rt.spec.name}")

    def add_stop_callback(self, fn) -> None:
        """Register a callable invoked first thing in ``stop()`` — e.g. a
        ``SlabArena.close`` so executor threads blocked on ``acquire`` are
        woken before the executor is shut down."""
        self._stop_callbacks.append(fn)

    def stop(self) -> None:
        """Cancel all stages and release every resource. Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        for cb in self._stop_callbacks:
            with contextlib.suppress(Exception):
                cb()
        if not self._started:
            return
        assert self._loop is not None
        if self._root_fut is not None and not self._root_fut.done():

            def _cancel() -> None:
                if self._root_task is not None:
                    self._root_task.cancel()

            self._loop.call_soon_threadsafe(_cancel)
            with contextlib.suppress(BaseException):
                self._root_fut.result(timeout=30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
        if self._straggler_pool is not None:
            self._straggler_pool.shutdown()

    @contextlib.contextmanager
    def auto_stop(self) -> Iterator["Pipeline"]:
        """Context manager that guarantees background threads are torn down
        (paper §5.9.1: non-daemonic threads must not outlive the program)."""
        try:
            yield self.start()
        finally:
            self.stop()

    # -- consumption --------------------------------------------------------
    async def _anext_many(self, n: int) -> list[Any]:
        """Runs on the loop: drain up to ``n`` sink items in one hop, or
        raise if the pipeline died.  ``MonitoredQueue.get_many`` blocks only
        for the first item and sweeps whatever else is buffered, so this is
        the chunked counterpart of the old per-item ``_anext`` — one
        cross-thread round trip per CHUNK instead of per item.  EOF, when
        present, is always the last element of the returned list."""
        assert self._sink_q is not None and self._root_task is not None
        get_t = asyncio.ensure_future(self._sink_q.get_many(n))
        done, _ = await asyncio.wait(
            {get_t, self._root_task}, return_when=asyncio.FIRST_COMPLETED
        )
        if get_t in done:
            items = get_t.result()
            if items and items[-1] is EOF:
                # Close the EOF-vs-error race: surface fail-fast errors.
                await asyncio.wait({self._root_task})
                self._reraise_root()
            return items
        # get_many awaits only its FIRST item; cancellation here cannot
        # strand partially-drained items (the sweep phase never awaits).
        get_t.cancel()
        self._reraise_root()
        # Root finished cleanly: the EOF is guaranteed to be in the sink.
        return await self._sink_q.get_many(n)

    @staticmethod
    def _unwrap(exc: BaseException) -> BaseException:
        """Dig the most informative leaf out of (nested) ExceptionGroups:
        prefer PipelineFailure, then any non-cancel leaf, then anything."""

        def leaves(e: BaseException):
            if isinstance(e, BaseExceptionGroup):
                for sub in e.exceptions:
                    yield from leaves(sub)
            else:
                yield e

        all_leaves = list(leaves(exc))
        for leaf in all_leaves:
            if isinstance(leaf, PipelineFailure):
                return leaf
        for leaf in all_leaves:
            if not isinstance(leaf, asyncio.CancelledError):
                return leaf
        return all_leaves[0] if all_leaves else exc

    def _reraise_root(self) -> None:
        assert self._root_task is not None
        if not self._root_task.done() or self._root_task.cancelled():
            return
        exc = self._root_task.exception()
        if exc is None:
            return
        raise self._unwrap(exc)

    def _ensure_consumable(self) -> None:
        """Start lazily, surface stop/setup errors, wait for the sink."""
        if not self._started:
            self.start()
        if self._stopped:
            raise PipelineStopped("pipeline stopped")
        assert self._loop is not None
        # The root task is created via run_coroutine_threadsafe; block until
        # it has installed the sink queue (no busy-polling: _root sets the
        # event, and the root future's done-callback sets it on early death).
        self._sink_ready.wait()
        if self._sink_q is None or self._root_task is None:
            assert self._root_fut is not None
            self._root_fut.result()  # surfaces setup errors
            raise PipelineStopped("pipeline root exited before sink install")

    def _refill_stash(self, n: int, timeout: float | None) -> None:
        """Drain the next chunk (≤ ``n`` items) from the sink into
        ``_stash``, resuming a pending getter left by a timed-out call.

        Both ``get_item`` and ``get_items`` funnel through here, so they
        SHARE the ``_pending_anext`` stash: a timeout-polling consumer can
        mix the two freely and never lose an item or the EOF.  A resumed
        getter may return more (or fewer) items than ``n`` — the excess
        waits in ``_stash`` for the next call.  Raises ``StopIteration``
        only with the stash empty and EOF drained.
        """
        if self._stash:
            return
        if self._sink_eof:
            raise StopIteration
        fut = self._pending_anext
        if fut is None:
            assert self._loop is not None
            fut = asyncio.run_coroutine_threadsafe(
                self._anext_many(n), self._loop
            )
        try:
            items = fut.result(timeout)
        except BaseException:
            # On a wait timeout the getter coroutine is still running and
            # WILL consume the next sink chunk — keep the future so the next
            # call collects that chunk instead of scheduling a second getter
            # (which would leak sink items per timed-out call).  A future
            # that is already done raised from inside the pipeline: drop it.
            self._pending_anext = fut if not fut.done() else None
            raise
        self._pending_anext = None
        if items and items[-1] is EOF:
            self._sink_eof = True
            items = items[:-1]
        self._stash.extend(items)
        if not self._stash:
            raise StopIteration  # EOF was the whole chunk

    def get_item(self, timeout: float | None = None) -> Any:
        """Fetch one item from the sink (blocking the consumer thread).

        Raises ``StopIteration`` on EOF, ``PipelineFailure`` on fail-fast
        errors, ``concurrent.futures.TimeoutError`` on timeout.  A timed-out
        call does NOT abandon its sink getter: the getter keeps running on
        the loop and the next ``get_item`` (or ``get_items``) resumes
        waiting on it, so polling with a timeout (e.g.
        ``HealthMonitor.guard``) never drops an item or the EOF.
        """
        self._ensure_consumable()
        self._refill_stash(1, timeout)
        return self._stash.popleft()

    def get_items(self, n: int, timeout: float | None = None) -> list[Any]:
        """Drain up to ``n`` sink items in ONE cross-thread round trip.

        The chunked consumer pull: blocks only until the FIRST item is
        available (latency over batching — a partial chunk is returned
        immediately, never awaited full), then sweeps whatever else the
        sink already buffered, up to ``n``.  Returns a non-empty list of
        1..n items; raises like ``get_item`` (``StopIteration`` once,
        after the final partial chunk, when the stream is exhausted).

        Shares the timeout-resume stash with ``get_item``: mixing the two
        under a polling consumer is lossless, and EOF is surfaced exactly
        once.  Items retain sink order across calls.
        """
        if n < 1:
            raise ValueError(f"get_items needs n >= 1, got {n}")
        self._ensure_consumable()
        self._refill_stash(n, timeout)
        take = min(n, len(self._stash))
        out = [self._stash.popleft() for _ in range(take)]
        self._sink_drained_chunks += 1
        return out

    def __iter__(self) -> Iterator[Any]:
        if not self._started:
            self.start()
        while True:
            try:
                yield self.get_item()
            except StopIteration:
                return

    # -- visibility ----------------------------------------------------------
    def stats(self) -> list[StageStatsSnapshot]:
        # one row per ORIGINAL stage: a fused runtime contributes a row per
        # phase (timings recorded inside the worker), so fusion is invisible
        # to dashboards except for the vanished queue waits
        snaps = [st.snapshot() for rt in self._runtimes for st in rt.phase_stats]
        if snaps and self._sink_drained_chunks:
            # the chunked sink drain has no stage of its own — its counter
            # rides the terminal stage's row (the one feeding the sink)
            snaps[-1] = dataclasses.replace(
                snaps[-1], sink_drained_chunks=self._sink_drained_chunks
            )
        return snaps

    def format_stats(self) -> str:
        return format_stats(self.stats())

    def queue_depths(self) -> dict[str, tuple[int, int]]:
        """{queue_name: (qsize, maxsize)} — instantaneous congestion map."""
        out: dict[str, tuple[int, int]] = {}
        for rt in self._runtimes:
            out[rt.out_q.name] = (rt.out_q.qsize(), rt.out_q.maxsize)
        return out

    @property
    def finished(self) -> bool:
        """True once the root task has completed — every stage emitted its
        EOF (or the pipeline failed).  The health monitor uses this to tell
        "quiescent because done" from "quiescent because stalled"."""
        return self._root_fut is not None and self._root_fut.done()

    @property
    def sink_occupancy(self) -> float:
        """Fraction of the sink buffer currently filled.

        ~1.0 means the loader is ahead of the consumer (healthy); ~0.0 under
        a consuming trainer means the trainer is data-starved.  The trainer's
        straggler monitor keys off this."""
        if self._sink_q is None or self._sink_q.maxsize == 0:
            return 0.0
        return self._sink_q.qsize() / self._sink_q.maxsize
