"""Stage runners: the coroutines that make up a pipeline (paper §5.5).

Each stage is a coroutine scheduled on the event loop that runs on the
scheduler thread.  A stage pulls items from its input ``MonitoredQueue``,
applies its function with up to ``concurrency`` tasks in flight, and pushes
results to its output queue.  Synchronous functions are delegated to the
executor (thread pool by default, user-supplied process pool optionally) via
``loop.run_in_executor`` — this is where GIL-releasing functions actually run
concurrently.  Coroutine functions are awaited on the loop itself and never
touch the pool (paper §5.2: coroutines are not constrained by the GIL).

Chunked + fused execution (amortizing the loop out of the hot path)
-------------------------------------------------------------------
The per-item path costs ~4-5 event-loop round trips per stage (queue
get/put, ``ensure_future``, semaphore, executor dispatch); once the stage
functions themselves are cheap (mmap reads, slot binding), that loop-side
overhead IS the pipeline's ceiling — and it does not parallelize, because
every stage's bookkeeping runs on the one scheduler thread.  Two
amortizations make the per-item cost O(items/chunk):

* **chunking** (``pipe(..., chunk=N)``): the stage pulls up to N items per
  queue hop (``MonitoredQueue.get_many``), dispatches ONE executor call
  that applies the stage function to each item *inside the worker thread*,
  and pushes the surviving results back with one hop (``put_many``).
  Ordered/unordered semantics, per-item error holes (``OnError.SKIP``
  drops only the failing item of a chunk), and backpressure (``concurrency``
  bounds in-flight *chunks*; queues stay bounded) are preserved.  Per-item
  timeouts are enforced post hoc inside the worker — an item whose run
  exceeded ``timeout`` is recorded as a per-item timeout failure — plus a
  whole-chunk ``wait_for`` backstop (``timeout × len(chunk)``) against a
  permanently hung function, which takes its whole chunk with it.
  Chunking requires a sync stage function (an async fn never leaves the
  loop, so there is nothing to amortize).

* **fusion** (``PipelineBuilder.fuse("read", "decode")`` or
  ``build(auto_fuse=True)``): adjacent sync, same-executor pipe stages
  collapse into a single executor call per item/chunk — an entire queue +
  task layer disappears.  The fused runtime keeps one ``StageStats`` per
  original stage (phase timings are recorded inside the worker), so
  ``Pipeline.stats()`` still reports the fused stages as separate rows;
  each phase keeps its own ``on_error``/``timeout``, and a failure is
  attributed to the phase that raised.

The hot path ends at the device, and the same amortization now covers the
last leg.  A **vectorized chunk stage** (``pipe(fn, chunk=N,
vectorized=True)``) hands the whole drained chunk to ``fn`` as one list —
the shape ``DeviceTransfer.transfer_many`` uses to issue a chunk of
``device_put`` dispatches per executor call — and on the consumer side
``Pipeline.get_items(n)`` drains up to *n* sink batches per cross-thread
round trip (``MonitoredQueue.get_many`` through the sink).  ``get_item``
and ``get_items`` share one consumer-side stash and the same lossless
timeout-resume contract: a call that times out leaves its still-running
getter parked, the next call (either flavor) resumes it, order is
preserved, EOF surfaces exactly once.  End to end a batch costs O(1/chunk)
loop hops from slab assembly to the accelerator (see ``data/loader.py``,
"The hot path to the device").

Straggler slow lane (``pipe(..., straggler_after=...)``)
--------------------------------------------------------
Chunked execution has a failure mode of its own: one slow item holds its
whole chunk hostage (MinatoLoader's observation — once raw throughput is
high, the tail of the item-latency distribution IS the bottleneck).  A
chunked stage with a ``straggler_after`` soft deadline runs its items
item-major through a bounded side executor (the pipeline's
``StragglerPool``): each item is submitted to the pool and awaited for at
most ``straggler_after`` seconds.  An item that finishes in time behaves
exactly like the phase-major path; one that does not is *detached* — the
chunk completes and emits without it, and a ``_Detached`` marker holds its
position.  An order-preserving stage re-inserts the straggler's result at
its original position (the emitter awaits the marker; processing of later
chunks continues meanwhile, bounded by ``straggler_runahead`` extra parked
chunks); an ``output_order="completion"`` stage emits the result whenever
it lands.  A straggler that ultimately *fails* becomes a normal per-item
failure hole under ``OnError.SKIP`` (or tears the pipeline down under
``FAIL``).  When the pool is saturated the item runs inline instead (no
deadline protection — counted as ``straggler_shed``), so the slow lane can
degrade but never deadlock.  ``StageStats`` grows ``stragglers`` /
``straggler_time`` / ``straggler_shed``.

EOF protocol: exactly one ``EOF`` sentinel traverses each queue.  On the
normal path a stage *blocks* putting EOF (downstream is draining, so this
terminates).  On the exceptional path (fail-fast error or cancellation) it
*force-puts* EOF without blocking so teardown can never deadlock on a full
queue whose consumer is already dead.  ``get_many`` only ever surfaces EOF
as the last element of a chunk, so a partial tail chunk is processed
normally before the stage winds down.

Failure semantics
-----------------
What happens when a stage function misbehaves, from mildest to hardest:

* **Per-item failure, ``on_error="skip"`` (default):** the exception is
  logged, counted in that phase's ``num_failed`` row, and ONLY that item
  is dropped — its chunk-mates and the rest of the stream are untouched.
  On the zero-copy loader path the dropped item's slab slot is marked as a
  hole and compacted away downstream.
* **Per-item failure, ``on_error="fail"``:** the stage raises
  ``PipelineFailure`` naming the raising phase (``.stage``/``.phase``; for
  a fused runtime that is the original sub-stage, with the composite name
  in ``.fused_stage``) and the item's stage-stream index
  (``.item_index``), the whole pipeline cancels, and the consumer sees the
  failure on its next ``get_item``.  Stats are recorded *before* the
  raise, so the dashboard shows the failure even when it is fatal.
* **Slow item (chunked stage with ``straggler_after``):** detached to the
  straggler pool — deferred, not failed.  See "Straggler slow lane".
* **Slow item (``timeout=``):** per-item timeouts are enforced post hoc
  (a thread cannot be preempted mid-call): the item is recorded as a
  timeout failure with the same skip/fail semantics as any other failure.
* **Hung item (never returns):** the whole-chunk ``wait_for`` backstop
  (``sum(phase timeouts) × len(chunk)``, armed only when every phase has a
  timeout) abandons the chunk: every item in it is recorded as failed, the
  hung worker thread is left to die with its call (it cannot be killed),
  and the stage moves on — or tears down under ``on_error="fail"``.
* **Stalled pipeline (no backstop armed, or stuck outside a stage fn):**
  nothing in-engine can fire; this is what ``core.health.HealthMonitor``
  exists for — it watches ``Pipeline.stats()`` for progress, sheds
  optional work while DEGRADED, and raises a structured
  ``PipelineStalled`` (naming the suspect stage) instead of letting the
  consumer block forever.

Stats rows: each phase of each stage is one row.  ``num_in``/``num_out``
count items entering/leaving the phase, ``num_failed`` its dropped items,
``task_time`` seconds inside its function, ``get_wait``/``put_wait``
starvation/backpressure, ``stragglers``/``straggler_time``/
``straggler_shed`` the slow-lane counters (first phase of the stage).

Observability
-------------
Three layers, cheapest first (see ``core.trace`` / ``core.metrics``):

* **Counters** (always on): the ``StageStats`` rows above, snapshotted by
  ``Pipeline.stats()`` and rendered by ``format_stats``.  Lifetime
  averages only.
* **Time series**: ``core.metrics.StatsHistory`` rings those snapshots on
  the consumer's cadence and serves *windowed* deltas — current qps /
  occupancy / wait fractions per stage.  ``HealthMonitor`` derives its
  HEALTHY/DEGRADED/STALLED verdicts from the same history; a
  ``MetricsExporter`` serves everything as Prometheus text on
  ``/metrics``.
* **Flight recorder**: ``core.trace.Tracer`` — per-thread ring buffers of
  span/instant events, exported as Chrome Trace Event JSON.

Tracer lifecycle: construct a ``Tracer``, pass it to ``build(trace=...)``
(engine + queue spans) and/or install it process-wide with
``trace.set_tracer`` / the ``tracing()`` context manager (shard fetches,
device transfers, health, chaos — subsystems not built by the builder);
after the run, ``tracer.export("trace.json")`` and open it in
https://ui.perfetto.dev.  Overhead guarantees, gated by
``benchmarks/bench_trace.py``: disabled tracing costs one attribute check
per site (≤1% on the passthrough workload); enabled tracing reuses the
clock readings the stats counters already take at chunk boundaries (no new
``monotonic()`` calls on the hot path) and appends one tuple to a
lock-free per-thread ring (≥0.95x untraced throughput).

Reading a Perfetto trace of a chunked+fused pipeline: each worker thread
is one track; a chunked stage shows one ``stage`` span per *phase* per
chunk (a fused ``read+decode`` chunk renders as back-to-back ``read`` and
``decode`` spans covering the whole chunk, with ``items=`` in the span
args), so per-item work is visible as span length ÷ items.  The scheduler
thread's track carries the ``queue`` category: ``get_wait q:X`` spans mean
X's consumer is starved (upstream too slow), ``put_wait q:X`` means X is
full (downstream too slow) — the same backpressure story as the counters,
but time-resolved.  ``straggler`` instants mark detach/resolve pairs, and
``shard``/``transfer`` spans (cache fetches, host→device copies) come from
the data layer when a process-wide tracer is installed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import itertools
import logging
import threading
import time
from concurrent.futures import Executor, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, AsyncIterable, Callable, Iterable

from ._compat import TaskGroup
from .errors import OnError, PipelineFailure
from .queues import EOF, MonitoredQueue
from .stats import StageStats
from .trace import NULL_TRACER

logger = logging.getLogger("repro.core")


def _is_async_callable(fn: Callable) -> bool:
    if inspect.iscoroutinefunction(fn):
        return True
    call = getattr(fn, "__call__", None)  # noqa: B004 - callables/partials
    return call is not None and inspect.iscoroutinefunction(call)


class StragglerPool:
    """Bounded side executor for deadline-detached items (one per pipeline).

    ``try_submit`` reserves a worker *at submit time* and returns ``None``
    when all workers are claimed — the caller then runs the item inline
    instead.  Without the reservation, submissions would queue unboundedly
    inside the ``ThreadPoolExecutor`` while stragglers hog every worker,
    and never-started items would later be "detached" having never run —
    spurious deferrals that re-serialize the stream for nothing.
    """

    def __init__(self, max_workers: int = 8):
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        self.max_workers = max_workers
        self._ex = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="repro-straggler"
        )
        self._lock = threading.Lock()
        self._in_flight = 0

    def try_submit(self, fn: Callable, *args) -> Future | None:
        with self._lock:
            if self._in_flight >= self.max_workers:
                return None
            self._in_flight += 1
        try:
            fut = self._ex.submit(fn, *args)
        except RuntimeError:  # shutdown race: pipeline is tearing down
            with self._lock:
                self._in_flight -= 1
            return None
        fut.add_done_callback(self._release)
        return fut

    def _release(self, _fut: Future) -> None:
        with self._lock:
            self._in_flight -= 1

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def shutdown(self) -> None:
        # wait=False: a hung straggler's thread cannot be interrupted, and
        # teardown must not block on it (same contract as the chunk backstop)
        self._ex.shutdown(wait=False, cancel_futures=True)


class _Detached:
    """Positional marker for an item detached to the straggler pool: holds
    the pool future and the item's stage-stream index for provenance."""

    __slots__ = ("future", "index")

    def __init__(self, future: Future, index: int):
        self.future = future
        self.index = index


#: return marker from ``_resolve_straggler``: the straggler produced no
#: emittable value (it failed under OnError.SKIP, or timed out)
_DROPPED = object()


@dataclasses.dataclass
class StageSpec:
    """One entry built by ``PipelineBuilder``."""

    kind: str  # "source" | "pipe" | "aggregate" | "aggregate_into" | "disaggregate"
    name: str
    fn: Callable | None = None
    source: Iterable | AsyncIterable | None = None
    concurrency: int = 1
    executor: Executor | None = None  # None -> pipeline default thread pool
    output_order: str = "input"  # "input" | "completion"
    on_error: OnError = OnError.SKIP
    timeout: float | None = None
    agg_size: int = 0
    drop_last: bool = False
    queue_size: int = 2  # output queue bound (per stage)
    arena: Any = None  # SlabArena for kind == "aggregate_into" (duck-typed)
    cache: Any = None  # shard cache/prefetcher probed for stats (duck-typed)
    chunk: int = 1  # items per executor dispatch (chunked execution)
    #: the fn takes the whole chunk (a list) and returns a same-length,
    #: same-order list — lets numpy-style stages batch their own lookups.
    #: The fn owns per-item robustness: an exception it raises fails the
    #: WHOLE chunk (one failure record per item under SKIP).
    vectorized: bool = False
    #: phases of a FUSED stage (builder.fuse / auto_fuse): the original
    #: StageSpecs, applied back to back inside one executor call.  Empty for
    #: a plain stage.  A fused spec's fn is None; concurrency/chunk are the
    #: max over its phases; on_error/timeout/cache stay per phase.
    fused: tuple = ()
    #: soft per-item deadline (seconds): a chunked item exceeding it is
    #: detached to the pipeline's straggler pool so its chunk can emit
    #: without it (None = no slow lane).  Requires chunk > 1 + sync fn.
    straggler_after: float | None = None
    #: extra parked chunks the ordered emitter may run ahead while awaiting
    #: a detached straggler (0 = default of 3 × concurrency).  This bounds
    #: how much straggler latency the stage can hide: roughly
    #: (concurrency + straggler_runahead) × chunk items of cover.
    straggler_runahead: int = 0

    @property
    def phases(self) -> tuple:
        """The per-phase sub-specs this runtime executes ((self,) if plain)."""
        return self.fused or (self,)

    @property
    def input_chunk(self) -> int:
        """How many items this stage wants per queue hop from upstream —
        what the producer's output queue is auto-widened to.  Only a
        chunked pipe stage widens: ``chunk=`` is an explicit opt-in by the
        stage author, who thereby asserts the items are cheap to buffer
        chunk-deep.  Aggregate stages also drain via ``get_many`` but their
        items can be heavyweight (whole decoded samples on the list-collate
        path), so they make do with whatever the producer's ``queue_size``
        allows — raise it explicitly where the items are known-small."""
        return self.chunk if self.kind == "pipe" else 1


class StageRuntime:
    """Binds a StageSpec to queues/stats and runs it."""

    def __init__(
        self,
        spec: StageSpec,
        in_q: MonitoredQueue | None,
        out_q: MonitoredQueue,
        default_executor: Executor,
        straggler_pool: StragglerPool | None = None,
        tracer=None,
    ):
        self.spec = spec
        self.in_q = in_q
        self.out_q = out_q
        self.default_executor = default_executor
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._straggler_pool = (
            straggler_pool if spec.straggler_after is not None else None
        )
        # One StageStats per phase: a fused stage keeps reporting its
        # original stages as separate dashboard rows (per-phase timing is
        # recorded inside the worker).  A plain stage has exactly one phase.
        self.phases: tuple[StageSpec, ...] = spec.phases
        self.phase_stats = [
            StageStats(
                name=p.name,
                concurrency=spec.concurrency,
                chunk=spec.chunk,
                # autotune may only propose chunk= where pipe() accepts it
                chunkable=p.kind == "pipe" and not _is_async_callable(p.fn),
            )
            for p in self.phases
        ]
        for p, st in zip(self.phases, self.phase_stats):
            if p.arena is not None:
                st.arena = p.arena  # memory-pressure visibility
            if p.cache is not None:
                st.cache = p.cache  # shard-cache visibility
        self.stats = self.phase_stats[0]
        if in_q is not None:
            # input waits (starvation) are charged to the first phase ...
            in_q.consumer_stats = self.phase_stats[0]
        # ... output waits (backpressure) to the last.
        out_q.producer_stats = self.phase_stats[-1]

    # ------------------------------------------------------------------
    async def _call(self, item: Any) -> Any:
        """Invoke the stage function for one item (async- or executor-path)."""
        fn = self.spec.fn
        assert fn is not None
        if _is_async_callable(fn):
            coro = fn(item)
        else:
            loop = asyncio.get_running_loop()
            ex = self.spec.executor or self.default_executor
            coro = loop.run_in_executor(ex, fn, item)
        if self.spec.timeout is not None:
            return await asyncio.wait_for(coro, self.spec.timeout)
        return await coro

    async def _guarded(self, unit: tuple[int, Any]) -> tuple[bool, Any]:
        """Run one task; returns (ok, result). Raises only in fail-fast mode.
        ``unit`` is ``(stage-stream index, item)`` — the index feeds failure
        provenance (``PipelineFailure.item_index``)."""
        idx, item = unit
        t0 = time.monotonic()
        try:
            result = await self._call(item)
            dt = time.monotonic() - t0
            self.stats.record_task(dt)
            if self.tracer.enabled:
                self.tracer.complete(self.spec.name, "stage", t0, dt)
            return True, result
        except asyncio.CancelledError:
            raise
        except Exception as e:
            dt = time.monotonic() - t0
            self.stats.record_task(dt)
            if self.tracer.enabled:
                self.tracer.complete(self.spec.name, "stage", t0, dt, {"error": repr(e)})
            self.stats.record_failure(e)
            logger.warning(
                "stage %s failed on item #%d: %r", self.spec.name, idx, e
            )
            if self.spec.on_error is OnError.FAIL:
                raise PipelineFailure(self.spec.name, e, item_index=idx) from e
            return False, None

    async def _emit(self, item: Any) -> None:
        await self.out_q.put(item)
        self.phase_stats[-1].record_out()

    async def _emit_many(self, items: list[Any]) -> None:
        await self.out_q.put_many(items)
        self.phase_stats[-1].record_out_many(len(items))

    # -- chunked / fused execution ----------------------------------------
    def _apply_chunk(self, items: list[Any]) -> tuple:
        """Runs IN the worker thread: apply every phase to every item.

        This is the whole point of chunked execution — one executor
        dispatch covers ``len(items) × len(phases)`` function calls that
        the per-item path would each pay a loop round trip for.  Phases
        run phase-major (phase k over the whole chunk, then phase k+1 over
        its survivors): order within the chunk is preserved, timing costs
        two clock reads per phase per CHUNK instead of two per item, and
        the fused stages still get separate per-phase dashboard rows.
        Failures are caught per item — a bad sample must not take its
        chunk-mates with it.  Per-item clocks run only for phases with a
        ``timeout`` (post-hoc enforcement needs them).

        Returns ``(survivors, per_phase, failures)``: surviving values in
        input order, ``(n_entered, seconds)`` per phase reached, and
        ``(phase_idx, chunk_pos, exc)`` per failed item — ``chunk_pos`` is
        the failing item's position in the ORIGINAL chunk (None when a
        vectorized phase failed: attribution to one item is impossible).
        """
        per_phase: list[tuple[int, float]] = []
        failures: list[tuple[int, int | None, BaseException]] = []
        values = items
        # original-chunk position of values[j]; None = identity (no failures
        # yet), so the failure-free hot path never touches it
        positions: list[int] | None = None
        for k, phase in enumerate(self.phases):
            fn = phase.fn
            timeout = phase.timeout
            entered = len(values)
            survivors: list[Any] = []
            failed_js: list[int] = []  # this phase's failed input indices
            t0 = time.monotonic()
            if phase.vectorized:
                # one call over the whole chunk; the fn owns per-item
                # robustness, so a raise here loses every item of the chunk
                try:
                    survivors = list(fn(values))
                    if len(survivors) != entered:
                        raise ValueError(
                            f"vectorized stage {phase.name!r} returned "
                            f"{len(survivors)} items for a chunk of {entered}"
                        )
                except Exception as e:  # noqa: BLE001
                    survivors = []
                    failures.extend((k, None, e) for _ in range(entered))
                dt = time.monotonic() - t0
                if survivors and timeout is not None and dt > timeout * entered:
                    failures.extend(
                        (
                            k,
                            None,
                            asyncio.TimeoutError(
                                f"chunk exceeded {timeout}s/item in stage "
                                f"{phase.name!r} ({dt:.3f}s for {entered})"
                            ),
                        )
                        for _ in range(entered)
                    )
                    survivors = []
                per_phase.append((entered, dt))
                if self.tracer.enabled:
                    self.tracer.complete(
                        phase.name, "stage", t0, dt, {"items": entered, "vectorized": True}
                    )
                values = survivors
                if not values:
                    break
                continue
            if timeout is None:
                append = survivors.append
                for v in values:
                    try:
                        append(fn(v))
                    except Exception as e:  # noqa: BLE001 - per-item robustness
                        # input index of the failing item: every earlier
                        # item either survived or failed, so no enumerate
                        # is needed on the hot path
                        j = len(survivors) + len(failed_js)
                        failed_js.append(j)
                        failures.append(
                            (k, positions[j] if positions is not None else j, e)
                        )
            else:
                for v in values:
                    t1 = time.monotonic()
                    try:
                        out = fn(v)
                    except Exception as e:  # noqa: BLE001
                        j = len(survivors) + len(failed_js)
                        failed_js.append(j)
                        failures.append(
                            (k, positions[j] if positions is not None else j, e)
                        )
                        continue
                    dt = time.monotonic() - t1
                    if dt > timeout:
                        # post-hoc per-item timeout: the thread cannot be
                        # preempted mid-call, but the item is still dropped
                        # with the same skippable-failure semantics
                        j = len(survivors) + len(failed_js)
                        failed_js.append(j)
                        failures.append((
                            k,
                            positions[j] if positions is not None else j,
                            asyncio.TimeoutError(
                                f"item exceeded {timeout}s in stage "
                                f"{phase.name!r} ({dt:.3f}s)"
                            ),
                        ))
                    else:
                        survivors.append(out)
            phase_dt = time.monotonic() - t0
            per_phase.append((entered, phase_dt))
            if self.tracer.enabled:
                # the span reuses the two clock reads the stats already paid
                # for: one per-phase-per-chunk event, not per item
                self.tracer.complete(
                    phase.name, "stage", t0, phase_dt, {"items": entered}
                )
            if failed_js:
                # survivors' original positions, for attributing failures in
                # LATER phases back to the original chunk
                gone = set(failed_js)
                src = positions if positions is not None else range(entered)
                positions = [p for x, p in enumerate(src) if x not in gone]
            values = survivors
            if not values:
                break  # nothing left for later phases (they record 0 items)
        return values, per_phase, failures

    def _run_item(self, v: Any) -> tuple:
        """Run ALL phases over ONE item, item-major (the slow-lane unit of
        work — runs on a straggler-pool thread, or inline on the chunk
        worker when the pool is saturated).

        Returns ``(ok, value, failed_phase, exc, times, elapsed)`` where
        ``times`` is ``[(phase_idx, seconds), ...]`` for each phase reached
        — the record a chunk worker (fast item) or the loop-side straggler
        resolution (detached item) folds into stats.  Per-phase ``timeout``
        keeps its post-hoc semantics.
        """
        times: list[tuple[int, float]] = []
        t_start = time.monotonic()
        for k, phase in enumerate(self.phases):
            t0 = time.monotonic()
            try:
                out = phase.fn(v)
            except Exception as e:  # noqa: BLE001 - per-item robustness
                dt = time.monotonic() - t0
                times.append((k, dt))
                if self.tracer.enabled:
                    self.tracer.complete(
                        phase.name, "stage", t0, dt,
                        {"slowlane": True, "error": repr(e)},
                    )
                return False, None, k, e, times, time.monotonic() - t_start
            dt = time.monotonic() - t0
            times.append((k, dt))
            if self.tracer.enabled:
                self.tracer.complete(phase.name, "stage", t0, dt, {"slowlane": True})
            if phase.timeout is not None and dt > phase.timeout:
                exc = asyncio.TimeoutError(
                    f"item exceeded {phase.timeout}s in stage "
                    f"{phase.name!r} ({dt:.3f}s)"
                )
                return False, None, k, exc, times, time.monotonic() - t_start
            v = out
        return True, v, -1, None, times, time.monotonic() - t_start

    def _apply_chunk_slowlane(self, items: list[Any]) -> tuple:
        """Chunk application with the straggler slow lane (worker thread).

        Items run item-major through the pipeline's ``StragglerPool``; each
        is awaited for at most ``straggler_after`` seconds.  A fast item is
        folded exactly like the phase-major path; a slow one is detached —
        its ``_Detached`` marker keeps its position in ``entries`` and the
        chunk moves on.  Pool saturated → the item runs inline (no deadline
        protection; counted as shed).

        Returns ``(entries, per_phase, failures, (n_detached, n_shed))``
        where ``entries`` is input-ordered values interleaved with
        ``_Detached`` markers and ``failures`` matches ``_apply_chunk``.
        """
        pool = self._straggler_pool
        deadline = self.spec.straggler_after
        entries: list[Any] = []
        per_phase = [[0, 0.0] for _ in self.phases]
        failures: list[tuple[int, int | None, BaseException]] = []
        n_detached = 0
        n_shed = 0
        for pos, v in enumerate(items):
            fut = pool.try_submit(self._run_item, v) if pool is not None else None
            if fut is None:
                n_shed += 1
                rec = self._run_item(v)
            else:
                try:
                    rec = fut.result(timeout=deadline)
                except FuturesTimeout:
                    entries.append(_Detached(fut, pos))
                    n_detached += 1
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "straggler:detach", "straggler",
                            {"stage": self.spec.name, "pos": pos},
                        )
                    continue
            ok, value, failed_k, exc, times, _elapsed = rec
            for k, dt in times:
                acc = per_phase[k]
                acc[0] += 1
                acc[1] += dt
            if ok:
                entries.append(value)
            else:
                failures.append((failed_k, pos, exc))
        return entries, per_phase, failures, (n_detached, n_shed)

    def _chunk_budget(self, n_items: int) -> float | None:
        """Whole-chunk hang backstop: only boundable when EVERY phase has a
        timeout (an untimed phase may legitimately run forever)."""
        if any(p.timeout is None for p in self.phases):
            return None
        return sum(p.timeout for p in self.phases) * n_items

    def _failure(
        self, k: int, exc: BaseException, item_index: int | None
    ) -> PipelineFailure:
        """A fail-fast ``PipelineFailure`` attributed to phase ``k`` (and,
        when known, the stage-stream index of the failing item)."""
        return PipelineFailure(
            self.phases[k].name,
            exc,
            item_index=item_index,
            fused_stage=self.spec.name if self.spec.fused else None,
        )

    def _record_chunk(self, outcome: tuple, base: int) -> list[Any]:
        """Fold a chunk's worker-side outcome into per-phase stats (on the
        loop thread — StageStats is single-writer) and return the surviving
        entries in input order (values, plus ``_Detached`` markers on the
        slow-lane path).  ``base`` is the chunk's first stage-stream index,
        for failure provenance.  Per-chunk cost is O(phases + failures),
        not O(items).  Raises ``PipelineFailure`` if a failing phase is
        fail-fast (after recording the whole chunk, so the dashboard shows
        it even when one item tears the pipeline down)."""
        if len(outcome) == 4:
            entries, per_phase, failures, (n_detached, n_shed) = outcome
            self.phase_stats[0].straggler_shed += n_shed
            if n_detached:
                # rebase the markers' chunk-local positions to stage-stream
                # indices (the worker does not know the chunk's base)
                for e in entries:
                    if type(e) is _Detached:
                        e.index += base
        else:
            entries, per_phase, failures = outcome
        for k, (entered, dt) in enumerate(per_phase):
            st = self.phase_stats[k]
            if k > 0:
                st.num_in += entered  # survivors of phase k-1 enter phase k
            st.record_task(dt)
            if k < len(self.phase_stats) - 1:
                # what this phase handed to the next phase, in-worker
                survived = per_phase[k + 1][0] if k + 1 < len(per_phase) else 0
                st.record_out_many(survived)
        failure: PipelineFailure | None = None
        for k, pos, exc in failures:
            self.phase_stats[k].record_failure(exc)
            logger.warning("stage %s failed on item: %r", self.phases[k].name, exc)
            if self.phases[k].on_error is OnError.FAIL and failure is None:
                failure = self._failure(
                    k, exc, base + pos if pos is not None else None
                )
        if failure is not None:
            raise failure
        return entries

    async def _guarded_chunk(self, unit: tuple[int, list[Any]]) -> list[Any]:
        """Run one chunk task; returns surviving entries (input order).
        Raises only in fail-fast mode (or on cancellation).  ``unit`` is
        ``(first stage-stream index, items)``."""
        base, items = unit
        loop = asyncio.get_running_loop()
        ex = self.spec.executor or self.default_executor
        apply = (
            self._apply_chunk_slowlane
            if self._straggler_pool is not None
            else self._apply_chunk
        )
        coro = loop.run_in_executor(ex, apply, items)
        budget = self._chunk_budget(len(items))
        try:
            if budget is not None:
                outcomes = await asyncio.wait_for(coro, budget)
            else:
                outcomes = await coro
        except asyncio.CancelledError:
            raise
        except asyncio.TimeoutError as e:
            # the whole-chunk backstop tripped: the worker is hung, so every
            # item of this chunk is lost (charged to the first timed phase)
            k = next(i for i, p in enumerate(self.phases) if p.timeout is not None)
            st = self.phase_stats[k]
            for _ in items:
                st.record_failure(e)
            logger.warning(
                "stage %s: chunk of %d items exceeded the %0.1fs chunk budget",
                self.phases[k].name, len(items), budget,
            )
            if any(p.on_error is OnError.FAIL for p in self.phases):
                raise self._failure(k, e, None) from e
            return []
        return self._record_chunk(outcomes, base)

    async def _resolve_straggler(self, d: _Detached) -> Any:
        """Await a detached item's completion (loop thread) and fold its
        record into stats.  Returns the item's value, or ``_DROPPED`` when
        it produced none (failure hole / timeout).  Raises
        ``PipelineFailure`` when the failing phase is fail-fast.

        The wait is bounded by the same budget rule as chunks (sum of phase
        timeouts — armed only when every phase has one); a straggler that
        outlives it is recorded as a timeout failure and its thread is left
        to finish on its own (it cannot be preempted).
        """
        st0 = self.phase_stats[0]
        budget = self._chunk_budget(1)
        fut = asyncio.wrap_future(d.future)
        try:
            if budget is not None:
                rec = await asyncio.wait_for(fut, budget)
            else:
                rec = await fut
        except asyncio.CancelledError:
            raise
        except asyncio.TimeoutError as e:
            k = next(i for i, p in enumerate(self.phases) if p.timeout is not None)
            st0.stragglers += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "straggler:budget_exceeded", "straggler",
                    {"stage": self.spec.name, "index": d.index, "budget_s": budget},
                )
            self.phase_stats[k].record_failure(e)
            logger.warning(
                "stage %s: straggler item #%d exceeded its %0.1fs budget",
                self.phases[k].name, d.index, budget,
            )
            if any(p.on_error is OnError.FAIL for p in self.phases):
                raise self._failure(k, e, d.index) from e
            return _DROPPED
        ok, value, failed_k, exc, times, elapsed = rec
        st0.stragglers += 1
        st0.straggler_time += elapsed
        if self.tracer.enabled:
            self.tracer.instant(
                "straggler:resolve", "straggler",
                {"stage": self.spec.name, "index": d.index,
                 "elapsed_s": round(elapsed, 6), "ok": ok},
            )
        last_reached = times[-1][0] if times else 0
        for k, dt in times:
            st = self.phase_stats[k]
            if k > 0:
                st.num_in += 1
            st.record_task(dt)
            if k < last_reached:
                st.record_out_many(1)  # it went on to the next phase
        if ok:
            return value
        self.phase_stats[failed_k].record_failure(exc)
        logger.warning(
            "stage %s failed on straggler item #%d: %r",
            self.phases[failed_k].name, d.index, exc,
        )
        if self.phases[failed_k].on_error is OnError.FAIL:
            raise self._failure(failed_k, exc, d.index) from exc
        return _DROPPED

    # -- top-level runner --------------------------------------------------
    async def run(self) -> None:
        """Run the stage body with the EOF teardown protocol."""
        body = {
            "source": self._run_source,
            "pipe": self._run_pipe,
            "aggregate": self._run_aggregate,
            "aggregate_into": self._run_aggregate_into,
            "disaggregate": self._run_disaggregate,
        }[self.spec.kind]
        try:
            await body()
            await self.out_q.put(EOF)  # normal path: block until accepted
        except BaseException:
            self.out_q.put_nowait_force(EOF)  # teardown path: never block
            raise

    # -- stage bodies ----------------------------------------------------
    async def _run_source(self) -> None:
        src = self.spec.source
        if hasattr(src, "__aiter__"):
            async for item in src:  # type: ignore[union-attr]
                await self._emit(item)
        else:
            # A synchronous iterable is advanced on the loop thread.  The
            # per-item cost of sources (paths / indices) is tiny; blocking
            # sources should be wrapped in an async generator or offloaded
            # with a pipe stage instead.  Emission is batched up to the
            # output queue's capacity so a chunk-pulling consumer costs one
            # source hop per chunk, not per item.
            it = iter(src)  # type: ignore[arg-type]
            n = max(1, self.out_q.maxsize)
            while True:
                chunk = list(itertools.islice(it, n))
                if not chunk:
                    break
                await self._emit_many(chunk)

    def _pipe_adapters(self) -> tuple[Callable, Callable, Callable]:
        """The three points where the per-item and chunked pipe runners
        differ:

        * ``pull()`` → ``(units, eof)``: zero or one dispatchable work
          units (a single item, or a non-empty chunk list) pulled with one
          queue interaction;
        * ``run(unit)`` → outcome: the unit's stage function(s), guarded;
        * ``emit(outcome)``: push whatever survived downstream.

        ``run`` and ``emit`` are separate because the ordered runner must
        run units concurrently but emit strictly in FIFO dispatch order.
        Everything else — the concurrency semaphore, the FIFO task queue,
        the EOF/teardown protocol — is shared scaffolding in
        ``_run_pipe_ordered``/``_run_pipe_unordered`` and exists exactly
        once.
        """
        if self.spec.chunk > 1 or self.spec.fused:
            # running stage-stream index of the next chunk's first item —
            # pulled single-threadedly by the reader, so a plain closure
            # counter is race-free and failure provenance costs nothing
            next_base = 0

            async def pull() -> tuple[tuple, bool]:
                nonlocal next_base
                chunk = await self.in_q.get_many(self.spec.chunk)
                eof = chunk[-1] is EOF
                if eof:
                    chunk.pop()  # the partial tail chunk still runs
                if not chunk:
                    return (), eof
                base = next_base
                next_base += len(chunk)
                return ((base, chunk),), eof

            if self._straggler_pool is not None:

                async def emit(entries: list[Any]) -> None:
                    # hole-fill: a _Detached marker is awaited AT its
                    # position, so the stream stays in input order; later
                    # chunks keep processing meanwhile (the widened task
                    # queue provides the runahead)
                    batch: list[Any] = []
                    for e in entries:
                        if type(e) is _Detached:
                            if batch:
                                await self._emit_many(batch)
                                batch = []
                            v = await self._resolve_straggler(e)
                            if v is not _DROPPED:
                                batch.append(v)
                        else:
                            batch.append(e)
                    if batch:
                        await self._emit_many(batch)

            else:

                async def emit(results: list[Any]) -> None:
                    if results:
                        await self._emit_many(results)

            return pull, self._guarded_chunk, emit

        next_idx = itertools.count()

        async def pull() -> tuple[tuple, bool]:
            item = await self.in_q.get()
            if item is EOF:
                return (), True
            return ((next(next_idx), item),), False

        async def emit(outcome: tuple[bool, Any]) -> None:
            ok, result = outcome
            if ok:
                await self._emit(result)

        return pull, self._guarded, emit

    async def _run_pipe(self) -> None:
        if self.spec.output_order == "completion":
            await self._run_pipe_unordered()
        else:
            await self._run_pipe_ordered()

    async def _run_pipe_ordered(self) -> None:
        """Input-order-preserving concurrent map (per-item or chunked).

        A reader creates up to ``concurrency`` in-flight tasks; an emitter
        awaits them in FIFO order, so results come out in input order while
        up to N units (items, or whole chunks) are processed concurrently.
        The bounded task queue is the concurrency limiter, so backpressure
        from out_q stalls the reader.  With chunks, order is preserved
        twice over: chunks dispatch and emit in FIFO order, and
        ``_apply_chunk`` walks its items in order.
        """
        assert self.in_q is not None
        pull, run, emit = self._pipe_adapters()
        # ``sem`` is the true in-flight bound; ``task_q`` only parks tasks
        # (running or completed) in FIFO order for the emitter, so completed
        # results buffered ahead of a backpressured emitter stay bounded too.
        sem = asyncio.Semaphore(self.spec.concurrency)
        # Slow-lane runahead: while the emitter is parked on a detached
        # straggler (hole-fill), the reader may keep dispatching chunks —
        # they complete (releasing sem) and park here until the hole fills.
        # The extra depth is what lets the stage hide straggler latency;
        # without it, one straggler re-serializes the stream after
        # ``concurrency`` chunks of cover.
        depth = self.spec.concurrency
        if self._straggler_pool is not None:
            depth += self.spec.straggler_runahead or 3 * self.spec.concurrency
        task_q: asyncio.Queue[Any] = asyncio.Queue(depth)

        async def guarded_release(unit: Any) -> Any:
            try:
                return await run(unit)
            finally:
                sem.release()

        async def reader() -> None:
            try:
                eof = False
                while not eof:
                    units, eof = await pull()
                    for unit in units:
                        await sem.acquire()
                        t = asyncio.ensure_future(guarded_release(unit))
                        try:
                            await task_q.put(t)
                        except BaseException:
                            t.cancel()
                            raise
                await task_q.put(EOF)
            except BaseException:
                # Emitter is failed/cancelled (or we are); never block here.
                try:
                    task_q.put_nowait(EOF)
                except asyncio.QueueFull:
                    pass
                raise

        async def emitter() -> None:
            while True:
                t = await task_q.get()
                if t is EOF:
                    return
                await emit(await t)

        try:
            async with TaskGroup() as tg:
                tg.create_task(reader(), name=f"{self.spec.name}:reader")
                tg.create_task(emitter(), name=f"{self.spec.name}:emitter")
        except BaseException:
            while not task_q.empty():  # cancel still-pending work
                t = task_q.get_nowait()
                if t is not EOF:
                    t.cancel()
            raise

    async def _run_pipe_unordered(self) -> None:
        """Completion-order concurrent map (lower latency, no ordering
        across units; items within a chunk still emit in order)."""
        assert self.in_q is not None
        pull, run, emit = self._pipe_adapters()
        sem = asyncio.Semaphore(self.spec.concurrency)
        slowlane = self._straggler_pool is not None and (
            self.spec.chunk > 1 or self.spec.fused
        )

        async def resolve_and_emit(d: _Detached) -> None:
            v = await self._resolve_straggler(d)
            if v is not _DROPPED:
                await self._emit(v)

        async def worker(unit: Any, tg: TaskGroup) -> None:
            try:
                outcome = await run(unit)
                if slowlane:
                    # emit ready values now; a detached straggler resolves
                    # on a sibling task so it does not hold this worker's
                    # concurrency slot (in-flight resolvers are bounded by
                    # the straggler pool's size — one marker per worker)
                    ready: list[Any] = []
                    for e in outcome:
                        if type(e) is _Detached:
                            tg.create_task(resolve_and_emit(e))
                        else:
                            ready.append(e)
                    if ready:
                        await self._emit_many(ready)
                else:
                    await emit(outcome)
            finally:
                sem.release()

        async with TaskGroup() as tg:
            eof = False
            while not eof:
                units, eof = await pull()
                for unit in units:
                    await sem.acquire()
                    tg.create_task(worker(unit, tg))
            # TaskGroup's __aexit__ awaits outstanding workers (and any
            # straggler resolvers they spawned) before we return to run(),
            # which then emits EOF downstream.

    async def _run_aggregate(self) -> None:
        assert self.in_q is not None
        size = self.spec.agg_size
        buf: list[Any] = []
        eof = False
        while not eof:
            items = await self.in_q.get_many(size)  # one hop per batch-ish
            if items[-1] is EOF:
                eof = True
                items.pop()
            buf.extend(items)
            while len(buf) >= size:
                await self._emit(buf[:size])
                del buf[:size]
        if buf and not self.spec.drop_last:
            await self._emit(buf)

    async def _run_aggregate_into(self) -> None:
        """Slot-aware batching over an arena (zero-copy assembly).

        Input items are ``SlotRef``s whose rows were already written in
        place by upstream stages; this stage never buffers arrays.  In the
        clean case the first ``agg_size`` refs are exactly slab X, slots
        0..N-1, and the batch is the slab itself: zero copies.  A failed
        item upstream leaves a hole in its slab; compaction then copies the
        displaced rows (only rows at/after the hole) so emitted batches
        stay dense.  A slab drained entirely by compaction (never emitted)
        is auto-released by the arena; an emitted slab is released by the
        consumer (see ``DeviceTransfer``) after its device copy completes.

        Requires an input-order-preserving upstream: refs of slab k must
        all arrive before refs of slab k+1.
        """
        assert self.in_q is not None
        size = self.spec.agg_size
        ready: list[Any] = []  # SlotRefs, in arrival (= source) order
        eof = False
        while not eof:
            items = await self.in_q.get_many(size)  # one hop per batch-ish
            if items[-1] is EOF:
                eof = True
                items.pop()
            ready.extend(items)
            while len(ready) >= size:
                await self._emit(self._assemble(ready, size))
        if ready:
            if self.spec.drop_last:
                for ref in ready:
                    ref.slab.consume_row()
                for ref in ready:
                    ref.slab.force_seal()
            else:
                # seal every slab the tail touches: a non-primary slab fully
                # drained into the final partial batch would otherwise stay
                # unsealed (the binder never finished it) and leak
                tail_slabs = list({id(r.slab): r.slab for r in ready}.values())
                await self._emit(self._assemble(ready, len(ready)))
                for slab in tail_slabs:
                    slab.force_seal()
        # A slab whose remaining assigned rows ALL failed upstream sends no
        # ref here at all — it is in use, unsealed, and nothing above can
        # reach it.  EOF means upstream is fully drained (queues preserve
        # order), so sealing every pending slab is safe and lets the
        # arena's hole accounting recycle it instead of leaking it until
        # teardown.
        self.spec.arena.seal_pending()

    def _assemble(self, ready: list[Any], n: int) -> Any:
        refs = ready[:n]
        del ready[:n]
        primary = refs[0].slab
        in_batch = 0
        for pos, ref in enumerate(refs):
            if ref.slab is primary:
                in_batch += 1
                # In-place compaction reads slot `ref.slot` into row `pos`;
                # rows < pos are already compacted destinations, so a source
                # below pos was ALREADY OVERWRITTEN — only an out-of-order
                # upstream (output_order="completion") produces that, and it
                # must fail loudly rather than emit duplicated rows.
                if ref.slot < pos:
                    raise RuntimeError(
                        f"aggregate_into stage {self.spec.name!r}: ref "
                        f"{ref!r} arrived after row {pos} was compacted — "
                        "the upstream stage must preserve input order"
                    )
                if ref.slot == pos:
                    continue
            for key, arr in primary.arrays.items():
                arr[pos] = ref.slab.arrays[key][ref.slot]
            if ref.slab is not primary:
                ref.slab.consume_row()
        # Emitting a sealed slab while some of its rows are still pending
        # upstream would recycle memory those refs point into.  Together
        # with the monotonic-slot check above, this makes an out-of-order
        # upstream (output_order="completion") fail loudly instead of
        # corrupting data.
        if (
            primary.sealed
            and in_batch + primary.holes + primary.drained < primary.assigned
        ):
            raise RuntimeError(
                f"aggregate_into stage {self.spec.name!r}: emitted slab "
                f"{primary!r} still has pending rows upstream — the "
                "upstream stage must preserve input order"
            )
        if not primary.sealed:
            primary.force_seal()  # partial final batch: no more rows coming
        primary.mark_emitted()
        return primary.as_batch(n)

    async def _run_disaggregate(self) -> None:
        assert self.in_q is not None
        while True:
            item = await self.in_q.get()
            if item is EOF:
                break
            await self._emit_many(list(item))
