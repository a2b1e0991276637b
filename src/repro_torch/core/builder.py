"""PipelineBuilder — the paper's user-facing construction API (§5.9.1).

No DSL: stages are plain Python callables (sync or async).  Example::

    pipeline = (
        PipelineBuilder()
        .add_source(source())
        .pipe(download, concurrency=12)
        .pipe(decode, concurrency=4)
        .aggregate(32)
        .pipe(batch_transfer)
        .add_sink(buffer_size=3)
        .build(num_threads=16)
    )
"""

from __future__ import annotations

from concurrent.futures import Executor
from typing import Any, AsyncIterable, Callable, Iterable

from .engine import StageSpec, _is_async_callable
from .errors import OnError
from .pipeline import Pipeline


class PipelineBuilder:
    def __init__(self) -> None:
        self._specs: list[StageSpec] = []
        self._sink_buffer_size: int | None = None
        self._fuse_groups: list[tuple[str, ...]] = []

    # ------------------------------------------------------------------
    def add_source(self, source: Iterable | AsyncIterable, name: str = "source") -> "PipelineBuilder":
        if self._specs:
            raise ValueError("add_source must be the first stage")
        if not (hasattr(source, "__iter__") or hasattr(source, "__aiter__")):
            raise TypeError("source must be Iterable or AsyncIterable")
        self._specs.append(StageSpec(kind="source", name=name, source=source))
        return self

    def pipe(
        self,
        fn: Callable[[Any], Any],
        *,
        concurrency: int = 1,
        executor: Executor | None = None,
        name: str | None = None,
        output_order: str = "input",
        on_error: str | OnError = OnError.SKIP,
        timeout: float | None = None,
        queue_size: int = 2,
        cache: Any = None,
        chunk: int = 1,
        vectorized: bool = False,
        straggler_after: float | None = None,
        straggler_runahead: int = 0,
    ) -> "PipelineBuilder":
        """Chain a processing stage.

        Args:
          fn: sync or async callable applied to each item.  Sync callables
            run on the pipeline thread pool (or ``executor`` if given), so
            they should release the GIL to scale; async callables run on the
            event loop (never GIL-bound).
          concurrency: max in-flight tasks for this stage (with ``chunk``,
            max in-flight *chunks*).
          executor: optional executor override; pass a
            ``ProcessPoolExecutor`` for GIL-holding third-party code (§5.8).
          output_order: "input" preserves input order; "completion" emits as
            tasks finish.
          on_error: "skip" (robust, default) or "fail" (fail-fast).
          timeout: optional per-item timeout in seconds.  With ``chunk`` it
            is enforced post hoc inside the worker (plus a whole-chunk hang
            backstop) — see the engine docstring.
          queue_size: output queue bound (backpressure granularity).  The
            pipeline widens it automatically when the NEXT stage pulls in
            chunks, so a chunked consumer can actually fill its chunks.
          cache: optional cache/prefetcher probe (anything with a ``stats()``
            dict of hits/misses/evictions/bytes_cached/prefetch_depth);
            its counters are folded into this stage's ``Pipeline.stats()``
            snapshot — how shard-cache visibility reaches the dashboard.
          chunk: items per executor dispatch.  ``chunk=N`` pulls up to N
            items per queue hop and applies ``fn`` across them inside ONE
            worker call, making the event-loop cost O(items/chunk) — the
            fix for loop-overhead-bound stages (high occupancy, near-zero
            task time).  Per-item error holes are preserved: a failing
            item under ``on_error="skip"`` drops only itself, not its
            chunk.  Requires a sync ``fn``.
          vectorized: the fn takes the whole chunk (a list) and returns a
            same-length, same-order list — for stages that can batch their
            own lookups (numpy gathers, bulk reads).  The fn owns per-item
            robustness: an exception it raises fails the WHOLE chunk.
            Requires ``chunk > 1``.
          straggler_after: soft per-item deadline in seconds — the straggler
            slow lane.  A chunked item exceeding it is detached to the
            pipeline's bounded straggler pool so its chunk-mates emit
            without waiting; the straggler's result re-enters the stream at
            its original position (``output_order="input"``) or whenever it
            lands (``"completion"``).  Requires ``chunk > 1``, a sync
            ``fn``, and a *stateless* fn (items run item-major on
            concurrent pool threads).  Incompatible with ``vectorized``.
            See the engine docstring ("Straggler slow lane").
          straggler_runahead: extra parked chunks the ordered emitter may
            run ahead while a detached straggler resolves (0 = default of
            3 × ``concurrency``).  This bounds how much straggler latency
            the stage can hide: roughly
            ``(concurrency + straggler_runahead) × chunk`` items of cover.
        """
        self._require_source()
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if output_order not in ("input", "completion"):
            raise ValueError("output_order must be 'input' or 'completion'")
        if chunk > 1 and _is_async_callable(fn):
            raise ValueError(
                "chunk > 1 requires a sync stage function (an async fn runs "
                "on the event loop — there is no executor dispatch to amortize)"
            )
        if vectorized and chunk <= 1:
            raise ValueError("vectorized=True requires chunk > 1")
        if straggler_after is not None:
            if straggler_after <= 0:
                raise ValueError("straggler_after must be > 0 seconds")
            if chunk <= 1:
                raise ValueError(
                    "straggler_after requires chunk > 1 (the slow lane "
                    "exists to stop one item holding its chunk hostage)"
                )
            if vectorized:
                raise ValueError(
                    "straggler_after is incompatible with vectorized=True "
                    "(the slow lane runs items item-major; a vectorized fn "
                    "only takes whole chunks)"
                )
        if straggler_runahead < 0:
            raise ValueError("straggler_runahead must be >= 0")
        self._specs.append(
            StageSpec(
                kind="pipe",
                name=name or getattr(fn, "__name__", "pipe"),
                fn=fn,
                concurrency=concurrency,
                executor=executor,
                output_order=output_order,
                on_error=OnError(on_error),
                timeout=timeout,
                queue_size=queue_size,
                cache=cache,
                chunk=chunk,
                vectorized=vectorized,
                straggler_after=straggler_after,
                straggler_runahead=straggler_runahead,
            )
        )
        return self

    def fuse(self, *names: str) -> "PipelineBuilder":
        """Collapse the named adjacent pipe stages into ONE executor call
        per item/chunk at ``build()`` time.

        Fusion removes the queue + task layer between the stages — their
        functions run back to back inside the same worker thread — while
        ``Pipeline.stats()`` keeps reporting them as separate rows (phase
        timings are recorded in the worker).  Each phase keeps its own
        ``on_error``/``timeout``/``cache``; a failure is attributed to the
        phase that raised and (under ``on_error="skip"``) drops only that
        item.

        Requirements (checked at ``build()``): the stages must be adjacent,
        already added, sync, share an executor, and preserve input order.
        A ``concurrency=1`` stage (often stateful) can only fuse with other
        ``concurrency=1`` stages — fusing it wider would break its
        single-writer guarantee.
        """
        if len(names) < 2:
            raise ValueError("fuse needs at least two stage names")
        if len(set(names)) != len(names):
            raise ValueError(f"fuse names must be distinct, got {names!r}")
        self._fuse_groups.append(tuple(names))
        return self

    def aggregate(self, num_items: int, *, drop_last: bool = False, name: str | None = None) -> "PipelineBuilder":
        """Group consecutive items into lists of ``num_items`` (§5.9.1)."""
        self._require_source()
        if num_items < 1:
            raise ValueError("num_items must be >= 1")
        self._specs.append(
            StageSpec(
                kind="aggregate",
                name=name or f"aggregate({num_items})",
                agg_size=num_items,
                drop_last=drop_last,
            )
        )
        return self

    def aggregate_into(
        self,
        arena: Any,
        num_items: int | None = None,
        *,
        drop_last: bool = False,
        name: str | None = None,
    ) -> "PipelineBuilder":
        """Slot-aware batching: group ``SlotRef`` tickets into the arena slab
        they were decoded into (zero-copy batch assembly).

        The upstream stages must carry ``(item, SlotRef)`` assignments handed
        out by ``arena.binder()`` and write each row in place (see
        ``repro.data.arena``).  Unlike ``aggregate`` this stage buffers no
        arrays: in the clean case the emitted batch *is* the slab.  Requires
        an input-order-preserving upstream (the default ``output_order``)
        and ``num_items == arena.batch_size`` — a sub-slab batch size would
        let one slab back two live batches, so in-place compaction of the
        second would corrupt the first after it was already delivered.
        """
        self._require_source()
        size = num_items if num_items is not None else arena.batch_size
        if size != arena.batch_size:
            raise ValueError(
                f"num_items ({size}) must equal arena batch_size "
                f"({arena.batch_size}): one emitted batch per slab"
            )
        self._specs.append(
            StageSpec(
                kind="aggregate_into",
                name=name or f"aggregate_into({size})",
                agg_size=size,
                drop_last=drop_last,
                arena=arena,
            )
        )
        return self

    def disaggregate(self, name: str | None = None) -> "PipelineBuilder":
        """Flatten iterable items back into single elements."""
        self._require_source()
        self._specs.append(StageSpec(kind="disaggregate", name=name or "disaggregate"))
        return self

    def add_sink(self, buffer_size: int = 3) -> "PipelineBuilder":
        """Terminal buffer the consumer thread reads from."""
        self._require_source()
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if self._sink_buffer_size is not None:
            raise ValueError("add_sink already called")
        self._sink_buffer_size = buffer_size
        return self

    # ------------------------------------------------------------------
    def build(
        self,
        *,
        num_threads: int = 8,
        auto_fuse: bool = False,
        straggler_workers: int = 8,
        trace=None,
    ) -> Pipeline:
        """Finalize the pipeline.  The fusion pass runs here: explicit
        ``fuse()`` groups are collapsed (invalid groups raise), and with
        ``auto_fuse=True`` any remaining adjacent sync, same-executor,
        order-preserving pipe stages are collapsed too (ineligible pairs
        are silently left alone).  ``straggler_workers`` sizes the
        pipeline's shared straggler pool (only created when some stage set
        ``straggler_after``).  ``trace`` is an optional
        ``core.trace.Tracer``: stage/phase spans and queue-wait spans of
        this pipeline are recorded into it (see the engine docstring's
        "Observability" section; install it process-wide with
        ``trace.set_tracer`` to also capture shard/transfer spans)."""
        self._require_source()
        if len(self._specs) < 2:
            raise ValueError("pipeline needs at least a source and one stage")
        specs = self._fused_specs(auto_fuse)
        return Pipeline(
            specs,
            num_threads=num_threads,
            sink_buffer_size=self._sink_buffer_size or 3,
            straggler_workers=straggler_workers,
            tracer=trace,
        )

    # -- fusion pass ----------------------------------------------------
    @staticmethod
    def _fusable(a: StageSpec, b: StageSpec) -> str | None:
        """Why ``b`` cannot be fused onto the group ending in ``a``
        (None = fusable).  ``a`` may itself already be a fused spec."""
        for spec in (a, b):
            if spec.kind != "pipe":
                return f"stage {spec.name!r} is not a pipe stage"
            if spec.output_order != "input":
                return f"stage {spec.name!r} does not preserve input order"
            for phase in spec.phases:
                if _is_async_callable(phase.fn):
                    return f"stage {phase.name!r} is async (never leaves the loop)"
        if (a.executor or None) is not (b.executor or None):
            return f"stages {a.name!r} and {b.name!r} use different executors"
        conc = max(a.concurrency, b.concurrency)
        if conc > 1 and min(a.concurrency, b.concurrency) == 1:
            return (
                f"stage {(a if a.concurrency == 1 else b).name!r} is "
                "concurrency=1 (possibly stateful) and cannot be widened "
                f"to the fused concurrency {conc}"
            )
        if a.straggler_after is not None or b.straggler_after is not None:
            # the slow lane runs items item-major through every phase — a
            # vectorized phase (whole-chunk fn) cannot be driven that way
            for spec in (a, b):
                for phase in spec.phases:
                    if phase.vectorized:
                        return (
                            f"stage {phase.name!r} is vectorized and cannot "
                            "fuse into a straggler slow lane (items run "
                            "item-major)"
                        )
        return None

    @staticmethod
    def _fuse_pair(a: StageSpec, b: StageSpec) -> StageSpec:
        """One fused spec from two adjacent ones (either may be fused
        already — groups grow left to right)."""
        phases = a.phases + b.phases
        deadlines = [
            s.straggler_after for s in (a, b) if s.straggler_after is not None
        ]
        return StageSpec(
            kind="pipe",
            name="+".join(p.name for p in phases),
            fn=None,
            concurrency=max(a.concurrency, b.concurrency),
            executor=a.executor,
            output_order="input",
            queue_size=b.queue_size,  # the fused output queue is b's
            chunk=max(a.chunk, b.chunk),
            fused=phases,
            # the fused item runs every phase back to back, so the
            # tightest deadline of the group governs the whole run
            straggler_after=min(deadlines) if deadlines else None,
            straggler_runahead=max(a.straggler_runahead, b.straggler_runahead),
        )

    def _fused_specs(self, auto_fuse: bool) -> list[StageSpec]:
        specs = list(self._specs)
        by_name: dict[str, int] = {}
        for i, s in enumerate(specs):
            by_name.setdefault(s.name, i)
        fused_away: set[int] = set()
        for group in self._fuse_groups:
            positions = []
            for n in group:
                if n not in by_name:
                    raise ValueError(f"fuse: no stage named {n!r}")
                positions.append(by_name[n])
            if positions != list(range(positions[0], positions[0] + len(group))):
                raise ValueError(
                    f"fuse: stages {group!r} are not adjacent in pipeline order"
                )
            if any(p in fused_away for p in positions):
                raise ValueError(f"fuse: stages {group!r} overlap another fuse group")
            merged = specs[positions[0]]
            for pos in positions[1:]:
                why = self._fusable(merged, specs[pos])
                if why is not None:
                    raise ValueError(f"cannot fuse {group!r}: {why}")
                merged = self._fuse_pair(merged, specs[pos])
                fused_away.add(pos)
            specs[positions[0]] = merged
        out = [s for i, s in enumerate(specs) if i not in fused_away]
        if auto_fuse:
            merged_out = [out[0]]
            for spec in out[1:]:
                if self._fusable(merged_out[-1], spec) is None:
                    merged_out[-1] = self._fuse_pair(merged_out[-1], spec)
                else:
                    merged_out.append(spec)
            out = merged_out
        return out

    def _require_source(self) -> None:
        if not self._specs:
            raise ValueError("call add_source first")
