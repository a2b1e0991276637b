"""Pipeline health: stall detection + graceful degradation.

The engine's own backstops (per-item timeouts, the whole-chunk hang budget,
the straggler slow lane) only fire *inside* a stage function.  A pipeline
can still stop making progress with every backstop disarmed — a source
blocked on a dead socket, an untimed stage stuck in C code, a peer fleet
timing out every fetch.  The consumer then blocks in ``get_item`` forever
with no exception to catch and no thread to look at.

``HealthMonitor`` closes that gap from the *consumer* side: it derives a
HEALTHY / DEGRADED / STALLED state per stage from successive
``Pipeline.stats()`` snapshots (progress = ``num_out + num_failed`` delta —
a stage skipping bad items is making progress), sheds optional work while
degraded, and raises a structured ``PipelineStalled`` naming the suspect
stage instead of letting the consumer hang.  The snapshots ride a
``core.metrics.StatsHistory`` (one ring shared with dashboards and the
``/metrics`` exporter): every ``observe()`` appends a sample, so guarding
a pipeline gives you its windowed rates for free via
``monitor.history.window(...)``; state *transitions* are also recorded as
tracer instants (category ``health``) when a process-wide tracer is
installed.

It is deliberately *not* a background thread: ``observe()`` is cheap (one
stats snapshot) and is driven by the consumer's own cadence — either
explicit ``observe()``/``check()`` calls, or the ``guard()`` iterator that
wraps ``get_item`` with a timeout tick.  No new threads, no new races, and
a paused consumer cannot be spuriously diagnosed as a stalled pipeline.

Graceful degradation: a DEGRADED pipeline (some stage quiet for
``degraded_after_s`` with work pending) starts shedding *optional* work —
correctness stays, opportunistic throughput features go.  Degrade actions
form a one-way escalation ladder: each ``escalate_every_s`` of continued
degradation applies the next rung.  The stock rungs:

* ``disable_verify(prefetcher)`` — stop eager CRC verification on shard
  install (per-sample lazy CRC still protects reads);
* ``widen_sparse_threshold(prefetcher, factor)`` — prefer sparse/partial
  shard fetches to whole-shard downloads, cutting bytes on the wire;
* ``shrink_replication(tiered)`` — serve each shard from its ring owner
  only (skip replica probes): keeps the peer tier but halves its
  per-request fan-out — the rung *between* widening sparse fetches and
  giving up on peers entirely;
* ``origin_only(tiered)`` — stop consulting the peer tier entirely
  (``TieredSource.disable_peers``) when the fleet itself is the suspect.

Example::

    monitor = HealthMonitor(
        pipeline,
        degraded_after_s=5.0,
        stalled_after_s=60.0,
        actions=[disable_verify(pf), origin_only(tiered)],
    )
    with pipeline.auto_stop():
        for batch in monitor.guard():
            train_step(batch)          # raises PipelineStalled, never hangs
"""

from __future__ import annotations

import enum
import logging
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Iterator

from . import trace as _trace
from .errors import PipelineStalled
from .metrics import StatsHistory

logger = logging.getLogger("repro.core")


class StageHealth(enum.Enum):
    """Per-stage (and overall) health state, worst-of across stages."""

    HEALTHY = "healthy"
    DEGRADED = "degraded"  # work pending, no progress for degraded_after_s
    STALLED = "stalled"  # work pending, no progress for stalled_after_s

    def __lt__(self, other: "StageHealth") -> bool:
        order = [StageHealth.HEALTHY, StageHealth.DEGRADED, StageHealth.STALLED]
        return order.index(self) < order.index(other)


class DegradeAction:
    """One rung of the degradation ladder: a named, idempotent, one-way
    shed of optional work.  ``apply()`` swallows and logs exceptions — a
    broken degrade hook must never take down an already-struggling
    pipeline."""

    def __init__(self, name: str, fn: Callable[[], Any]):
        self.name = name
        self._fn = fn
        self.applied = False

    def apply(self) -> None:
        if self.applied:
            return
        self.applied = True
        try:
            self._fn()
            logger.warning("pipeline degraded: applied %r", self.name)
        except Exception:  # noqa: BLE001 - degrade hooks are best-effort
            logger.exception("degrade action %r failed (ignored)", self.name)


def disable_verify(prefetcher) -> DegradeAction:
    """Shed eager CRC verification on shard install (lazy per-sample CRC
    on the read path still catches corruption where it matters)."""

    def fn() -> None:
        prefetcher.verify_on_install = False

    return DegradeAction("disable_verify", fn)


def widen_sparse_threshold(prefetcher, factor: float = 4.0) -> DegradeAction:
    """Prefer sparse fetches: multiply the prefetcher's whole-shard
    threshold so fewer reads trigger full-shard downloads — less wire
    pressure while the fetch path is struggling."""

    def fn() -> None:
        prefetcher.sparse_threshold = float(prefetcher.sparse_threshold) * factor

    return DegradeAction(f"widen_sparse_threshold(x{factor:g})", fn)


def shrink_replication(tiered) -> DegradeAction:
    """Serve each shard from its consistent-hash owner only — replica
    probes are opportunistic work worth shedding before abandoning the
    peer tier altogether.  Accepts a ``TieredSource`` (delegates to its
    peer tier) or a ``PeerShardSource`` directly; a no-op ladder rung for
    round-robin placement (it has no replicas to shed)."""

    target = getattr(tiered, "peers", tiered)
    return DegradeAction("shrink_replication", target.shrink_replication)


def origin_only(tiered) -> DegradeAction:
    """Stop consulting the peer tier (``TieredSource.disable_peers``) —
    for when peer timeouts/errors are the suspected drag."""

    return DegradeAction("origin_only", tiered.disable_peers)


class HealthMonitor:
    """Consumer-driven pipeline health state machine.

    Progress per stats row is ``num_out + num_failed`` (failing forward is
    still forward).  A stage is suspect only while it *holds* work
    (``num_in`` exceeds what it has disposed of) or is the source of a
    silent pipeline — a stage that is merely finished is healthy.

    ``observe()`` returns the overall ``StageHealth`` (worst across
    stages) and applies the next degrade rung when the pipeline has been
    continuously degraded for another ``escalate_every_s``.  ``check()``
    additionally raises ``PipelineStalled`` on STALLED.  ``guard()`` wraps
    the two around ``Pipeline.get_item`` as an iterator.
    """

    def __init__(
        self,
        pipeline,
        *,
        degraded_after_s: float = 5.0,
        stalled_after_s: float = 30.0,
        actions: list[DegradeAction] | tuple = (),
        escalate_every_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        history: StatsHistory | None = None,
    ):
        if degraded_after_s <= 0 or stalled_after_s <= 0:
            raise ValueError("health thresholds must be > 0 seconds")
        if stalled_after_s < degraded_after_s:
            raise ValueError("stalled_after_s must be >= degraded_after_s")
        self.pipeline = pipeline
        self.degraded_after_s = degraded_after_s
        self.stalled_after_s = stalled_after_s
        self.actions = list(actions)
        self.escalate_every_s = (
            escalate_every_s if escalate_every_s is not None else degraded_after_s
        )
        self._clock = clock
        # the time series this monitor reads (and feeds): progress-change
        # ledger + windowed rates live here, shared with dashboards/exporters
        self.history = (
            history
            if history is not None
            else StatsHistory(pipeline, clock=clock)
        )
        self._t_last_action: float | None = None
        self._states: dict[str, StageHealth] = {}
        # True when the last STALLED verdict came from the whole-pipeline
        # sentinel (no individual row stalled): duration reporting must then
        # use the sentinel's quiet time, not any single row's.
        self._sentinel_stall = False

    # -- state derivation ---------------------------------------------------
    def observe(self) -> StageHealth:
        """Append a sample to the history, update per-stage states, fire
        degrade rungs.  Returns the overall health (worst across stages)."""
        now = self._clock()
        snaps = self.history.sample(now=now)
        states: dict[str, StageHealth] = {}
        worst = StageHealth.HEALTHY
        finished = bool(getattr(self.pipeline, "finished", False))
        any_progress = False
        for i, s in enumerate(snaps):
            quiet = self.history.quiet_for(i, now=now)
            if quiet == 0.0:
                any_progress = True
            # a quiet stage is only suspect while it HOLDS work: items in
            # that it has neither emitted nor failed.  (The first stage of
            # a fused runtime owns the runtime's input accounting, so this
            # covers fused stages too.)
            pending = s.num_in > s.num_out + s.num_failed
            state = StageHealth.HEALTHY
            if pending and not finished:
                if quiet >= self.stalled_after_s:
                    state = StageHealth.STALLED
                elif quiet >= self.degraded_after_s:
                    state = StageHealth.DEGRADED
            states[s.name] = state
            if worst < state:
                worst = state
        # a fully-quiet pipeline with nothing visibly pending is still a
        # stall from the consumer's seat (e.g. the SOURCE is stuck, so no
        # stage ever shows pending work) — track whole-pipeline quiet via a
        # sentinel row keyed past the real ones
        quiet_all = self.history.quiet_for(-1, now=now)
        self._sentinel_stall = False
        if not finished and not any_progress and worst is StageHealth.HEALTHY:
            # no stage shows pending work, so the source is the suspect
            src_name = snaps[0].name if snaps else "pipeline"
            if quiet_all >= self.stalled_after_s:
                states[src_name] = StageHealth.STALLED
                worst = StageHealth.STALLED
                self._sentinel_stall = True
            elif quiet_all >= self.degraded_after_s:
                states[src_name] = StageHealth.DEGRADED
                worst = StageHealth.DEGRADED
        tracer = _trace.get_tracer()
        if tracer.enabled:
            for name, state in states.items():
                if self._states.get(name, StageHealth.HEALTHY) is not state:
                    tracer.instant(
                        f"health:{name}", "health", {"state": state.value}
                    )
        self._states = states
        if worst != StageHealth.HEALTHY:
            self._maybe_escalate(now)
        else:
            self._t_last_action = None  # a recovery re-arms the first delay
        return worst

    def _maybe_escalate(self, now: float) -> None:
        nxt = next((a for a in self.actions if not a.applied), None)
        if nxt is None:
            return
        if self._t_last_action is None or (
            now - self._t_last_action >= self.escalate_every_s
        ):
            self._t_last_action = now
            nxt.apply()

    # -- queries ------------------------------------------------------------
    def stage_states(self) -> dict[str, StageHealth]:
        """Per-stage states as of the last ``observe()``."""
        return dict(self._states)

    def applied_actions(self) -> list[str]:
        return [a.name for a in self.actions if a.applied]

    def _suspect(self, snaps) -> str:
        for name, state in self._states.items():
            if state is StageHealth.STALLED:
                return name
        for s in snaps:
            if s.num_in > s.num_out + s.num_failed:
                return s.name
        return snaps[0].name if snaps else "pipeline"

    def check(self) -> StageHealth:
        """``observe()``, but raises ``PipelineStalled`` on STALLED."""
        state = self.observe()
        if state is StageHealth.STALLED:
            snaps = self.pipeline.stats()
            stage = self._suspect(snaps)
            now = self._clock()
            if self._sentinel_stall:
                # whole-pipeline stall: no individual row is stalled, so the
                # sentinel's own quiet time IS the stall duration (a source
                # row that legitimately finished ages ago must not inflate it)
                quiets = [self.history.quiet_for(-1, now=now)]
            else:
                # quiet time of the STALLED rows only — finished stages and
                # the sentinel must not overstate how long we've been stuck
                quiets = [
                    self.history.quiet_for(i, now=now)
                    for i, s in enumerate(snaps)
                    if self._states.get(s.name) is StageHealth.STALLED
                ]
            raise PipelineStalled(
                stage,
                max(quiets, default=self.stalled_after_s),
                snapshot=snaps,
            )
        return state

    # -- consumption --------------------------------------------------------
    def guard(self, *, tick: float = 1.0, chunk: int = 1) -> Iterator[Any]:
        """Iterate the pipeline with stall detection: yields every item,
        polls health every ``tick`` seconds of sink silence, and raises
        ``PipelineStalled`` instead of blocking forever.  Degrade rungs
        fire from the same cadence.

        ``chunk > 1`` drains via ``Pipeline.get_items(chunk, ...)`` — one
        cross-thread round trip per chunk of already-buffered items instead
        of one per item — and still yields item by item.

        Ticking is lossless either way: a timed-out drain keeps its sink
        getter pending inside the ``Pipeline`` and the next call (per-item
        or chunked) resumes it, so a tick shorter than the inter-batch
        latency never drops a batch or the EOF."""
        while True:
            try:
                if chunk > 1:
                    items = self.pipeline.get_items(chunk, timeout=tick)
                else:
                    items = [self.pipeline.get_item(timeout=tick)]
            except FuturesTimeout:
                self.check()
                continue
            except StopIteration:
                return
            yield from items
