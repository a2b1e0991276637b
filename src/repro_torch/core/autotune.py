"""Pipeline auto-tuning: turn the visibility stats into concurrency changes.

The paper's principles make the loop explicit: *Visibility* tells you which
stage is the bottleneck, *Tunability* lets you widen exactly that stage.
``suggest()`` reads a live pipeline's stats and returns a concrete new
stage-concurrency map; ``autotune()`` re-builds the pipeline via a factory
until the sink stays ahead of the consumer or improvements stall.

Two bottleneck shapes, two remedies:

* a stage whose tasks take real time (``avg_task_time`` high) is
  *work-bound* — widen its ``concurrency`` so more tasks overlap;
* a stage that is busy yet does almost no work per item (high occupancy,
  near-zero ``avg_task_time``) is *loop-overhead-bound* — its cost is the
  4-5 event-loop round trips per item, which widening cannot parallelize
  (they all run on the one scheduler thread).  The remedy is chunking
  (``pipe(..., chunk=N)``), which amortizes the round trips over N items;
  ``suggest()`` proposes a chunk size in that case.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .pipeline import Pipeline

#: below this per-item task time a busy stage is loop-overhead-bound: the
#: executor round trip (~100us-1ms of loop bookkeeping, more on a loaded
#: box) rivals the work itself, so chunking, not widening, is the lever
LOOP_BOUND_TASK_S = 2e-3

#: chunk size proposed for loop-overhead-bound stages — large enough to
#: amortize the hop cost to noise, small enough not to distort latency or
#: the checkpoint skip bound
DEFAULT_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class Suggestion:
    stage: str | None  # None -> nothing to do
    concurrency: int
    reason: str
    #: proposed ``chunk=`` for the stage (None = keep per-item execution);
    #: set instead of a concurrency bump when the stage is loop-bound
    chunk: int | None = None


def suggest(pipeline: Pipeline, *, max_concurrency: int = 16) -> Suggestion:
    """Pick the stage to widen: the busiest pipe stage that is neither
    starved (upstream problem) nor backpressured (downstream problem).
    A busy stage doing near-zero work per item gets a ``chunk`` proposal
    instead of a concurrency bump (see module docstring)."""
    stats = [s for s in pipeline.stats() if s.name not in ("source",)]
    if not stats:
        return Suggestion(None, 0, "no stages")
    work = [s for s in stats if s.avg_task_time > 0]
    if not work:
        return Suggestion(None, 0, "no measurable work yet")
    bottleneck = max(work, key=lambda s: s.occupancy)
    if bottleneck.occupancy < 0.5:
        return Suggestion(
            None, bottleneck.concurrency,
            f"busiest stage {bottleneck.name!r} only {bottleneck.occupancy:.0%} occupied: "
            "pipeline is not the limiter",
        )
    if bottleneck.put_wait > bottleneck.get_wait * 2:
        return Suggestion(
            None, bottleneck.concurrency,
            f"{bottleneck.name!r} is backpressured (put_wait {bottleneck.put_wait:.2f}s): "
            "the consumer, not the pipeline, is the limiter",
        )
    if (
        bottleneck.avg_task_time < LOOP_BOUND_TASK_S
        and bottleneck.chunk <= 1
        and bottleneck.chunkable  # async stages cannot take chunk=
    ):
        return Suggestion(
            bottleneck.name, bottleneck.concurrency,
            f"{bottleneck.name!r} is loop-overhead-bound (occupied "
            f"{bottleneck.occupancy:.0%} at {bottleneck.avg_task_time * 1e6:.0f}us/item): "
            f"chunk it (chunk={DEFAULT_CHUNK}) — widening cannot parallelize "
            "event-loop bookkeeping",
            chunk=DEFAULT_CHUNK,
        )
    new = min(max_concurrency, bottleneck.concurrency * 2)
    if new == bottleneck.concurrency:
        return Suggestion(None, new, f"{bottleneck.name!r} already at max_concurrency")
    return Suggestion(
        bottleneck.name, new,
        f"{bottleneck.name!r} occupied {bottleneck.occupancy:.0%} with low waits: widen "
        f"{bottleneck.concurrency} -> {new}",
    )


def autotune(
    factory: Callable[[dict[str, int]], Pipeline],
    probe: Callable[[Pipeline], float],
    *,
    initial: dict[str, int] | None = None,
    rounds: int = 3,
    min_gain: float = 0.05,
) -> tuple[dict[str, int], list[dict]]:
    """Iterate: build pipeline with the concurrency map → probe throughput →
    apply the suggestion; stop on < min_gain improvement or no suggestion.

    ``factory(conc_map)`` builds a fresh pipeline; ``probe`` consumes some
    of it and returns items/s.  Returns ``(best_map, log)`` where
    ``best_map`` is the concurrency map of the BEST-measured round — a
    final regressing round never wins just by being applied last.  A chunk
    suggestion ends the loop (the concurrency-map factory cannot apply it;
    it is recorded in the log for the caller).
    """
    conc = dict(initial or {})
    log: list[dict] = []
    best = -1.0
    best_map = dict(conc)
    for r in range(rounds):
        pipe = factory(conc)
        with pipe.auto_stop():
            rate = probe(pipe)
            s = suggest(pipe)
        log.append({"round": r, "conc": dict(conc), "rate": rate, "suggestion": s.reason})
        improved = rate >= best * (1.0 + min_gain)
        if rate > best:
            best = rate
            best_map = dict(conc)
        if r > 0 and not improved:
            break
        if s.stage is None or s.chunk is not None:
            break
        conc[s.stage] = s.concurrency
    return best_map, log
