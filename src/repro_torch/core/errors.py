"""Error types and per-sample failure policies for the pipeline engine.

The paper's "Robustness" principle (§5.4): sample-level failures (bad media,
flaky network) must not kill the pipeline; they are logged, counted, and
skipped.  A pipeline can opt into fail-fast semantics instead.

Failure provenance: a fail-fast ``PipelineFailure`` names the *phase* that
raised (for a fused stage that is the original sub-stage, not the composite
``"read+decode"`` runtime) and, where the runner knows it, the stage-stream
index of the item that failed — so "which input broke us" is recoverable
from the exception itself, not just from the stats dashboard.
"""

from __future__ import annotations

import enum


class OnError(str, enum.Enum):
    """What a stage does when its function raises for one item."""

    SKIP = "skip"  # log + count + drop the item, keep going (paper default)
    FAIL = "fail"  # cancel the whole pipeline, surface the error to the iterator


class PipelineFailure(RuntimeError):
    """Raised in the consumer thread when a fail-fast stage errored.

    ``stage`` is the name of the *raising* stage — for a fused runtime that
    is the phase that actually raised (``"decode"``, not ``"read+decode"``);
    the composite runtime name, when different, is in ``fused_stage``.
    ``phase`` is an explicit alias of the raising phase name.  ``item_index``
    is the 0-based index of the failing item in this stage's input stream
    (``None`` when the failure is not attributable to one item — e.g. a
    whole-chunk hang backstop or a vectorized chunk failure).  The original
    exception is available as ``__cause__``.
    """

    def __init__(
        self,
        stage: str,
        cause: BaseException,
        *,
        item_index: int | None = None,
        fused_stage: str | None = None,
    ):
        where = f"pipeline stage {stage!r}"
        if fused_stage is not None and fused_stage != stage:
            where += f" (phase of {fused_stage!r})"
        at = f" on item #{item_index}" if item_index is not None else ""
        super().__init__(f"{where} failed{at}: {cause!r}")
        self.stage = stage
        self.phase = stage
        self.item_index = item_index
        self.fused_stage = fused_stage
        self.__cause__ = cause


class PipelineStalled(RuntimeError):
    """Raised by the health monitor when the pipeline stopped making
    progress for longer than ``stalled_after_s`` — the structured
    alternative to a consumer blocking forever on a dead sink.

    ``stage`` names the suspected culprit (the earliest non-progressing
    stage that still holds items), ``stalled_for_s`` is how long the sink
    has been silent, and ``snapshot`` is the ``Pipeline.stats()`` rows at
    detection time for post-mortems.
    """

    def __init__(self, stage: str, stalled_for_s: float, snapshot=None):
        super().__init__(
            f"pipeline made no progress for {stalled_for_s:.1f}s "
            f"(suspected stage: {stage!r})"
        )
        self.stage = stage
        self.stalled_for_s = stalled_for_s
        self.snapshot = snapshot


class PipelineStopped(RuntimeError):
    """Raised when interacting with a pipeline that has been stopped."""
