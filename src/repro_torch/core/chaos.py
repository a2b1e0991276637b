"""Fault injection for pipeline stages (the engine half of the chaos layer;
the shard-fleet half lives in ``data.shards.testing``).

``FaultInjectingStage`` wraps any sync stage function with deterministic,
seeded misbehavior — bimodal latency tails, per-item errors, hangs — so the
robustness machinery (straggler slow lane, per-item skip holes, the
whole-chunk hang backstop, health monitoring) can be exercised and *gated*
instead of trusted.  Used by ``benchmarks/bench_faults.py`` and
``tests/test_faults.py``; never by production loaders.

Determinism: each call draws from a private ``random.Random`` keyed by
``(seed, call-ordinal)``, so the SET of injected faults (how many slow
items, how many errors) is reproducible run-to-run even when the pipeline
executes items concurrently — only which *worker* hits them varies.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Any, Callable

from . import trace as _trace


class ChaosError(RuntimeError):
    """The injected per-item failure (distinguishable from real bugs)."""


class FaultInjectingStage:
    """Wrap a stage fn with seeded latency tails / errors / hangs.

    Args:
      fn: the real (sync) stage function.
      seed: chaos seed; same seed → same injected fault set.
      slow_rate: probability an item pays ``slow_s`` extra latency — the
        bimodal tail the straggler slow lane exists for.
      slow_s: the slow mode's added latency (seconds).
      error_rate: probability an item raises ``ChaosError`` instead of
        returning (exercises skip holes / fail-fast).
      hang_rate: probability an item sleeps ``hang_s`` — long enough to be
        "never returns" at test timescales (exercises the whole-chunk
        backstop; keep 0.0 unless every phase has a timeout).
      hang_s: the hang duration.

    Counters (thread-safe): ``injected_slow`` / ``injected_errors`` /
    ``injected_hangs``; ``stats()`` returns them as a dict.
    """

    def __init__(
        self,
        fn: Callable[[Any], Any],
        *,
        seed: int = 0,
        slow_rate: float = 0.0,
        slow_s: float = 0.0,
        error_rate: float = 0.0,
        hang_rate: float = 0.0,
        hang_s: float = 60.0,
    ):
        for name, rate in (
            ("slow_rate", slow_rate),
            ("error_rate", error_rate),
            ("hang_rate", hang_rate),
        ):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self.fn = fn
        self.seed = seed
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        self.error_rate = error_rate
        self.hang_rate = hang_rate
        self.hang_s = hang_s
        self.__name__ = getattr(fn, "__name__", "stage")
        self._calls = itertools.count()  # thread-safe in CPython
        self._lock = threading.Lock()
        self.injected_slow = 0
        self.injected_errors = 0
        self.injected_hangs = 0

    def __call__(self, item: Any) -> Any:
        # one private stream per call ordinal: the draw is independent of
        # thread scheduling, so fault COUNTS are reproducible run-to-run
        r = random.Random((self.seed << 20) ^ next(self._calls)).random()
        tracer = _trace.get_tracer()
        if r < self.hang_rate:
            with self._lock:
                self.injected_hangs += 1
            if tracer.enabled:
                tracer.instant(
                    "chaos:hang", "chaos",
                    {"stage": self.__name__, "hang_s": self.hang_s},
                )
            time.sleep(self.hang_s)
        elif r < self.hang_rate + self.error_rate:
            with self._lock:
                self.injected_errors += 1
            if tracer.enabled:
                tracer.instant("chaos:error", "chaos", {"stage": self.__name__})
            raise ChaosError(f"injected failure (seed={self.seed})")
        elif r < self.hang_rate + self.error_rate + self.slow_rate:
            with self._lock:
                self.injected_slow += 1
            if tracer.enabled:
                tracer.instant(
                    "chaos:slow", "chaos",
                    {"stage": self.__name__, "slow_s": self.slow_s},
                )
            time.sleep(self.slow_s)
        return self.fn(item)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "injected_slow": self.injected_slow,
                "injected_errors": self.injected_errors,
                "injected_hangs": self.injected_hangs,
            }
