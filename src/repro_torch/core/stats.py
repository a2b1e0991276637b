"""Per-stage visibility (paper §5.4 "Visibility").

Every stage keeps cheap monotonic-clock counters: items in/out, failures,
task latency, and how long tasks were blocked putting into a full output
queue (the backpressure signal) or waiting on an empty input queue (the
starvation signal).  ``Pipeline.stats()`` snapshots them; ``format_stats``
renders the dashboard used to find the bottleneck stage.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

#: Cap on distinct exception types tracked per stage; further types fold
#: into the ``"_other"`` bucket so a pathological error stream cannot grow
#: the counter without bound.
MAX_ERROR_TYPES = 16


@dataclasses.dataclass
class StageStats:
    """Mutable counters for one stage. Updated from the event-loop thread."""

    name: str
    concurrency: int = 1
    chunk: int = 1  # items per executor dispatch (1 = per-item path)
    chunkable: bool = False  # sync pipe stage: chunk= would be accepted
    num_in: int = 0  # items pulled from the input queue
    num_out: int = 0  # items emitted to the output queue
    num_failed: int = 0
    # straggler slow lane (chunked stages with straggler_after): items
    # detached past the soft deadline, seconds those items ran in total,
    # and detach candidates that had to run inline because the straggler
    # pool was saturated (no deadline protection for those)
    stragglers: int = 0
    straggler_time: float = 0.0
    straggler_shed: int = 0
    task_time: float = 0.0  # seconds spent inside the stage function
    get_wait: float = 0.0  # seconds blocked waiting for input (starved)
    put_wait: float = 0.0  # seconds blocked waiting for output space (backpressured)
    first_out_t: float | None = None  # monotonic time of first emitted item
    last_error: str | None = None
    # bounded per-exception-type failure counts (``last_error`` keeps only
    # the most recent repr; this keeps the distribution)
    errors_by_type: dict[str, int] = dataclasses.field(default_factory=dict)
    arena: object | None = None  # SlabArena of an aggregate_into stage, if any
    cache: object | None = None  # shard cache/prefetcher probed by this stage
    _t_start: float = dataclasses.field(default_factory=time.monotonic)

    # -- recording ---------------------------------------------------------
    def record_task(self, dt: float) -> None:
        self.task_time += dt

    def record_out(self) -> None:
        self.num_out += 1
        if self.first_out_t is None:
            self.first_out_t = time.monotonic()

    def record_out_many(self, n: int) -> None:
        """Batched ``record_out`` — one call per chunk, not per item."""
        if n <= 0:
            return
        self.num_out += n
        if self.first_out_t is None:
            self.first_out_t = time.monotonic()

    def record_failure(self, err: BaseException) -> None:
        self.num_failed += 1
        self.last_error = repr(err)
        etype = type(err).__name__
        if etype not in self.errors_by_type and len(self.errors_by_type) >= MAX_ERROR_TYPES:
            etype = "_other"
        self.errors_by_type[etype] = self.errors_by_type.get(etype, 0) + 1

    # -- derived -----------------------------------------------------------
    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._t_start

    @property
    def qps(self) -> float:
        return self.num_out / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def avg_task_time(self) -> float:
        n = self.num_out + self.num_failed
        return self.task_time / n if n else 0.0

    @property
    def occupancy(self) -> float:
        """Fraction of wall time the stage's workers were busy (per-worker)."""
        if self.elapsed <= 0 or self.concurrency <= 0:
            return 0.0
        return self.task_time / (self.elapsed * self.concurrency)

    def snapshot(self) -> "StageStatsSnapshot":
        cache = self.cache.stats() if self.cache is not None else {}
        ttfi = (
            self.first_out_t - self._t_start if self.first_out_t is not None else None
        )
        return StageStatsSnapshot(
            name=self.name,
            concurrency=self.concurrency,
            chunk=self.chunk,
            chunkable=self.chunkable,
            num_in=self.num_in,
            num_out=self.num_out,
            num_failed=self.num_failed,
            stragglers=self.stragglers,
            straggler_time=self.straggler_time,
            straggler_shed=self.straggler_shed,
            qps=self.qps,
            avg_task_time=self.avg_task_time,
            occupancy=self.occupancy,
            get_wait=self.get_wait,
            put_wait=self.put_wait,
            last_error=self.last_error,
            task_time=self.task_time,
            elapsed=self.elapsed,
            time_to_first_s=ttfi,
            errors_by_type=tuple(sorted(self.errors_by_type.items())),
            bytes_allocated=getattr(self.arena, "bytes_allocated", 0),
            slabs_in_flight=(
                self.arena.slabs_in_flight if self.arena is not None else 0
            ),
            num_slabs=getattr(self.arena, "num_slabs", 0),
            cache_hits=int(cache.get("hits", 0)),
            cache_misses=int(cache.get("misses", 0)),
            cache_evictions=int(cache.get("evictions", 0)),
            bytes_cached=int(cache.get("bytes_cached", 0)),
            prefetch_depth=int(cache.get("prefetch_depth", 0)),
            bytes_fetched=int(cache.get("bytes_fetched", 0)),
            bytes_skipped=int(cache.get("bytes_skipped", 0)),
            fields_requested=int(cache.get("fields_requested", 0)),
            source_errors=int(cache.get("source_errors", 0)),
            source_retries=int(cache.get("source_retries", 0)),
            promotions=int(cache.get("promotions", 0)),
            peer_hits=int(cache.get("source_peer_hits", 0)),
            peer_bytes=int(cache.get("source_peer_bytes", 0)),
            origin_bytes=int(cache.get("source_origin_bytes", 0)),
            device_decode_ms=float(cache.get("device_decode_ms", 0.0)),
            device_decode_batches=int(cache.get("device_decode_batches", 0)),
        )


@dataclasses.dataclass(frozen=True)
class StageStatsSnapshot:
    name: str
    concurrency: int
    num_in: int
    num_out: int
    num_failed: int
    qps: float
    avg_task_time: float
    occupancy: float
    get_wait: float
    put_wait: float
    last_error: str | None
    # cumulative task seconds + stage uptime: the pair windowed-rate math
    # (``core.metrics.StatsHistory``) needs that the derived qps/occupancy
    # averages destroy
    task_time: float = 0.0
    elapsed: float = 0.0
    # seconds from stage start to its first emitted item (the paper's
    # first-batch-latency signal); None until something came out
    time_to_first_s: float | None = None
    # bounded per-exception-type failure counts, as sorted (type, n) pairs
    errors_by_type: tuple[tuple[str, int], ...] = ()
    # chunked execution: items per executor dispatch (1 = per-item path),
    # and whether chunk= is even applicable (sync pipe stage)
    chunk: int = 1
    chunkable: bool = False
    # straggler slow lane: deadline-detached items, their total run time,
    # and detach candidates shed to inline execution (pool saturated)
    stragglers: int = 0
    straggler_time: float = 0.0
    straggler_shed: int = 0
    # memory pressure (nonzero only for arena-backed aggregate_into stages)
    bytes_allocated: int = 0
    slabs_in_flight: int = 0
    num_slabs: int = 0
    # shard-cache visibility (nonzero only for stages with a cache probe)
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    bytes_cached: int = 0
    prefetch_depth: int = 0
    # remote-source visibility: wire bytes downloaded, and the retry/error
    # counters a RetryingSource-wrapped backend reports (0 for local/simulated)
    bytes_fetched: int = 0
    source_errors: int = 0
    source_retries: int = 0
    # columnar projection visibility (format v2 shards read with fields=...):
    # wire bytes the projection avoided fetching, and how many distinct
    # field names consumers have asked this prefetcher for
    bytes_skipped: int = 0
    fields_requested: int = 0
    # peer-exchange visibility (nonzero only behind a peer.TieredSource):
    # fetches answered by warm peer ranks vs bytes that had to come from the
    # origin object store, plus sparse→full cache promotions
    promotions: int = 0
    peer_hits: int = 0
    peer_bytes: int = 0
    origin_bytes: int = 0
    # consumer/device boundary visibility: chunks the consumer pulled via
    # the chunked sink drain (``Pipeline.get_items``; rides the terminal
    # stage's row), and the on-chip fused-decode dispatch cost a
    # ``DeviceTransfer(device_decode=...)`` stage reports via its probe
    sink_drained_chunks: int = 0
    device_decode_ms: float = 0.0
    device_decode_batches: int = 0


def format_stats(snaps: list[StageStatsSnapshot], window=None) -> str:
    """Render the visibility dashboard.

    A stage with high ``put_wait`` is backpressured (downstream is the
    bottleneck); a stage with high ``get_wait`` is starved (upstream is the
    bottleneck); the bottleneck stage itself shows high occupancy and low
    waits.  ``ttfi_ms`` is time-to-first-item — the paper's first-batch
    latency signal, per stage.

    ``window`` (a ``StatsHistory.window()`` result: ``{stage: WindowRates}``)
    adds *current* rate columns next to the lifetime averages — ``qps_w`` /
    ``occ_w%`` are the trailing-window values, which is what "is it slow
    NOW" questions need (the lifetime ``qps`` column averages over the
    whole run).
    """
    windowed = window or {}
    hdr = (
        f"{'stage':<24}{'conc':>5}{'in':>9}{'out':>9}{'fail':>6}"
        f"{'qps':>10}{'task_ms':>9}{'occ%':>6}{'get_w':>8}{'put_w':>8}"
        f"{'ttfi_ms':>9}"
    )
    if windowed:
        hdr += f"{'qps_w':>10}{'occ_w%':>7}"
    lines = [hdr, "-" * len(hdr)]
    for s in snaps:
        ttfi = f"{s.time_to_first_s * 1e3:>9.1f}" if s.time_to_first_s is not None else f"{'-':>9}"
        line = (
            f"{s.name:<24}{s.concurrency:>5}{s.num_in:>9}{s.num_out:>9}"
            f"{s.num_failed:>6}{s.qps:>10.1f}{s.avg_task_time * 1e3:>9.2f}"
            f"{s.occupancy * 100:>6.1f}{s.get_wait:>8.2f}{s.put_wait:>8.2f}"
            f"{ttfi}"
        )
        if windowed:
            w = windowed.get(s.name)
            if w is not None:
                line += f"{w.qps:>10.1f}{w.occupancy * 100:>7.1f}"
            else:
                line += f"{'-':>10}{'-':>7}"
        lines.append(line)
    for s in snaps:
        if s.errors_by_type:
            kinds = " ".join(f"{t}={n}" for t, n in s.errors_by_type)
            lines.append(f"[{s.name}] errors: {kinds} last={s.last_error}")
        if s.stragglers or s.straggler_shed:
            avg = s.straggler_time / s.stragglers * 1e3 if s.stragglers else 0.0
            lines.append(
                f"[{s.name}] stragglers: detached={s.stragglers}"
                f" avg_ms={avg:.1f} shed={s.straggler_shed}"
            )
        if s.num_slabs:
            lines.append(
                f"[{s.name}] arena: slabs_in_flight={s.slabs_in_flight}/{s.num_slabs}"
                f" bytes_allocated={s.bytes_allocated / 2**20:.1f}MB"
            )
        if s.device_decode_batches or s.device_decode_ms:
            avg = (
                s.device_decode_ms / s.device_decode_batches
                if s.device_decode_batches
                else 0.0
            )
            lines.append(
                f"[{s.name}] device-decode: batches={s.device_decode_batches}"
                f" dispatch_ms={s.device_decode_ms:.1f} avg_ms={avg:.2f}"
            )
        if s.sink_drained_chunks:
            items = s.num_out / s.sink_drained_chunks
            lines.append(
                f"[{s.name}] sink: drained_chunks={s.sink_drained_chunks}"
                f" avg_items/chunk={items:.1f}"
            )
        if s.cache_hits or s.cache_misses or s.prefetch_depth:
            total = s.cache_hits + s.cache_misses
            rate = s.cache_hits / total if total else 0.0
            line = (
                f"[{s.name}] shard-cache: hits={s.cache_hits} misses={s.cache_misses}"
                f" ({rate * 100:.0f}% hit) evictions={s.cache_evictions}"
                f" cached={s.bytes_cached / 2**20:.1f}MB"
                f" prefetch_depth={s.prefetch_depth}"
            )
            if s.bytes_fetched:
                line += f" fetched={s.bytes_fetched / 2**20:.1f}MB"
            if s.bytes_skipped or s.fields_requested:
                line += (
                    f" skipped={s.bytes_skipped / 2**20:.1f}MB"
                    f" fields={s.fields_requested}"
                )
            if s.promotions:
                line += f" promotions={s.promotions}"
            if s.source_errors or s.source_retries:
                line += f" src_errors={s.source_errors} src_retries={s.source_retries}"
            lines.append(line)
            if s.peer_hits or s.peer_bytes or s.origin_bytes:
                lines.append(
                    f"[{s.name}] peers: peer_hits={s.peer_hits}"
                    f" peer_bytes={s.peer_bytes / 2**20:.1f}MB"
                    f" origin_bytes={s.origin_bytes / 2**20:.1f}MB"
                )
    return "\n".join(lines)


class ResourceSampler:
    """Background sampler of process CPU time and RSS (for the paper's
    Fig 6/7-style resource benchmarks).  Samples from /proc/self."""

    def __init__(self, interval: float = 0.2):
        self.interval = interval
        self.samples: list[tuple[float, float, int]] = []  # (t, cpu_s, rss_bytes)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _read() -> tuple[float, int]:
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        try:
            tick = float(os.sysconf("SC_CLK_TCK")) or 100.0
        except (ValueError, OSError, AttributeError):
            tick = 100.0  # USER_HZ default when sysconf can't say
        cpu_s = (int(parts[13]) + int(parts[14])) / tick  # utime + stime
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        try:
            page = os.sysconf("SC_PAGE_SIZE") or 4096
        except (ValueError, OSError, AttributeError):
            page = 4096
        return cpu_s, rss_pages * page

    def current(self) -> tuple[float, int]:
        """Latest ``(cpu_seconds, rss_bytes)`` — the newest background
        sample, or a fresh /proc read when the sampler is not running
        (this is what the ``/metrics`` exporter scrapes)."""
        if self.samples:
            _t, cpu, rss = self.samples[-1]
            return cpu, rss
        return self._read()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            cpu, rss = self._read()
            self.samples.append((time.monotonic(), cpu, rss))

    def __enter__(self) -> "ResourceSampler":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="rsrc-sampler")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def summary(self) -> dict[str, float]:
        if len(self.samples) < 2:
            cpu, rss = self._read()
            return {"cpu_util": 0.0, "peak_rss_mb": rss / 2**20, "avg_rss_mb": rss / 2**20}
        (t0, c0, _), (t1, c1, _) = self.samples[0], self.samples[-1]
        rss = [s[2] for s in self.samples]
        return {
            "cpu_util": (c1 - c0) / (t1 - t0) if t1 > t0 else 0.0,
            "peak_rss_mb": max(rss) / 2**20,
            "avg_rss_mb": sum(rss) / len(rss) / 2**20,
        }
