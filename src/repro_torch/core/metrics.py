"""Time-series telemetry: windowed rates + Prometheus ``/metrics`` export.

The stats counters are lifetime-cumulative: a ``qps`` that averages over the
whole run says nothing about *now*, which is exactly the signal a live
dashboard, the health monitor, and the (ROADMAP) autotune controller need.
This module adds the two missing layers:

* ``StatsHistory`` — a bounded ring of timestamped ``Pipeline.stats()``
  snapshots.  ``sample()`` is driven by the consumer's cadence (the
  ``HealthMonitor`` calls it from ``observe()``) or by an optional
  background thread (``start(interval)``); ``window(seconds)`` serves
  *windowed* deltas — current qps / occupancy / wait fractions per stage —
  and ``quiet_for(row)`` the per-row progress-staleness the health state
  machine keys off.
* ``MetricsExporter`` — renders pipelines, histories, and resource samples
  in the Prometheus text exposition format.  Mountable on the existing
  shard HTTP servers (``ShardHTTPServer(metrics=...)``,
  ``PeerShardServer(metrics=...)`` answer ``GET /metrics``) or standalone
  via ``exporter.serve(port=...)`` — a tiny stdlib HTTP server, no new
  dependencies.

Windowed rates are computed between the newest sample and the newest sample
at least ``seconds`` old (so a ``window(5)`` covers ≥5s once history is
that deep); rows are matched positionally, which is stable for a pipeline's
lifetime.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterable

from .stats import StageStatsSnapshot

__all__ = [
    "WindowRates",
    "StatsHistory",
    "MetricsExporter",
    "MetricsServer",
    "CONTENT_TYPE_LATEST",
]

#: Prometheus text exposition content type.
CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


@dataclasses.dataclass(frozen=True)
class WindowRates:
    """Per-stage rates over one history window (the "now" row next to the
    snapshot's lifetime averages)."""

    name: str
    dt: float  # window length actually covered (seconds)
    in_rate: float  # items entering the stage per second
    qps: float  # items emitted per second
    fail_rate: float  # failures per second
    occupancy: float  # fraction of the window the stage's workers were busy
    get_wait_frac: float  # fraction of the window spent starved for input
    put_wait_frac: float  # fraction of the window spent backpressured


class StatsHistory:
    """Ring-bounded time series of ``Pipeline.stats()`` snapshots.

    ``sample()`` appends one timestamped snapshot row-set and updates the
    per-row last-progress-change ledger (progress = ``num_out +
    num_failed``; row ``-1`` is the whole-pipeline sentinel).  All methods
    are thread-safe: the background sampler, a ``/metrics`` scrape, and the
    consumer's health ticks may interleave freely.
    """

    def __init__(
        self,
        pipeline: Any = None,
        *,
        capacity: int = 512,
        clock: Callable[[], float] = time.monotonic,
        stats_fn: Callable[[], list[StageStatsSnapshot]] | None = None,
    ):
        if stats_fn is None:
            if pipeline is None:
                raise ValueError("StatsHistory needs a pipeline or a stats_fn")
            stats_fn = pipeline.stats
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (deltas need two samples)")
        self._stats_fn = stats_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: deque[tuple[float, list[StageStatsSnapshot]]] = deque(
            maxlen=capacity
        )
        # row index -> (progress count, clock time it last changed);
        # row -1 is the whole-pipeline sentinel (sum across rows)
        self._last_change: dict[int, tuple[int, float]] = {}
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()

    # -- sampling ---------------------------------------------------------
    def sample(self, now: float | None = None) -> list[StageStatsSnapshot]:
        """Take one snapshot; returns the rows (also kept in the ring)."""
        if now is None:
            now = self._clock()
        snaps = self._stats_fn()
        with self._lock:
            self._samples.append((now, snaps))
            total = 0
            for i, s in enumerate(snaps):
                count = s.num_out + s.num_failed
                total += count
                prev = self._last_change.get(i)
                if prev is None or prev[0] != count:
                    self._last_change[i] = (count, now)
            prev = self._last_change.get(-1)
            if prev is None or prev[0] != total:
                self._last_change[-1] = (total, now)
        return snaps

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def last(self) -> tuple[float, list[StageStatsSnapshot]] | None:
        """Newest ``(t, rows)`` sample, or None before the first one."""
        with self._lock:
            return self._samples[-1] if self._samples else None

    # -- progress staleness (the health monitor's signal) -----------------
    def quiet_for(self, row: int, now: float | None = None) -> float:
        """Seconds since row ``row``'s progress count last changed, as of
        ``now`` (default: the newest sample's timestamp).  0.0 for a row
        never sampled or one that changed on the latest sample."""
        with self._lock:
            rec = self._last_change.get(row)
            if now is None:
                now = self._samples[-1][0] if self._samples else self._clock()
        if rec is None:
            return 0.0
        return max(0.0, now - rec[1])

    # -- windowed rates ----------------------------------------------------
    def window(self, seconds: float | None = None) -> dict[str, WindowRates]:
        """Per-stage rates over the trailing window (whole history when
        ``seconds`` is None).  Empty dict until two samples exist."""
        with self._lock:
            samples = list(self._samples)
        if len(samples) < 2:
            return {}
        t1, new = samples[-1]
        t0, old = samples[0]
        if seconds is not None:
            # newest sample at least `seconds` old → the window covers >= the
            # asked-for span as soon as history is deep enough
            for t, rows in reversed(samples[:-1]):
                if t1 - t >= seconds:
                    t0, old = t, rows
                    break
            else:
                t0, old = samples[0]
        dt = t1 - t0
        out: dict[str, WindowRates] = {}
        for i in range(min(len(new), len(old))):
            n, o = new[i], old[i]
            if dt <= 0:
                out[n.name] = WindowRates(n.name, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
                continue
            conc = max(1, n.concurrency)
            out[n.name] = WindowRates(
                name=n.name,
                dt=dt,
                in_rate=max(0, n.num_in - o.num_in) / dt,
                qps=max(0, n.num_out - o.num_out) / dt,
                fail_rate=max(0, n.num_failed - o.num_failed) / dt,
                occupancy=max(0.0, n.task_time - o.task_time) / (dt * conc),
                get_wait_frac=max(0.0, n.get_wait - o.get_wait) / dt,
                put_wait_frac=max(0.0, n.put_wait - o.put_wait) / dt,
            )
        return out

    # -- optional background cadence --------------------------------------
    def start(self, interval: float = 1.0) -> "StatsHistory":
        """Sample on a daemon-thread cadence (for dashboards/scrapes that
        have no consumer loop to ride).  Idempotent; ``stop()`` to end."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def _run() -> None:
            while not self._stop_evt.wait(interval):
                try:
                    self.sample()
                except Exception:  # pragma: no cover - stats_fn died mid-run
                    return

        self._thread = threading.Thread(
            target=_run, daemon=True, name="stats-history"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StatsHistory":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()


# -- Prometheus text exposition -------------------------------------------
def _esc(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(**kv: str) -> str:
    inner = ",".join(f'{k}="{_esc(str(v))}"' for k, v in kv.items() if v is not None)
    return "{" + inner + "}" if inner else ""


def _num(v: float) -> str:
    if isinstance(v, float) and v != v:  # NaN
        return "NaN"
    return repr(v) if isinstance(v, float) else str(v)


class _Families:
    """Accumulates samples grouped by metric family, renders HELP/TYPE once
    per family in insertion order."""

    def __init__(self) -> None:
        self._fams: dict[str, tuple[str, str, list[str]]] = {}

    def add(self, name: str, kind: str, help_: str, value: float, **labels: str) -> None:
        fam = self._fams.get(name)
        if fam is None:
            fam = (kind, help_, [])
            self._fams[name] = fam
        fam[2].append(f"{name}{_labels(**labels)} {_num(value)}")

    def render(self) -> str:
        out: list[str] = []
        for name, (kind, help_, rows) in self._fams.items():
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            out.extend(rows)
        return "\n".join(out) + "\n" if out else ""


def stage_metrics_lines(
    snaps: list[StageStatsSnapshot],
    *,
    namespace: str = "repro",
    pipeline: str = "pipeline",
    window: dict[str, WindowRates] | None = None,
) -> list[str]:
    """Prometheus lines for one pipeline's stage rows (plus windowed gauges
    when a ``StatsHistory.window()`` result is supplied)."""
    f = _Families()
    p = namespace
    for s in snaps:
        lb = {"pipeline": pipeline, "stage": s.name}
        f.add(f"{p}_stage_items_in_total", "counter",
              "Items pulled from the stage input queue.", s.num_in, **lb)
        f.add(f"{p}_stage_items_out_total", "counter",
              "Items emitted to the stage output queue.", s.num_out, **lb)
        f.add(f"{p}_stage_failures_total", "counter",
              "Items that raised in the stage function.", s.num_failed, **lb)
        f.add(f"{p}_stage_task_seconds_total", "counter",
              "Seconds spent inside the stage function.", s.task_time, **lb)
        f.add(f"{p}_stage_get_wait_seconds_total", "counter",
              "Seconds blocked waiting for input (starved).", s.get_wait, **lb)
        f.add(f"{p}_stage_put_wait_seconds_total", "counter",
              "Seconds blocked on a full output queue (backpressured).",
              s.put_wait, **lb)
        f.add(f"{p}_stage_qps", "gauge",
              "Lifetime-average items/s emitted.", s.qps, **lb)
        f.add(f"{p}_stage_occupancy", "gauge",
              "Lifetime fraction of wall time the stage workers were busy.",
              s.occupancy, **lb)
        if s.time_to_first_s is not None:
            f.add(f"{p}_stage_time_to_first_item_seconds", "gauge",
                  "Seconds from stage start to its first emitted item.",
                  s.time_to_first_s, **lb)
        for etype, count in s.errors_by_type:
            f.add(f"{p}_stage_errors_total", "counter",
                  "Stage failures by exception type.", count,
                  type=etype, **lb)
        if s.stragglers or s.straggler_shed:
            f.add(f"{p}_stage_stragglers_total", "counter",
                  "Items detached to the straggler slow lane.", s.stragglers, **lb)
            f.add(f"{p}_stage_straggler_shed_total", "counter",
                  "Detach candidates run inline (pool saturated).",
                  s.straggler_shed, **lb)
        if s.num_slabs:
            f.add(f"{p}_arena_slabs_in_flight", "gauge",
                  "Arena slabs currently lent out.", s.slabs_in_flight, **lb)
            f.add(f"{p}_arena_bytes_allocated", "gauge",
                  "Arena bytes allocated.", s.bytes_allocated, **lb)
        if s.cache_hits or s.cache_misses or s.prefetch_depth or s.bytes_cached:
            f.add(f"{p}_shard_cache_hits_total", "counter",
                  "Shard cache hits.", s.cache_hits, **lb)
            f.add(f"{p}_shard_cache_misses_total", "counter",
                  "Shard cache misses.", s.cache_misses, **lb)
            f.add(f"{p}_shard_cache_evictions_total", "counter",
                  "Shard cache evictions.", s.cache_evictions, **lb)
            f.add(f"{p}_shard_cache_bytes", "gauge",
                  "Bytes resident in the shard cache.", s.bytes_cached, **lb)
            f.add(f"{p}_shard_fetched_bytes_total", "counter",
                  "Bytes downloaded from shard sources.", s.bytes_fetched, **lb)
            f.add(f"{p}_shard_promotions_total", "counter",
                  "Sparse-to-full cache promotions.", s.promotions, **lb)
            if s.bytes_skipped or s.fields_requested:
                f.add(f"{p}_shard_skipped_bytes_total", "counter",
                      "Wire bytes avoided by columnar projection.",
                      s.bytes_skipped, **lb)
                f.add(f"{p}_shard_fields_requested", "gauge",
                      "Distinct field names requested from the prefetcher.",
                      s.fields_requested, **lb)
            if s.source_errors or s.source_retries:
                f.add(f"{p}_shard_source_errors_total", "counter",
                      "Shard source fetch errors.", s.source_errors, **lb)
                f.add(f"{p}_shard_source_retries_total", "counter",
                      "Shard source fetch retries.", s.source_retries, **lb)
        if s.device_decode_batches or s.device_decode_ms:
            f.add(f"{p}_device_decode_batches_total", "counter",
                  "Batches decoded on-chip by the fused dequant/normalize/"
                  "augment kernel behind DeviceTransfer.",
                  s.device_decode_batches, **lb)
            f.add(f"{p}_device_decode_dispatch_seconds_total", "counter",
                  "Host-side dispatch seconds spent launching the fused "
                  "on-chip decode (the device work itself is async).",
                  s.device_decode_ms / 1e3, **lb)
        if s.sink_drained_chunks:
            f.add(f"{p}_sink_drained_chunks_total", "counter",
                  "Chunks the consumer pulled via the chunked sink drain "
                  "(Pipeline.get_items).", s.sink_drained_chunks, **lb)
        if s.peer_hits or s.peer_bytes or s.origin_bytes:
            f.add(f"{p}_shard_peer_hits_total", "counter",
                  "Shard fetches answered by warm peers.", s.peer_hits, **lb)
            f.add(f"{p}_shard_peer_bytes_total", "counter",
                  "Bytes served by peers.", s.peer_bytes, **lb)
            f.add(f"{p}_shard_origin_bytes_total", "counter",
                  "Bytes served by the origin store.", s.origin_bytes, **lb)
    if window:
        for name, w in window.items():
            lb = {"pipeline": pipeline, "stage": name}
            f.add(f"{p}_stage_window_qps", "gauge",
                  "Items/s emitted over the trailing window.", w.qps, **lb)
            f.add(f"{p}_stage_window_occupancy", "gauge",
                  "Worker busy fraction over the trailing window.",
                  w.occupancy, **lb)
            f.add(f"{p}_stage_window_get_wait_fraction", "gauge",
                  "Starved fraction of the trailing window.",
                  w.get_wait_frac, **lb)
            f.add(f"{p}_stage_window_put_wait_fraction", "gauge",
                  "Backpressured fraction of the trailing window.",
                  w.put_wait_frac, **lb)
            f.add(f"{p}_stage_window_seconds", "gauge",
                  "Length of the trailing window actually covered.",
                  w.dt, **lb)
    return f.render().splitlines()


class MetricsExporter:
    """Composable Prometheus text-exposition renderer.

    Register pipelines (with optional ``StatsHistory`` for window gauges),
    a ``ResourceSampler`` for process CPU/RSS, and arbitrary collectors;
    ``render()`` produces the exposition body.  Mount it::

        exporter = MetricsExporter()
        exporter.add_pipeline(pipe, history=history)
        server = exporter.serve(port=9100)        # standalone
        ShardHTTPServer(root, metrics=exporter)   # or ride the shard server
    """

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._collectors: list[Callable[[], Iterable[str]]] = []

    def add_collector(self, fn: Callable[[], Iterable[str]]) -> None:
        """Register a callable returning exposition lines (no trailing \\n)."""
        with self._lock:
            self._collectors.append(fn)

    def add_pipeline(
        self,
        pipeline: Any,
        *,
        name: str = "pipeline",
        history: StatsHistory | None = None,
        window_s: float | None = None,
    ) -> None:
        """Export a pipeline's stage rows (plus window gauges when a
        history is given; the history is sampled on every scrape)."""

        def collect() -> Iterable[str]:
            if history is not None:
                history.sample()
                window = history.window(window_s)
            else:
                window = None
            return stage_metrics_lines(
                pipeline.stats(),
                namespace=self.namespace,
                pipeline=name,
                window=window,
            )

        self.add_collector(collect)

    def add_resource_sampler(self, sampler: Any) -> None:
        """Export process CPU seconds and RSS from a ``ResourceSampler``
        (its latest background sample, or a fresh /proc read)."""

        def collect() -> Iterable[str]:
            cpu_s, rss = sampler.current()
            f = _Families()
            f.add(f"{self.namespace}_process_cpu_seconds_total", "counter",
                  "Process CPU time (user+sys).", cpu_s)
            f.add(f"{self.namespace}_process_rss_bytes", "gauge",
                  "Process resident set size.", rss)
            return f.render().splitlines()

        self.add_collector(collect)

    def add_fleet(
        self,
        *,
        peers: Any = None,
        registry: Any = None,
        admission: Any = None,
        prefetcher: Any = None,
        name: str = "fleet",
    ) -> None:
        """Export the elastic-shard-fleet gauges: ``peers_live`` /
        ``peers_suspect`` (from the ``registry`` — authoritative — or the
        consumer-side ``peers`` breaker view), ``ring_remaps_total`` and
        ``admission_rejections_total``, and the prefetcher's
        ``warm_restart_bytes_reused_total``.  Pass whichever components
        this process actually hosts; absent ones export nothing."""

        def collect() -> Iterable[str]:
            f = _Families()
            p = self.namespace
            lb = {"fleet": name}
            live = suspect = None
            if registry is not None:
                rs = registry.stats()
                live, suspect = rs["peers_live"], rs["peers_suspect"]
            ps = peers.stats() if peers is not None else {}
            if live is None:
                live = ps.get("peers_live")
                suspect = ps.get("peers_suspect")
            if live is not None:
                f.add(f"{p}_fleet_peers_live", "gauge",
                      "Fleet members currently live.", live, **lb)
                f.add(f"{p}_fleet_peers_suspect", "gauge",
                      "Fleet members with missed heartbeats.", suspect, **lb)
            if "ring_remaps" in ps:
                f.add(f"{p}_fleet_ring_remaps_total", "counter",
                      "Consistent-hash arcs remapped by membership changes.",
                      ps["ring_remaps"], **lb)
            if admission is not None:
                f.add(f"{p}_fleet_admission_rejections_total", "counter",
                      "Requests answered 429 by admission control.",
                      admission.stats()["admission_rejections"], **lb)
            if prefetcher is not None:
                f.add(f"{p}_fleet_warm_restart_bytes_reused_total", "counter",
                      "Bytes re-opened from persisted state instead of "
                      "re-fetched.",
                      prefetcher.stats().get("warm_restart_bytes_reused", 0),
                      **lb)
            return f.render().splitlines()

        self.add_collector(collect)

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        lines: list[str] = []
        for fn in collectors:
            try:
                lines.extend(fn())
            except Exception as e:  # noqa: BLE001 - one bad collector must
                # not take down the scrape; surface it as a comment instead
                lines.append(f"# collector error: {_esc(repr(e))}")
        return "\n".join(lines) + "\n" if lines else "\n"

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> "MetricsServer":
        """Start a standalone stdlib HTTP server answering ``GET /metrics``."""
        return MetricsServer(self, host=host, port=port)


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self) -> None:  # noqa: N802 - stdlib naming
        if self.path.split("?", 1)[0] != "/metrics":
            self.send_error(404, "try /metrics")
            return
        body = self.server.exporter.render().encode()  # type: ignore[attr-defined]
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE_LATEST)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:  # pragma: no cover
        pass  # scrapes are frequent; stay quiet


class MetricsServer:
    """A tiny threaded HTTP server exposing one route: ``GET /metrics``."""

    def __init__(self, exporter: MetricsExporter, host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _MetricsHandler)
        self._httpd.daemon_threads = True
        self._httpd.exporter = exporter  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="metrics-http"
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
