"""In-process HTTP shard server: the *origin* fixture behind HTTP-backend
tests, ``benchmarks/bench_shards.py``, and ``examples/imagenet_pipeline.py``
(it serves a shard *directory*, modeling the object store; the production
peer tier that serves a live prefetcher's warm cache grew out of this into
``peer.PeerShardServer``).

Pure stdlib (``http.server``) so the suite needs no extra dependency, but
with the two behaviors a real object-store front end has that
``SimpleHTTPRequestHandler`` lacks:

* ``Range: bytes=a-b`` → ``206 Partial Content`` (the thing index-first
  fetch exists to exploit) — disable with ``support_ranges=False`` to model
  a server that ignores Range and always sends the full body;
* keep-alive (HTTP/1.1 + explicit ``Content-Length``) so connection-reuse
  in ``HttpShardSource`` is actually exercised.

Observability for assertions: ``requests``, ``bytes_served``,
``connections`` counters, and ``fail_next = N`` to answer the next N
requests with 503 (drives the retry/backoff path deterministically).

Chaos faults (the fault-injection layer behind ``benchmarks/bench_faults``
and ``tests/test_faults.py``) — all default off, all settable live:

* ``fail_next = N`` — answer the next N requests with 503 (pre-existing);
* ``flaky_rate = p`` — answer each request with 503 with probability ``p``
  from the server's seeded ``chaos_rng`` (reproducible flakiness);
* ``stall_next = N`` / ``stall_s`` — sleep ``stall_s`` before answering
  the next N requests (a slow/unresponsive server, triggers client
  timeouts and hedging);
* ``truncate_next = N`` — advertise the full ``Content-Length`` but close
  the connection mid-body for the next N requests (the mid-body
  disconnect that must surface as ``SourceUnavailable``, never as a
  short installed payload);
* ``slow_bps = B`` — throttle every body write to ``B`` bytes/second (a
  bandwidth-starved origin or slow peer);
* ``kill()`` — process death: stop accepting AND sever in-flight
  keep-alive connections (``shutdown()`` alone leaves persistent
  connections serviceable, which is a restart, not a crash).

Counters for assertions: ``stalls``, ``truncations``, ``flaky_failures``.

Telemetry: pass ``metrics=`` (a ``core.metrics.MetricsExporter``) to mount
``GET /metrics`` on the same port — Prometheus text scrapes ride the shard
port, and deliberately bypass the request counters and chaos faults so a
scrape never perturbs a test's assertions or consumes a fault budget.

Admission control: pass ``admission=`` (a
``membership.AdmissionController``) to gate requests the way the
production peer tier does — a request over the max-inflight cap, or a
body that would bust its tenant's (``X-Tenant`` header) token-bucket
quota, answers a structured ``429`` + ``Retry-After`` instead of data.
The origin fixture gets this so the admission path can be exercised and
benchmarked without a peer fleet.
"""

from __future__ import annotations

import contextlib
import http.server
import pathlib
import random
import re
import socket
import threading
import time
import urllib.parse

from ...core.metrics import CONTENT_TYPE_LATEST as _METRICS_CONTENT_TYPE
from .membership import TENANT_HEADER

_RANGE_RE = re.compile(r"bytes=(\d+)-(\d+)?$")


class _ShardRequestHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: connection reuse is real
    server_version = "ShardHTTP/1"

    def setup(self) -> None:
        super().setup()
        srv = self.server
        with srv.lock:
            srv.connections += 1

    def _send(self, status: int, body: bytes, extra: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self._write_body(body)
        with self.server.lock:
            self.server.bytes_served += len(body)

    def _write_body(self, body: bytes) -> None:
        bps = self.server.slow_bps
        if not bps or not body:
            self.wfile.write(body)
            return
        # bandwidth throttle: write in slices, sleeping each one's cost
        step = max(1, int(bps * 0.05))  # ~20 writes/second granularity
        for off in range(0, len(body), step):
            piece = body[off : off + step]
            self.wfile.write(piece)
            self.wfile.flush()
            time.sleep(len(piece) / bps)

    def _send_truncated(self, status: int, body: bytes, extra: dict | None) -> None:
        """Mid-body disconnect: advertise the full Content-Length, write
        half the body, then drop the connection — the client's read sees
        an IncompleteRead, never a clean short body."""
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body[: len(body) // 2])
        self.wfile.flush()
        self.close_connection = True
        with contextlib.suppress(OSError):
            self.connection.shutdown(socket.SHUT_RDWR)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        srv = self.server
        if srv.dead:
            # killed server: drop the socket without an HTTP response so
            # reused keep-alive connections see a reset, not a clean 5xx
            self.close_connection = True
            with contextlib.suppress(OSError):
                self.connection.shutdown(socket.SHUT_RDWR)
            return
        # /metrics is reserved (never a shard name) and served outside the
        # chaos/counter path: a scrape must not consume a fault budget
        if self.path.split("?", 1)[0] == "/metrics" and srv.metrics is not None:
            self._send(
                200,
                srv.metrics.render().encode(),
                {"Content-Type": _METRICS_CONTENT_TYPE},
            )
            return
        adm = srv.admission
        if adm is not None and not adm.start_request():
            # over the inflight cap: structured throttle, never a hang
            self._send(
                429, b"at capacity", {"Retry-After": f"{adm.retry_wait_s:.3f}"}
            )
            return
        try:
            self._serve_checked()
        finally:
            if adm is not None:
                adm.end_request()

    def _admit(self, nbytes: int) -> bool:
        """Tenant quota gate just before a body send; False means a 429 +
        Retry-After already went out."""
        adm = self.server.admission
        if adm is None:
            return True
        tenant = self.headers.get(TENANT_HEADER, "default")
        wait = adm.admit(tenant, nbytes)
        if wait is None:
            return True
        self._send(429, b"over quota", {"Retry-After": f"{wait:.3f}"})
        return False

    def _serve_checked(self) -> None:
        srv = self.server
        with srv.lock:
            srv.requests += 1
            fail = srv.fail_next > 0
            if fail:
                srv.fail_next -= 1
            elif srv.flaky_rate > 0 and srv.chaos_rng.random() < srv.flaky_rate:
                fail = True
                srv.flaky_failures += 1
            stall = srv.stall_next > 0
            if stall:
                srv.stall_next -= 1
                srv.stalls += 1
            truncate = srv.truncate_next > 0
            if truncate:
                srv.truncate_next -= 1
                # counted at decision time: the client can see the severed
                # socket before the handler thread runs another line
                srv.truncations += 1
        if stall:
            time.sleep(srv.stall_s)
        if fail:
            self._send(503, b"injected failure")
            return
        # resolve strictly within the served root (the server side of the
        # same traversal defense the shard cache applies to names)
        rel = urllib.parse.unquote(self.path.lstrip("/"))
        path = (srv.root / rel).resolve()
        if srv.root not in path.parents and path != srv.root:
            self._send(404, b"")
            return
        if not path.is_file():
            self._send(404, b"")
            return
        size = path.stat().st_size
        range_header = self.headers.get("Range")
        if range_header and srv.support_ranges:
            m = _RANGE_RE.match(range_header.strip())
            if m:
                start = int(m.group(1))
                end = int(m.group(2)) if m.group(2) is not None else size - 1
                if start >= size:
                    self._send(
                        416, b"", {"Content-Range": f"bytes */{size}"}
                    )
                    return
                end = min(end, size - 1)
                # read the range only: reading the whole object for each
                # range costs a shard's bytes per request
                with path.open("rb") as f:
                    f.seek(start)
                    body = f.read(end + 1 - start)
                extra = {"Content-Range": f"bytes {start}-{end}/{size}"}
                if not self._admit(len(body)):
                    return
                if truncate:
                    self._send_truncated(206, body, extra)
                else:
                    self._send(206, body, extra)
                return
        data = path.read_bytes()
        if not self._admit(len(data)):
            return
        if truncate:
            self._send_truncated(200, data, None)
        else:
            self._send(200, data)

    def log_message(self, *args) -> None:  # quiet: tests read counters
        pass


class ShardHTTPServer(http.server.ThreadingHTTPServer):
    """Serves a shard directory; counters under ``lock`` for assertions."""

    daemon_threads = True

    def __init__(
        self,
        root: str | pathlib.Path,
        *,
        support_ranges: bool = True,
        chaos_seed: int = 0,
        metrics=None,
        admission=None,
    ):
        self.root = pathlib.Path(root).resolve()
        self.support_ranges = support_ranges
        # optional core.metrics.MetricsExporter mounted at GET /metrics
        self.metrics = metrics
        # optional membership.AdmissionController gating every request
        self.admission = admission
        self.lock = threading.Lock()
        self.requests = 0
        self.bytes_served = 0
        self.connections = 0
        self.fail_next = 0
        # chaos faults (all off by default; see module docstring)
        self.chaos_rng = random.Random(chaos_seed)
        self.flaky_rate = 0.0
        self.stall_next = 0
        self.stall_s = 0.5
        self.truncate_next = 0
        self.slow_bps: int | None = None
        self.stalls = 0
        self.truncations = 0
        self.flaky_failures = 0
        self.dead = False
        super().__init__(("127.0.0.1", 0), _ShardRequestHandler)

    def kill(self) -> None:
        """Model peer/origin *death* (not graceful restart): stop accepting
        new connections and make every in-flight keep-alive connection fail
        at the transport level on its next request."""
        self.dead = True
        self.shutdown()
        self.server_close()

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


@contextlib.contextmanager
def serve_shards(
    root: str | pathlib.Path,
    *,
    support_ranges: bool = True,
    chaos_seed: int = 0,
    metrics=None,
    admission=None,
):
    """Context manager: serve ``root`` on a loopback port; yields the server
    (use ``server.url`` as an ``HttpShardSource`` root)."""
    server = ShardHTTPServer(
        root, support_ranges=support_ranges, chaos_seed=chaos_seed,
        metrics=metrics, admission=admission,
    )
    thread = threading.Thread(
        target=server.serve_forever, name="shard-http", daemon=True
    )
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
