"""Peer-to-peer shard exchange between data ranks.

At multi-rank scale the object store is the last serialization point: every
rank independently re-downloads the same shards.  This module turns N
independent loaders into one cooperative cache — each rank serves its warm
``ShardPrefetcher`` cache to its peers, and a cache miss consults those
warm peers *before* anyone goes back to the origin.

The composed read path (``ShardDataset(url, peers=[...])`` assembles it)::

    origin (HttpShardSource)        authoritative, slow, retried
      └─ RetryingSource             backoff + jitter on origin flakiness
           └─ TieredSource          try warm peers first, then origin
                ├─ PeerShardSource  round-robin, health-tracked, fast-fail
                └─ (origin stack)
                     └─ ShardPrefetcher   local disk cache + scheduler
                          └─ PeerShardServer   serves THIS rank's cache out

Tier contract per request: the prefetcher's local cache answers first (no
network); on a miss the ``TieredSource`` asks each healthy peer once with a
short fast-fail timeout — a peer answers only from memory/disk it already
holds (whole shards, ranged reads, and resident sparse spans) and replies
with a structured 404 miss (``X-Shard-Miss``) for anything else, so a peer
miss costs one cheap round trip, never a cascading fetch.  Only when every
peer misses or is unhealthy does the request fall through to the retrying
origin.  Peers are an optimization tier: they are never authoritative for
existence (``PeerShardSource`` raises ``PeerMiss``, not
``FileNotFoundError``), and a dead or flaky peer is benched for
``cooldown_s`` and silently bypassed rather than retried.

Pieces:

``PeerShardServer``  HTTP server over a live ``ShardPrefetcher``: whole
                     shards (``200``) from full disk entries, ranged reads
                     (``206``) from full entries *and* resident sparse
                     spans (header/index regions of a sparse entry are
                     re-serialized from its parsed index), structured
                     ``404`` + ``X-Shard-Miss`` for non-resident data.
                     Strictly read-only: lookups go through
                     ``ShardPrefetcher.peek`` — serving a peer never
                     triggers a fetch or perturbs LRU order on this rank.
``PeerShardSource``  client half: a ``RemoteShardSource`` over a list of
                     peer URLs — round-robin start, one attempt per healthy
                     peer per request, failure cooldown, fast-fail timeout.
``TieredSource``     composes ``PeerShardSource`` in front of any origin
                     source; counts ``peer_hits`` / ``peer_bytes`` /
                     ``origin_bytes`` which flow through
                     ``ShardPrefetcher.stats()`` (``source_``-prefixed)
                     into ``StageStatsSnapshot`` and ``format_stats``.

Sparse→full promotion (``prefetch.py``) closes the loop: a sparse entry
that demand-fetches past ``promote_threshold`` upgrades to a whole-shard
disk entry — which this server can then serve whole to every other rank.

Columnar (format v2) shards need no special casing here: ranged reads are
absolute file offsets whatever the format, so a peer running a projected
read asks for **column regions** and this server answers them from full
entries or resident sparse spans exactly as it answers v1 sample ranges —
a rank that only ever fetched the ``image`` column serves those column
spans (plus the re-serialized header/column index) to its peers.

Fleet failure semantics
-----------------------
The elastic-fleet layer (``membership.py``) turns the static peer list
into a live ring.  What each event means, end to end:

=============  =============================================================
Event          Semantics
=============  =============================================================
**join**       A rank registers with the registry (``/fleet/register``) and
               starts heartbeating.  Consumers polling ``/fleet/members``
               add it via ``sync_membership`` — the consistent-hash ring
               remaps only the arcs the newcomer now owns (~1/N of the
               keyspace); every other shard keeps its owner and stays warm.
**leave**      Graceful: ``/fleet/leave`` removes the member, one ring
               rebuild, bounded remap.  Crash: heartbeats stop — after
               ``suspect_after_s`` the registry marks it *suspect* and
               consumers bench it straight into the request-path circuit
               breaker (``mark_suspect``) without burning a request
               timeout; after ``dead_after_s`` it is swept from the view
               and removed from the ring.  A peer already OPEN when the
               suspect verdict arrives is NOT double-benched: its existing
               cooldown stands (``mark_suspect`` never extends
               ``_down_until``).
**restart**    The rank re-registers (same or new URL).  Its prefetcher
               re-opens persisted full shards and sparse spans from the
               warm-restart sidecar (``persist_state=True``) instead of
               re-fetching, so it rejoins the fleet *warm*.  On the
               consumer side a suspect→live transition offers the peer
               exactly ONE half-open probe (``mark_live`` rewinds the
               cooldown; the probe — not the registry — closes the
               circuit).
**quota**      Admission control (``AdmissionController``): an over-quota
               tenant (``X-Tenant``) or an over-capacity server gets a
               structured ``429`` + ``Retry-After``.  ``RetryingSource``
               honors the hint; peers treat a 429 like any transport
               fault (bench + retry elsewhere), so one greedy consumer
               degrades alone instead of collapsing the fleet.
=============  =============================================================

``testing.ShardHTTPServer`` remains the *origin* fixture (serving a shard
directory); this module is the production peer tier grown out of it.
"""

from __future__ import annotations

import http.client
import http.server
import itertools
import json
import re
import threading
import time
import urllib.parse
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait

from ...core import trace as _trace
from ...core.metrics import CONTENT_TYPE_LATEST as _METRICS_CONTENT_TYPE
from .dataset import validate_shard_name
from .format import MappedShardReader
from .membership import TENANT_HEADER, HashRing
from .sources import HttpShardSource, RangeNotSupported, SourceUnavailable

_RANGE_RE = re.compile(r"bytes=(\d+)-(\d+)?$")

#: response header naming why a peer could not serve a request
MISS_HEADER = "X-Shard-Miss"


class PeerMiss(Exception):
    """No peer could serve the request (not resident anywhere, or every
    peer is unhealthy).  The tiered source falls through to the origin on
    this — it never reaches the read path, and it never means the object
    does not exist (only the origin is authoritative for existence)."""


# ---------------------------------------------------------------------------
# serving side
# ---------------------------------------------------------------------------
class _PeerRequestHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: peers reuse connections
    server_version = "ShardPeer/1"

    def setup(self) -> None:
        super().setup()
        with self.server.lock:
            self.server.connections += 1

    def _send(self, status: int, body, extra: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        with self.server.lock:
            self.server.bytes_served += len(body)

    def _miss(self, why: str) -> None:
        """Structured miss: 404 + X-Shard-Miss so a client (or a human with
        curl) can tell 'peer doesn't hold this' apart from a real origin
        404 — and observability can count sparse vs absent misses."""
        with self.server.lock:
            self.server.misses += 1
        self._send(404, why.encode(), {MISS_HEADER: why})

    def _fleet(self, op: str, query: str) -> None:
        """Registry endpoints (``/fleet/*``): JSON control plane riding the
        same port as the data plane.  Kept outside the shard request
        counters — membership chatter must not skew cache hit rates."""
        reg = self.server.registry
        params = dict(urllib.parse.parse_qsl(query))

        def _json(obj, status: int = 200) -> None:
            body = json.dumps(obj).encode()
            self._send(status, body, {"Content-Type": "application/json"})

        if op == "members":
            _json(reg.members())
        elif op == "register":
            pid, url = params.get("id"), params.get("url")
            if not pid or not url:
                _json({"error": "id and url required"}, 400)
                return
            _json(reg.register(pid, url))
        elif op == "heartbeat":
            pid = params.get("id")
            if not pid:
                _json({"error": "id required"}, 400)
                return
            _json({"ok": reg.heartbeat(pid)})
        elif op == "leave":
            pid = params.get("id")
            if not pid:
                _json({"error": "id required"}, 400)
                return
            reg.leave(pid)
            _json({"ok": True})
        else:
            _json({"error": f"unknown fleet op {op!r}"}, 404)

    def _admit(self, nbytes: int) -> bool:
        """Per-tenant quota gate, called just before a body is sent.  False
        means a 429 + Retry-After already went out."""
        adm = self.server.admission
        if adm is None:
            return True
        tenant = self.headers.get(TENANT_HEADER, "default")
        wait = adm.admit(tenant, nbytes)
        if wait is None:
            return True
        self._send(429, b"over quota", {"Retry-After": f"{wait:.3f}"})
        return False

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        srv = self.server
        path, _, query = self.path.partition("?")
        if path == "/metrics" and srv.metrics is not None:
            # mounted observability endpoint: Prometheus text exposition
            # (checked before shard resolution; "/metrics" is reserved)
            body = srv.metrics.render().encode()
            self._send(200, body, {"Content-Type": _METRICS_CONTENT_TYPE})
            return
        if path.startswith("/fleet/") and srv.registry is not None:
            # control plane (reserved like /metrics: validate_shard_name
            # rejects any "/" so no shard can ever shadow these paths)
            self._fleet(path[len("/fleet/") :], query)
            return
        adm = srv.admission
        if adm is not None and not adm.start_request():
            self._send(
                429, b"at capacity", {"Retry-After": f"{adm.retry_wait_s:.3f}"}
            )
            return
        try:
            with srv.lock:
                srv.requests += 1
            name = urllib.parse.unquote(path.lstrip("/"))
            try:
                validate_shard_name(name)
            except ValueError:
                self._miss("bad-name")  # peers only ever serve bare shard names
                return
            reader = srv.prefetcher.peek(name)  # never fetches, no LRU touch
            if reader is None:
                self._miss("absent")
                return
            range_header = self.headers.get("Range")
            try:
                if range_header:
                    self._serve_range(reader, range_header.strip())
                else:
                    self._serve_whole(reader)
            except Exception:
                # reader torn down mid-serve (prefetcher closed, entry evicted
                # and unmapped): a miss, not a 500 — the client has the origin
                self._miss("unavailable")
        finally:
            if adm is not None:
                adm.end_request()

    def _serve_whole(self, reader) -> None:
        if not isinstance(reader, MappedShardReader):
            # sparse entries cannot answer a whole-shard GET (only the
            # origin holds the full payload until promotion lands)
            self._miss("sparse")
            return
        body = reader.raw(0, reader.nbytes)
        if not self._admit(len(body)):
            return
        with self.server.lock:
            self.server.served_whole += 1
        self._send(200, body)

    def _serve_range(self, reader, range_header: str) -> None:
        m = _RANGE_RE.match(range_header)
        if m is None:
            self._miss("bad-range")
            return
        total = (
            reader.nbytes
            if isinstance(reader, MappedShardReader)
            else reader.index.total_bytes
        )
        start = int(m.group(1))
        end = int(m.group(2)) if m.group(2) is not None else total - 1
        if start >= total:
            self._send(416, b"", {"Content-Range": f"bytes */{total}"})
            return
        end = min(end, total - 1)
        length = end - start + 1
        body = reader.raw(start, length)
        if body is None:  # sparse entry: the range is not resident
            self._miss("cold-range")
            return
        if not self._admit(len(body)):
            return
        with self.server.lock:
            self.server.served_ranges += 1
        self._send(206, body, {"Content-Range": f"bytes {start}-{end}/{total}"})

    def log_message(self, *args) -> None:  # quiet: callers read counters
        pass


class PeerShardServer(http.server.ThreadingHTTPServer):
    """Serves a live ``ShardPrefetcher``'s warm cache to peer data ranks.

    Read-only window over the cache: whole shards and ranged reads from
    full disk entries, ranged reads of resident spans (plus re-serialized
    header/index regions) from sparse entries, and a structured
    ``404``/``X-Shard-Miss`` for everything else.  Never triggers a fetch.

    Usage (typically one per rank, next to the rank's prefetcher)::

        server = PeerShardServer(prefetcher).start()   # or: with ... as server:
        ...hand server.url to the other ranks' ``peers=[...]``...
        server.close()

    Counters (under ``lock``, also via ``stats()``): ``requests``,
    ``misses``, ``served_whole``, ``served_ranges``, ``bytes_served``,
    ``connections``.

    Optional fleet hooks:

    * ``registry=`` mounts the ``/fleet/*`` membership endpoints
      (``register``/``heartbeat``/``leave``/``members``) — any one rank's
      server can host the fleet registry alongside its data plane.
    * ``admission=`` gates every shard request through an
      ``AdmissionController`` (max-inflight cap + per-tenant token-bucket
      quotas keyed on the ``X-Tenant`` header) answering structured
      ``429`` + ``Retry-After`` when over.
    """

    daemon_threads = True

    def __init__(
        self,
        prefetcher,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics=None,
        registry=None,
        admission=None,
    ):
        self.prefetcher = prefetcher
        # optional core.metrics.MetricsExporter: mounts GET /metrics on this
        # server (one port serves shards to peers AND telemetry to scrapers)
        self.metrics = metrics
        # optional membership.MembershipRegistry: mounts /fleet/* endpoints
        self.registry = registry
        # optional membership.AdmissionController: quota + inflight gating
        self.admission = admission
        self.lock = threading.Lock()
        self.requests = 0
        self.misses = 0
        self.served_whole = 0
        self.served_ranges = 0
        self.bytes_served = 0
        self.connections = 0
        self._thread: threading.Thread | None = None
        super().__init__((host, port), _PeerRequestHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "PeerShardServer":
        """Serve in a daemon thread; returns self for chaining."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.serve_forever, name="peer-shard-server", daemon=True
            )
            self._thread.start()
        return self

    def stats(self) -> dict[str, int]:
        with self.lock:
            out = {
                "requests": self.requests,
                "misses": self.misses,
                "served_whole": self.served_whole,
                "served_ranges": self.served_ranges,
                "bytes_served": self.bytes_served,
                "connections": self.connections,
            }
        if self.admission is not None:
            out.update(self.admission.stats())
        return out

    def close(self) -> None:
        if self._thread is not None:
            self.shutdown()  # only valid once serve_forever is running
            self._thread.join(timeout=5)
            self._thread = None
        self.server_close()

    def __enter__(self) -> "PeerShardServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------
#: per-peer circuit-breaker states
_CLOSED, _OPEN, _HALF_OPEN = 0, 1, 2


class PeerShardSource:
    """Reads from peer ranks' warm caches: round-robin, health-tracked,
    fast-fail.

    One ``HttpShardSource`` per peer (keep-alive reuse, short ``timeout`` —
    a peer on the same fabric answers in milliseconds or not at all).  Each
    request starts at a rotating peer and tries each *healthy* peer at most
    once: a structured 404 miss moves on to the next peer; a transport
    error trips that peer's circuit breaker.  Exhausting all peers raises
    ``PeerMiss`` — never ``FileNotFoundError``, because peers are not
    authoritative for existence.

    Circuit breaker (per peer): a transport error OPENs the circuit —
    every request skips the peer outright (its timeout must not tax the
    read path).  After ``cooldown_s`` the circuit goes HALF_OPEN: exactly
    ONE request is let through as a probe while everything else keeps
    skipping, so a still-dead peer costs one timeout per cooldown window,
    not one per concurrent fetch.  A probe that completes at the transport
    level (data back, or a structured miss) CLOSEs the circuit; a probe
    that fails re-OPENs it for another ``cooldown_s``.

    Placement: ``placement="round_robin"`` (default) keeps the PR-4
    behaviour — every healthy peer probed in rotating order.
    ``placement="ring"`` routes each request over a consistent-hash ring
    (``HashRing`` with ``vnodes`` points per peer) to the shard's owner
    plus ``replicas`` distinct backups: O(owner+replicas) probes instead
    of O(peers), and a membership change remaps only ~1/N of the
    keyspace.  Ring mode allows an *empty* initial peer list — the
    membership layer (``FleetMember.sync_membership``) grows and shrinks
    the ring live via ``add_peer``/``remove_peer``/``mark_suspect``/
    ``mark_live``.
    """

    def __init__(
        self,
        peer_urls,
        *,
        timeout: float = 2.0,
        cooldown_s: float = 5.0,
        headers: dict[str, str] | None = None,
        clock=time.monotonic,
        placement: str = "round_robin",
        replicas: int = 1,
        vnodes: int = 64,
    ):
        if placement not in ("round_robin", "ring"):
            raise ValueError(f"unknown placement {placement!r}")
        urls = [u.rstrip("/") for u in peer_urls]
        if not urls and placement != "ring":
            raise ValueError("PeerShardSource needs at least one peer URL")
        self._timeout = timeout
        self._headers = headers
        self._sources = [
            HttpShardSource(u, timeout=timeout, headers=headers) for u in urls
        ]
        self.peer_urls = [s.root_url for s in self._sources]
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = [_CLOSED] * len(self._sources)
        self._down_until = [0.0] * len(self._sources)
        self._rr = itertools.count()
        self.placement = placement
        self.replicas = replicas
        self._ring = (
            HashRing(self.peer_urls, vnodes=vnodes) if placement == "ring" else None
        )
        self._urls_index = {u: i for i, u in enumerate(self.peer_urls)}
        self.hits = 0
        self.misses = 0  # requests no peer could serve
        self.errors = 0  # transport failures observed (circuit trips)
        self.probes = 0  # half-open probe requests issued
        self.recoveries = 0  # probes that closed the circuit again
        self.bytes_fetched = 0
        self.suspected = 0  # membership-driven preemptive benchings
        self.ring_remaps = 0  # vnode arcs that changed owner, cumulative
        self.membership_changes = 0

    def _resolve_locked(self, i: int, src) -> int | None:
        """Re-anchor index ``i`` to ``src`` — membership mutations can
        shift the parallel lists between a request capturing an index and
        its outcome landing.  None = the peer was removed mid-request."""
        if 0 <= i < len(self._sources) and self._sources[i] is src:
            return i
        try:
            return self._sources.index(src)
        except ValueError:
            return None

    def _settle(self, i: int, src=None) -> None:
        """Peer ``i`` answered at the transport level: close its circuit
        (a successful probe is a recovery; a closed peer is a no-op)."""
        with self._lock:
            if src is not None:
                j = self._resolve_locked(i, src)
                if j is None:
                    return
                i = j
            recovered = self._state[i] == _HALF_OPEN
            changed = self._state[i] != _CLOSED
            if recovered:
                self.recoveries += 1
            self._state[i] = _CLOSED
            url = self.peer_urls[i]
        if changed:
            tracer = _trace.get_tracer()
            if tracer.enabled:
                tracer.instant(
                    "breaker:close", "peer",
                    {"peer": url, "recovered": recovered},
                )

    def _trip(self, i: int, src=None) -> None:
        """Peer ``i`` failed at the transport level: open its circuit."""
        with self._lock:
            if src is not None:
                j = self._resolve_locked(i, src)
                if j is None:
                    return
                i = j
            self.errors += 1
            self._state[i] = _OPEN
            self._down_until[i] = self._clock() + self.cooldown_s
            url = self.peer_urls[i]
        tracer = _trace.get_tracer()
        if tracer.enabled:
            tracer.instant(
                "breaker:open", "peer",
                {"peer": url, "cooldown_s": self.cooldown_s},
            )

    def _candidates_locked(self, key: str | None) -> list[int]:
        """Probe order for one request: ring owner + replicas when placed,
        rotating full scan otherwise."""
        n = len(self._sources)
        if n == 0:
            return []
        if self._ring is not None and key is not None:
            want = 1 + max(0, self.replicas)
            return [
                self._urls_index[u]
                for u in self._ring.owners(key, want)
                if u in self._urls_index
            ]
        start = next(self._rr) % n
        return [(start + k) % n for k in range(n)]

    def _try_each(self, op, what: str, key: str | None = None) -> bytes:
        with self._lock:
            now = self._clock()
            eligible = []  # (index, source) — identity survives list shifts
            admitted: set[int] = set()  # promoted to half-open, not yet probed
            for i in self._candidates_locked(key):
                state = self._state[i]
                if state == _CLOSED:
                    eligible.append((i, self._sources[i]))
                elif state == _OPEN and self._down_until[i] <= now:
                    # cooldown expired: let exactly THIS request through as
                    # the half-open probe; concurrent requests keep skipping
                    # until the probe settles the circuit one way or the other
                    self._state[i] = _HALF_OPEN
                    admitted.add(i)
                    eligible.append((i, self._sources[i]))
                # _HALF_OPEN (someone else's probe in flight) or a still-
                # cooling _OPEN peer: skip outright, no timeout paid
        try:
            for i, src in eligible:
                if i in admitted:
                    # the probe is actually going out: from here its outcome
                    # (settle or trip) owns the circuit transition
                    admitted.discard(i)
                    with self._lock:
                        self.probes += 1
                    tracer = _trace.get_tracer()
                    if tracer.enabled:
                        tracer.instant(
                            "breaker:probe", "peer", {"peer": src.root_url}
                        )
                try:
                    data = op(src)
                except FileNotFoundError:
                    # structured miss: the transport is fine, the peer just
                    # doesn't hold it — a healthy answer for the breaker
                    self._settle(i, src)
                    continue
                except (
                    SourceUnavailable,
                    OSError,
                    http.client.HTTPException,
                    # ValueError: the peer answered with malformed data — a
                    # short 206 or a 416 from a stale/torn copy under the same
                    # name.  Peers are never authoritative, so that copy must
                    # read as a breaker trip, not crash the read path.
                    ValueError,
                ):
                    # dead/flaky/stale peer: open its circuit so its timeout
                    # stops taxing every fetch; the origin tier covers it
                    self._trip(i, src)
                    continue
                self._settle(i, src)
                with self._lock:
                    self.hits += 1
                    self.bytes_fetched += len(data)
                return data
        finally:
            # An earlier peer served the request before an admitted probe was
            # attempted: hand the half-open slot back to OPEN (down_until is
            # already expired, so the NEXT request re-admits it) — otherwise
            # the peer would sit in HALF_OPEN forever and never recover.
            if admitted:
                with self._lock:
                    for i, src in eligible:
                        if i in admitted:
                            j = self._resolve_locked(i, src)
                            if j is not None and self._state[j] == _HALF_OPEN:
                                self._state[j] = _OPEN
        with self._lock:
            self.misses += 1
        raise PeerMiss(f"no peer could serve {what}")

    # -- membership hooks (driven by membership.FleetMember) ----------------
    def _rebuild_ring_locked(self) -> None:
        self._urls_index = {u: i for i, u in enumerate(self.peer_urls)}
        if self._ring is not None:
            moved = self._ring.rebuild(self.peer_urls)
            self.ring_remaps += moved
            self.membership_changes += 1

    def add_peer(self, url: str) -> bool:
        """Admit a new live peer (no-op if already present)."""
        url = url.rstrip("/")
        src = None
        with self._lock:
            if url in self._urls_index:
                return False
            src = HttpShardSource(url, timeout=self._timeout, headers=self._headers)
            self._sources.append(src)
            self.peer_urls.append(src.root_url)
            self._state.append(_CLOSED)
            self._down_until.append(0.0)
            self._rebuild_ring_locked()
        tracer = _trace.get_tracer()
        if tracer.enabled:
            tracer.instant("fleet:join", "peer", {"peer": url})
        return True

    def remove_peer(self, url: str) -> bool:
        """Drop a departed peer; its ring arcs move to the survivors."""
        url = url.rstrip("/")
        with self._lock:
            i = self._urls_index.get(url)
            if i is None:
                return False
            src = self._sources.pop(i)
            self.peer_urls.pop(i)
            self._state.pop(i)
            self._down_until.pop(i)
            self._rebuild_ring_locked()
        src.close()
        tracer = _trace.get_tracer()
        if tracer.enabled:
            tracer.instant("fleet:leave", "peer", {"peer": url})
        return True

    def mark_suspect(self, url: str) -> None:
        """Membership says this peer missed heartbeats: bench it NOW
        instead of paying a request-time timeout to find out.  A peer
        already OPEN (or probing) keeps its existing cooldown untouched —
        the registry's verdict must never *extend* a request-path bench
        (no double-benching)."""
        url = url.rstrip("/")
        with self._lock:
            i = self._urls_index.get(url)
            if i is None or self._state[i] != _CLOSED:
                return
            self._state[i] = _OPEN
            self._down_until[i] = self._clock() + self.cooldown_s
            self.suspected += 1
        tracer = _trace.get_tracer()
        if tracer.enabled:
            tracer.instant("breaker:suspect", "peer", {"peer": url})

    def mark_live(self, url: str) -> None:
        """Membership says a suspect peer heartbeats again: rewind its
        cooldown so the NEXT request admits exactly one half-open probe.
        Deliberately does NOT force-close the circuit — the data path, not
        the control plane, gets the final say on usability."""
        url = url.rstrip("/")
        with self._lock:
            i = self._urls_index.get(url)
            if i is None or self._state[i] != _OPEN:
                return
            self._down_until[i] = min(self._down_until[i], self._clock())

    def sync_membership(self, live_urls, suspect_urls=()) -> None:
        """Reconcile the peer set with a registry view: add newcomers,
        drop unknowns, bench suspects.  ``live_urls`` is the full member
        list (including suspects); ``suspect_urls`` flags the subset to
        bench preemptively."""
        want = {u.rstrip("/") for u in live_urls}
        with self._lock:
            have = set(self._urls_index)
        for url in want - have:
            self.add_peer(url)
        for url in have - want:
            self.remove_peer(url)
        for url in suspect_urls:
            self.mark_suspect(url)

    def shrink_replication(self) -> None:
        """Graceful-degradation hook (``core.health.shrink_replication``):
        serve from the ring owner only — replica probes are optional work
        worth shedding when the consumer is already behind.  One-way for
        this source's lifetime; a no-op under round-robin placement."""
        with self._lock:
            self.replicas = 0

    # -- RemoteShardSource protocol ----------------------------------------
    def fetch(self, name: str) -> bytes:
        return self._try_each(lambda s: s.fetch(name), name, key=name)

    def fetch_range(self, name: str, start: int, length: int) -> bytes:
        def op(src):
            try:
                return src.fetch_range(name, start, length)
            except RangeNotSupported as e:
                # defensive (a proxy in front of a peer answered 200): the
                # body is in hand, serve the slice — still a peer hit
                return bytes(memoryview(e.body)[start : start + length])

        data = self._try_each(op, f"{name}[{start}:+{length}]", key=name)
        if len(data) != length:
            # a torn peer copy must read as a miss, not corrupt the range
            raise PeerMiss(f"peer returned {len(data)} bytes for {name}+{length}")
        return data

    # -- visibility / lifecycle --------------------------------------------
    def stats(self) -> dict[str, float]:
        with self._lock:
            down = sum(1 for s in self._state if s != _CLOSED)
            return {
                "hits": self.hits,
                "misses": self.misses,
                "errors": self.errors,
                "probes": self.probes,
                "recoveries": self.recoveries,
                "bytes_fetched": self.bytes_fetched,
                "peers": len(self._sources),
                # a peer is down until a half-open probe actually closes its
                # circuit — an expired cooldown alone proves nothing
                "peers_down": down,
                "peers_live": len(self._sources) - down,
                "peers_suspect": down,
                "suspected": self.suspected,
                "ring_remaps": self.ring_remaps,
                "membership_changes": self.membership_changes,
                "replicas": self.replicas,
            }

    def close(self) -> None:
        for src in self._sources:
            src.close()


class TieredSource:
    """Warm peers in front of an origin source — the middle of the
    ``origin → retry → peers → prefetcher`` stack.

    Every ``fetch``/``fetch_range`` first asks ``PeerShardSource`` (cheap,
    fast-fail, may miss) and falls through to ``origin`` (authoritative,
    retried by its own ``RetryingSource`` wrapper) on ``PeerMiss``.  A
    ``RangeNotSupported`` from the origin propagates untouched so the
    prefetcher can install the whole body it carries.

    Hedging (``hedge_after_s``): the circuit breaker handles a peer that
    is *dead*; hedging handles one that is merely *slow* (network brownout,
    GC pause) without waiting out its full fast-fail timeout.  When the
    peer tier has not answered within ``hedge_after_s``, an origin fetch is
    launched *in parallel* and the first success wins — the loser is
    cancelled if it has not started, or its result discarded.  ``None``
    (default) disables hedging and keeps the strictly sequential tiers.

    ``disable_peers()`` is the graceful-degradation hook (see
    ``core.health``): it drops the stack to origin-only — no peer requests,
    no hedging — for when the peer fleet itself is the suspected problem.

    ``fetch_range`` is exposed iff the origin has it (the prefetcher's
    protocol sniffing must see the stack exactly as it would see the bare
    origin); ``range_supported`` mirrors the origin's view.

    Counters — ``peer_hits`` / ``peer_misses`` / ``peer_bytes`` /
    ``origin_fetches`` / ``origin_bytes`` / ``hedges`` / ``hedge_wins`` —
    flow through ``ShardPrefetcher.stats()`` as ``source_peer_hits`` etc.
    into ``StageStatsSnapshot`` and the ``format_stats`` dashboard.
    """

    def __init__(self, origin, peers, *, hedge_after_s: float | None = None):
        self.origin = origin
        self.peers = (
            peers if isinstance(peers, PeerShardSource) else PeerShardSource(peers)
        )
        if hedge_after_s is not None and hedge_after_s <= 0:
            raise ValueError("hedge_after_s must be > 0 seconds")
        self.hedge_after_s = hedge_after_s
        if hedge_after_s is not None:
            # Two pools, not one: on a shared pool the hedged origin fetch
            # queues BEHIND the pending peer lookups whose slowness it is
            # meant to bound, and peer-lookup queueing alone can exceed
            # hedge_after_s (spurious hedges).  Threads are created lazily,
            # so generous caps cost nothing at rest.
            self._peer_ex = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="repro-hedge-peer"
            )
            self._origin_ex = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="repro-hedge-origin"
            )
        else:
            self._peer_ex = None
            self._origin_ex = None
        self._lock = threading.Lock()
        self._peers_disabled = False
        self.peer_hits = 0
        self.peer_misses = 0
        self.peer_bytes = 0
        self.origin_fetches = 0
        self.origin_bytes = 0
        self.hedges = 0  # origin fetches launched because the peer was slow
        self.hedge_wins = 0  # hedged origin fetches that beat the peer
        # mirror the origin's protocol surface exactly (see class docstring)
        if callable(getattr(origin, "fetch_range", None)):
            self.fetch_range = self._fetch_range

    # -- degradation hook ---------------------------------------------------
    def disable_peers(self) -> None:
        """Drop to origin-only (idempotent, one-way for this source's
        lifetime): the health monitor calls this when the pipeline is
        degraded and the peer tier is optional work worth shedding."""
        with self._lock:
            self._peers_disabled = True

    @property
    def peers_disabled(self) -> bool:
        with self._lock:
            return self._peers_disabled

    def shrink_replication(self) -> None:
        """Degradation rung below ``disable_peers``: keep the peer tier but
        serve each shard from its ring owner only (skip replica probes)."""
        self.peers.shrink_replication()

    # -- internals ----------------------------------------------------------
    def _record_peer_win(self, data: bytes) -> None:
        with self._lock:
            self.peer_hits += 1
            self.peer_bytes += len(data)

    def _origin_call(self, call) -> bytes:
        try:
            data = call()
        except RangeNotSupported as e:
            with self._lock:
                self.origin_fetches += 1
                self.origin_bytes += len(e.body)  # the whole body crossed the wire
            raise
        with self._lock:
            self.origin_fetches += 1
            self.origin_bytes += len(data)
        return data

    def _peer_try(self, op) -> bytes | None:
        if self.peers_disabled:
            return None
        try:
            data = op(self.peers)
        except PeerMiss:
            with self._lock:
                self.peer_misses += 1
            return None
        self._record_peer_win(data)
        return data

    def _hedged(self, peer_op, origin_call, what: str) -> bytes:
        """Peer tier with a latency budget: give the peers ``hedge_after_s``
        to answer, then race an origin fetch against them.  First success
        wins; the loser is cancelled (not yet started) or discarded.  The
        budget runs from when the peer lookup actually STARTS executing —
        executor queueing is not peer slowness — but a lookup that cannot
        even start within the budget hedges immediately (a backed-up peer
        pool is as slow as a slow peer from the consumer's seat)."""
        started = threading.Event()
        t_start = [0.0]

        def timed_peer(p):
            t_start[0] = time.monotonic()
            started.set()
            return peer_op(p)

        peer_fut = self._peer_ex.submit(timed_peer, self.peers)
        slow = False
        try:
            if started.wait(self.hedge_after_s):
                budget = t_start[0] + self.hedge_after_s - time.monotonic()
                data = peer_fut.result(timeout=max(0.0, budget))
            else:
                slow = True  # never even started: hedge now
        except PeerMiss:
            with self._lock:
                self.peer_misses += 1
            return self._origin_call(origin_call)
        except FuturesTimeout:
            slow = True  # slow peer: hedge (below)
        except Exception:
            # the peer tier never raises anything else by contract; treat a
            # surprise as a miss — the origin is authoritative anyway
            with self._lock:
                self.peer_misses += 1
            return self._origin_call(origin_call)
        if not slow:
            self._record_peer_win(data)
            return data
        with self._lock:
            self.hedges += 1
        tracer = _trace.get_tracer()
        if tracer.enabled:
            tracer.instant(
                "hedge:start", "peer",
                {"what": what, "after_s": self.hedge_after_s},
            )
        origin_fut = self._origin_ex.submit(self._origin_call, origin_call)
        pending = {peer_fut, origin_fut}
        origin_exc: BaseException | None = None
        while pending:
            done, pending = futures_wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                try:
                    data = f.result()
                except RangeNotSupported:
                    # only the origin raises this, and it carries the whole
                    # body — a win; the slow peer's eventual result is moot
                    peer_fut.cancel()
                    with self._lock:
                        self.hedge_wins += 1
                    if tracer.enabled:
                        tracer.instant(
                            "hedge:win", "peer", {"what": what, "winner": "origin"}
                        )
                    raise
                except BaseException as e:  # noqa: BLE001 - collected below
                    if f is origin_fut:
                        origin_exc = e
                    else:
                        with self._lock:
                            self.peer_misses += 1
                    continue
                for p in pending:
                    p.cancel()
                if f is peer_fut:
                    self._record_peer_win(data)
                else:
                    with self._lock:
                        self.hedge_wins += 1
                if tracer.enabled:
                    tracer.instant(
                        "hedge:win", "peer",
                        {"what": what,
                         "winner": "peer" if f is peer_fut else "origin"},
                    )
                return data
        # both lanes failed: surface the origin's error (authoritative —
        # a FileNotFoundError here really means the object does not exist)
        assert origin_exc is not None
        raise origin_exc

    # -- RemoteShardSource protocol ----------------------------------------
    def fetch(self, name: str) -> bytes:
        if self._peer_ex is not None and not self.peers_disabled:
            return self._hedged(
                lambda p: p.fetch(name), lambda: self.origin.fetch(name), name
            )
        data = self._peer_try(lambda p: p.fetch(name))
        if data is not None:
            return data
        return self._origin_call(lambda: self.origin.fetch(name))

    def _fetch_range(self, name: str, start: int, length: int) -> bytes:
        if self._peer_ex is not None and not self.peers_disabled:
            return self._hedged(
                lambda p: p.fetch_range(name, start, length),
                lambda: self.origin.fetch_range(name, start, length),
                f"{name}[{start}:+{length}]",
            )
        data = self._peer_try(lambda p: p.fetch_range(name, start, length))
        if data is not None:
            return data
        return self._origin_call(
            lambda: self.origin.fetch_range(name, start, length)
        )

    @property
    def range_supported(self) -> bool:
        return bool(getattr(self.origin, "range_supported", True))

    # -- visibility / lifecycle --------------------------------------------
    def stats(self) -> dict[str, float]:
        origin_stats = getattr(self.origin, "stats", None)
        out = dict(origin_stats()) if callable(origin_stats) else {}
        with self._lock:
            out.update(
                peer_hits=self.peer_hits,
                peer_misses=self.peer_misses,
                peer_bytes=self.peer_bytes,
                origin_fetches=self.origin_fetches,
                origin_bytes=self.origin_bytes,
                hedges=self.hedges,
                hedge_wins=self.hedge_wins,
                peers_disabled=int(self._peers_disabled),
            )
        peer_stats = self.peers.stats()
        out["peer_errors"] = peer_stats.get("errors", 0)
        out["peers_down"] = peer_stats.get("peers_down", 0)
        out["peer_probes"] = peer_stats.get("probes", 0)
        out["peer_recoveries"] = peer_stats.get("recoveries", 0)
        out["peers_live"] = peer_stats.get("peers_live", 0)
        out["peers_suspect"] = peer_stats.get("peers_suspect", 0)
        out["ring_remaps"] = peer_stats.get("ring_remaps", 0)
        return out

    def close(self) -> None:
        for ex in (self._peer_ex, self._origin_ex):
            if ex is not None:
                ex.shutdown(wait=False, cancel_futures=True)
        self.peers.close()
        origin_close = getattr(self.origin, "close", None)
        if callable(origin_close):
            origin_close()
