"""Real remote shard backends behind the ``RemoteShardSource`` duck type.

The prefetcher (``prefetch.py``) talks to storage through two methods:

``fetch(name) -> bytes``
    Download one whole object.  Required.

``fetch_range(name, start, length) -> bytes``
    Download ``length`` bytes starting at ``start``.  **Optional** — a
    source that provides it unlocks *index-first fetch*: the prefetcher
    pulls a shard's 32-byte header + index region first and can then fetch
    only the sample ranges a sampler window actually needs, instead of
    committing to the whole payload.  Ranges are plain absolute byte
    offsets, so columnar (format v2) projection rides the same method for
    free: a projected fetch issues ranged GETs that land inside the
    requested **column regions** only — no backend changes needed for a
    field-aware read path.

Error contract: ``FileNotFoundError`` means the object does not exist
(never retried); ``SourceUnavailable`` (an ``OSError``) means the attempt
failed in a way that may succeed on retry (5xx, dead socket, timeout).

Backends here:

``HttpShardSource``   real HTTP(S) GETs with ``Range`` header support,
                      per-thread keep-alive connection reuse, and
                      configurable timeouts.  Works against anything that
                      serves files over HTTP — object-store gateways, a
                      CDN, or the test fixture in ``testing.py``.
``RetryingSource``    wraps any source with capped exponential backoff +
                      jitter; its error/retry counters flow through
                      ``ShardPrefetcher.stats()`` into the pipeline
                      dashboard (``source_errors`` / ``source_retries``).

The peer-to-peer shard exchange (``peer.py``: ``PeerShardSource`` reading
other ranks' warm caches, ``TieredSource`` composing peers in front of the
retrying origin) sits behind the same two methods; S3/GCS-native backends
are the next target (see ROADMAP).
"""

from __future__ import annotations

import http.client
import random
import threading
import time
import urllib.parse


class SourceUnavailable(OSError):
    """A fetch failed in a way that may succeed on retry (5xx, dead socket,
    timeout).  Distinct from ``FileNotFoundError``, which is permanent.

    ``retry_after`` carries the server's ``Retry-After`` hint (seconds)
    when one was sent — admission-controlled 429s and load-shedding 503s
    use it to tell clients exactly how long to back off.  ``None`` means
    the server offered no hint and ordinary backoff applies.
    """

    def __init__(self, *args, retry_after: float | None = None):
        super().__init__(*args)
        self.retry_after = retry_after


class RangeNotSupported(Exception):
    """A ranged GET came back as a whole-object ``200`` — the server ignored
    the ``Range`` header and the ENTIRE body crossed the wire.

    Carries that body so the caller can *install* the already-downloaded
    object instead of keeping a slice and discarding the rest (which would
    force the same bytes over the wire again on the next read — the
    prefetcher turns this into a normal whole-shard cache entry, so a
    Range-ignoring origin costs exactly one wire fetch per shard).

    Deliberately not an ``OSError``: nothing failed, a retry would download
    the whole body again, so ``RetryingSource`` must let it propagate.
    """

    def __init__(self, name: str, body: bytes):
        super().__init__(
            f"{name}: server ignored Range ({len(body)}-byte whole body returned)"
        )
        self.name = name
        self.body = body


class HttpShardSource:
    """Fetches shards over HTTP(S) with connection reuse and range reads.

    One keep-alive connection per calling thread (the prefetcher's pool
    threads and demand-fetching reader threads each get their own), reused
    across fetches; a stale keep-alive socket — a server that closed an
    idle connection — is retried once on a fresh connection before the
    error escapes, since that is routine churn, not a real failure.

    ``fetch_range`` sends ``Range: bytes=a-b``.  A server that answers
    ``206 Partial Content`` gives us the true ranged read; a server that
    ignores the header and answers ``200`` moved the whole body over the
    wire — ``fetch_range`` then raises ``RangeNotSupported`` carrying that
    body (so the caller can install it instead of re-downloading) and flips
    ``range_supported`` to False so callers stop issuing ranged reads that
    do not save wire bytes.
    """

    def __init__(
        self,
        root_url: str,
        *,
        timeout: float = 30.0,
        headers: dict[str, str] | None = None,
    ):
        split = urllib.parse.urlsplit(root_url)
        if split.scheme not in ("http", "https"):
            raise ValueError(f"HttpShardSource needs an http(s) URL, got {root_url!r}")
        if not split.hostname:
            raise ValueError(f"no host in URL {root_url!r}")
        self.root_url = root_url.rstrip("/")
        self._scheme = split.scheme
        self._host = split.hostname
        self._port = split.port
        self._base_path = split.path.rstrip("/")
        self.timeout = timeout
        self.headers = dict(headers or {})
        self._local = threading.local()
        self._conns: set = set()  # every connection ever opened, for close()
        self._lock = threading.Lock()
        self.fetches = 0
        self.range_fetches = 0
        self.bytes_fetched = 0
        self.connections = 0
        #: False once a ranged request came back 200 (server ignored Range)
        self.range_supported = True

    # -- connection management ---------------------------------------------
    def _connect(self):
        cls = (
            http.client.HTTPSConnection
            if self._scheme == "https"
            else http.client.HTTPConnection
        )
        conn = cls(self._host, self._port, timeout=self.timeout)
        with self._lock:
            self._conns.add(conn)
            self.connections += 1
        return conn

    def _drop(self, conn) -> None:
        try:
            conn.close()
        except Exception:
            pass
        with self._lock:
            self._conns.discard(conn)
        if getattr(self._local, "conn", None) is conn:
            self._local.conn = None

    def _request(self, name: str, extra_headers: dict[str, str]):
        """One GET on this thread's connection; returns (response, body).

        The body is always fully read here — an HTTP/1.1 connection is only
        reusable once the previous response is drained.
        """
        path = f"{self._base_path}/{urllib.parse.quote(name)}"
        conn = getattr(self._local, "conn", None)
        fresh = conn is None
        if fresh:
            conn = self._local.conn = self._connect()
        for attempt in (0, 1):
            try:
                conn.request("GET", path, headers={**self.headers, **extra_headers})
                resp = conn.getresponse()
                body = resp.read()
                # mid-body disconnect defense: http.client raises
                # IncompleteRead itself when Content-Length is known and the
                # socket dies early, but a read-to-EOF response (no length,
                # Connection: close) or a stale header can still hand back a
                # short body.  Validate explicitly — a truncated payload
                # must surface HERE as a retryable transport error, not
                # install short and resurface later as per-sample crc holes
                # far from the cause.
                expect = resp.headers.get("Content-Length")
                if (
                    expect is not None
                    and expect.isdigit()
                    and len(body) != int(expect)
                ):
                    raise http.client.IncompleteRead(body, int(expect) - len(body))
            except (http.client.HTTPException, OSError) as e:
                self._drop(conn)
                # a dead keep-alive socket is routine: one transparent retry
                # on a fresh connection, but only if THIS request reused an
                # old one (a fresh connection failing is a real error)
                if fresh or attempt == 1:
                    raise SourceUnavailable(f"GET {path}: {e}") from e
                fresh = True
                conn = self._local.conn = self._connect()
                continue
            if resp.will_close:
                self._drop(conn)
            return resp, body
        raise AssertionError("unreachable")

    @staticmethod
    def _retry_after(resp) -> float | None:
        """Parse a numeric ``Retry-After`` on throttling responses (429 /
        503); anything unparsable is treated as absent."""
        if resp.status not in (429, 503):
            return None
        raw = resp.headers.get("Retry-After")
        if raw is None:
            return None
        try:
            return max(0.0, float(raw))
        except ValueError:
            return None

    # -- RemoteShardSource protocol ----------------------------------------
    def fetch(self, name: str) -> bytes:
        resp, body = self._request(name, {})
        if resp.status == 404:
            raise FileNotFoundError(f"{self.root_url}/{name}: 404")
        if resp.status != 200:
            raise SourceUnavailable(
                f"{self.root_url}/{name}: HTTP {resp.status} {resp.reason}",
                retry_after=self._retry_after(resp),
            )
        with self._lock:
            self.fetches += 1
            self.bytes_fetched += len(body)
        return body

    def fetch_range(self, name: str, start: int, length: int) -> bytes:
        if start < 0 or length < 0:
            raise ValueError(f"bad range start={start} length={length}")
        if length == 0:
            return b""
        resp, body = self._request(
            name, {"Range": f"bytes={start}-{start + length - 1}"}
        )
        if resp.status == 404:
            raise FileNotFoundError(f"{self.root_url}/{name}: 404")
        if resp.status == 200:
            # server ignored the Range header: the WHOLE body crossed the
            # wire.  Flip range_supported so the prefetcher stops pretending
            # ranged reads are cheap, count the true wire bytes, and hand
            # the body up — the caller installs it rather than re-fetching.
            with self._lock:
                self.range_supported = False
                self.range_fetches += 1
                self.bytes_fetched += len(body)
            raise RangeNotSupported(name, body)
        elif resp.status == 206:
            data = body
        elif resp.status == 416:
            raise ValueError(
                f"{self.root_url}/{name}: range {start}+{length} not satisfiable"
            )
        else:
            raise SourceUnavailable(
                f"{self.root_url}/{name}: HTTP {resp.status} {resp.reason}",
                retry_after=self._retry_after(resp),
            )
        with self._lock:
            self.range_fetches += 1
            self.bytes_fetched += len(body)
        if len(data) != length:
            # shorter than the index promised: the remote object is torn or
            # being overwritten — not something a retry fixes
            raise ValueError(
                f"{self.root_url}/{name}: range {start}+{length} returned "
                f"{len(data)} bytes"
            )
        return data

    # -- visibility / lifecycle --------------------------------------------
    def stats(self) -> dict[str, float]:
        with self._lock:
            return {
                "fetches": self.fetches,
                "range_fetches": self.range_fetches,
                "bytes_fetched": self.bytes_fetched,
                "connections": self.connections,
            }

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, set()
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass


class RetryingSource:
    """Wraps a source with capped exponential backoff + jitter.

    Retryable errors (``SourceUnavailable``, any other ``OSError``,
    timeouts) are retried up to ``max_retries`` times with delay
    ``base_delay_s * 2**attempt`` capped at ``max_delay_s``, each scaled by
    a uniform ``[1, 1+jitter)`` factor so a fleet of loaders hammering a
    recovering server doesn't retry in lockstep.  ``FileNotFoundError`` is
    never retried — a missing object stays missing.

    Counters: ``errors`` is every failed attempt observed (including ones
    later retried into success), ``retries`` is every re-attempt made.
    Both surface in ``ShardPrefetcher.stats()`` as ``source_errors`` /
    ``source_retries`` and from there on the pipeline dashboard.

    ``fetch_range`` is exposed **iff the inner source has it**, so wrapping
    never changes what the prefetcher's protocol sniffing sees.
    ``RangeNotSupported`` is neither an error nor retryable (the body
    already arrived) — it propagates untouched.

    Two admission/deadline knobs (elastic-fleet PR):

    * ``max_elapsed_s`` — a **total** budget per logical call, attempts +
      sleeps included.  A dead origin then fails loudly in bounded time
      instead of silently burning the full retry ladder per fetch: when
      the next backoff sleep would cross the budget, the last error is
      re-raised immediately (counted in ``deadline_exhausted``).
    * a server's ``Retry-After`` hint (``SourceUnavailable.retry_after``,
      set on 429/503) **overrides** exponential backoff when it is
      longer — quota throttling waits exactly as told rather than
      hammering a server that already said when to come back.
    """

    def __init__(
        self,
        inner,
        *,
        max_retries: int = 4,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        jitter: float = 0.5,
        retry_on: tuple = (OSError, TimeoutError, http.client.HTTPException),
        no_retry: tuple = (FileNotFoundError,),
        sleep=time.sleep,
        rng: random.Random | None = None,
        max_elapsed_s: float | None = None,
        clock=time.monotonic,
    ):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if max_elapsed_s is not None and max_elapsed_s <= 0:
            raise ValueError("max_elapsed_s must be > 0 seconds")
        self.inner = inner
        self.max_retries = max_retries
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.retry_on = retry_on
        self.no_retry = no_retry
        self.max_elapsed_s = max_elapsed_s
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.errors = 0
        self.retries = 0
        self.deadline_exhausted = 0  # calls cut short by max_elapsed_s
        self.throttled = 0  # sleeps stretched by a Retry-After hint
        # expose fetch_range only when the inner source supports it, so
        # `hasattr(source, "fetch_range")` keeps answering for the wrapped
        # stack exactly what it would for the bare backend
        if callable(getattr(inner, "fetch_range", None)):
            self.fetch_range = self._fetch_range

    def _call(self, fn, args):
        delay = self.base_delay_s
        t0 = self._clock()
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args)
            except self.no_retry:
                with self._lock:
                    self.errors += 1
                raise
            except self.retry_on as e:
                with self._lock:
                    self.errors += 1
                if attempt == self.max_retries:
                    raise
                sleep_s = min(delay, self.max_delay_s) * (
                    1.0 + self.jitter * self._rng.random()
                )
                hint = getattr(e, "retry_after", None)
                if hint is not None and hint > sleep_s:
                    # the server said exactly when to come back: honor it
                    sleep_s = hint
                    with self._lock:
                        self.throttled += 1
                if (
                    self.max_elapsed_s is not None
                    and (self._clock() - t0) + sleep_s > self.max_elapsed_s
                ):
                    # the budget cannot cover another attempt: fail loudly
                    # NOW instead of sleeping past the deadline
                    with self._lock:
                        self.deadline_exhausted += 1
                    raise
                with self._lock:
                    self.retries += 1
                self._sleep(sleep_s)
                delay *= 2
        raise AssertionError("unreachable")

    def fetch(self, name: str) -> bytes:
        return self._call(self.inner.fetch, (name,))

    def _fetch_range(self, name: str, start: int, length: int) -> bytes:
        return self._call(self.inner.fetch_range, (name, start, length))

    @property
    def range_supported(self) -> bool:
        """Mirrors the inner source's view of whether ranged reads actually
        save wire bytes (True for sources that don't track it)."""
        return bool(getattr(self.inner, "range_supported", True))

    def stats(self) -> dict[str, float]:
        inner_stats = getattr(self.inner, "stats", None)
        out = dict(inner_stats()) if callable(inner_stats) else {}
        with self._lock:
            out["errors"] = self.errors
            out["retries"] = self.retries
            out["deadline_exhausted"] = self.deadline_exhausted
            out["throttled"] = self.throttled
        return out

    def close(self) -> None:
        inner_close = getattr(self.inner, "close", None)
        if callable(inner_close):
            inner_close()
