"""Async shard prefetch + bounded local shard cache over a remote source.

SPDL's pipeline overlaps network, CPU, and GPU *within* a sample stream;
this module applies the same overlap at shard granularity for remote or
high-latency storage: while the decode stages chew on shard *k*, the
prefetcher is already pulling shards *k+1..k+d* into a local byte-budgeted
cache, so the read stage almost never blocks on the network.

Pieces:

``RemoteShardSource``      duck-typed backend: ``fetch(name) -> bytes``
                           plus optional ``fetch_range(name, start, length)``
                           (see ``sources.py`` for the real HTTP backend and
                           the retry/backoff wrapper).
``LocalShardSource``       trivial backend reading files from a directory
                           (also the base other sources usually wrap).
``SimulatedLatencySource`` wraps a source with a per-fetch latency floor +
                           bandwidth cap — a deterministic stand-in for
                           object storage in tests and benchmarks.
``SparseShardReader``      ``ShardReader``-compatible reads over a shard
                           whose index was fetched but whose payload is
                           only partially resident (index-first fetch).
``ShardPrefetcher``        the cache + scheduler: LRU-by-bytes local cache
                           of fetched shard files, fetch dedup (concurrent
                           requests for one shard share one download), and
                           a bounded background fetch pool whose in-flight
                           count is the ``prefetch_depth`` stat.

Index-first fetch
-----------------
When the source supports ``fetch_range`` (``index_first="auto"``), a
scheduled fetch that carries sample hints (``schedule(name, samples=...)``,
fed by the loaders' lookahead window) downloads the shard's 32-byte header
+ index region first and *decides* before committing to the payload: if the
hinted samples cover less than ``sparse_threshold`` of the payload bytes,
only their (coalesced) ranges are fetched and the cache entry is a
``SparseShardReader`` — ``bytes_cached`` counts just the resident bytes,
and a read of an un-fetched sample demand-fetches exactly that range.
Otherwise (or with no hints) the whole shard is fetched to disk as before.

Sparse→full promotion
---------------------
A sparse entry that keeps paying demand round trips was mis-predicted: once
its cumulative *demand-fetched* bytes (reads outside the hinted window, not
background top-ups) cross ``promote_threshold`` of the payload, the
prefetcher schedules ONE whole-shard GET in the background and swaps the
entry for a normal disk cache entry — subsequent reads are mmap slices, and
a ``PeerShardServer`` can then serve the whole shard to other ranks.  The
swap is an install, not a teardown: the displaced sparse reader is never
closed (an in-flight demand read may be holding it), just dropped, and the
``_promoting`` guard makes the upgrade a single fetch no matter how many
demand reads cross the threshold concurrently.

A Range-ignoring origin (a ranged read answered with a whole-shard ``200``,
surfaced by the source as ``RangeNotSupported`` carrying the body) takes
the same install path: the body that already crossed the wire becomes the
disk entry — exactly one wire fetch, never download-slice-discard-refetch.

Projection pushdown (columnar v2 shards)
----------------------------------------
On a columnar shard (format v2, see ``format.py``) the hints can carry a
**field projection** too (``schedule(name, samples=..., fields=("image",))``,
wired from ``ShardDataset(fields=...)``): the index-first decision then
counts only the requested columns' bytes, and the sparse entry coalesces
ranges **per requested column only** — the caption/metadata columns of an
image-only read never cross the wire.  ``bytes_skipped`` accounts the
payload bytes projection avoided fetching (hinted samples' non-requested
columns), and ``fields_requested`` counts the distinct field names hinted
so far; both feed the dashboard.  The per-(field, sample) crc keeps the
corruption contract: a bad cell is a hole in one field of one sample.

Tier composition: with ``peer.TieredSource`` as the source, every fetch
here first consults warm peer ranks and only then the retrying origin —
see ``peer.py`` for the full origin → retry → peers → prefetcher stack.

Security: shard names come from a *remote-controlled* manifest and are
joined to a local cache directory, so every entry point validates them as
a single path component (``validate_shard_name``) — a hostile manifest
containing ``../`` must not escape the cache.

Eviction contract: evicting a shard unlinks its cache file (or drops the
sparse entry's buffers) and drops the reader.  In-flight ``memoryview``
reads stay valid — on Linux the mapping outlives the unlink and the pages
are reclaimed when the last view drops; sparse spans are plain refcounted
``bytes`` — so eviction can never corrupt a sample that is mid-decode.

Stats (``stats()``) feed the pipeline dashboard: ``hits``/``misses`` per
*reader* request (a prefetched shard counts as a hit — that is the point),
``evictions``, ``bytes_cached``, ``prefetch_depth``, cumulative
``fetch_time`` seconds downloading, wire-level ``bytes_fetched`` /
``index_fetches`` / ``range_fetches``, sparse→full ``promotions``, and —
when the source exposes its own ``stats()`` (e.g. ``RetryingSource`` or
``peer.TieredSource``) — every source counter prefixed ``source_``
(``source_errors``, ``source_retries``, ``source_peer_hits``,
``source_origin_bytes``, ...).
"""

from __future__ import annotations

import bisect
import functools
import json
import logging
import os
import pathlib
import random
import struct
import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor

import numpy as np

from ...core import trace as _trace
from .dataset import MANIFEST_NAME, validate_shard_name
from .format import (
    ENTRY_SIZE,
    FORMAT_VERSION_V2,
    HEADER_SIZE,
    INDEX_PREAMBLE_SIZE,
    MappedShardReader,
    ShardCorruption,
    ShardIndex,
    ShardIndexV2,
    ShardReader,
    open_shard_reader,
    parse_index_preamble,
    parse_shard_header,
)
from .sources import RangeNotSupported

logger = logging.getLogger("repro.data.shards")


class LocalShardSource:
    """Reads shard files from a local directory (the trivial backend)."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)

    def fetch(self, name: str) -> bytes:
        return (self.root / name).read_bytes()

    def fetch_range(self, name: str, start: int, length: int) -> bytes:
        with open(self.root / name, "rb") as f:
            f.seek(start)
            return f.read(length)


class SimulatedLatencySource:
    """A ``RemoteShardSource`` with object-storage-shaped costs.

    Each fetch pays ``latency_s`` (request round-trip) plus
    ``nbytes / bandwidth_bps`` (transfer), then returns the inner source's
    bytes.  ``fetches``/``bytes_fetched`` make tests assert exactly how
    often the network was touched.

    ``ranges=True`` additionally exposes ``fetch_range`` (passing through
    to the inner source, paying the same per-request latency) so the
    index-first path can be exercised without a real server; the default
    stays range-less so whole-shard fetch counts in existing tests and
    benchmarks are unchanged.

    ``jitter_s`` adds a uniform ``[0, jitter_s)`` random extra delay per
    request, drawn from this source's OWN seeded ``random.Random(seed)`` —
    never the process-global RNG, so latency benchmarks and fault drills
    are reproducible run-to-run regardless of what else consumed random
    numbers (and two sources with the same seed pay identical jitter
    sequences).
    """

    def __init__(
        self,
        inner,
        *,
        latency_s: float = 0.01,
        bandwidth_bps: float | None = None,
        ranges: bool = False,
        jitter_s: float = 0.0,
        seed: int = 0,
    ):
        if jitter_s < 0:
            raise ValueError("jitter_s must be >= 0")
        self.inner = inner
        self.latency_s = latency_s
        self.bandwidth_bps = bandwidth_bps
        self.jitter_s = jitter_s
        self._rng = random.Random(seed)
        self.fetches = 0
        self.range_fetches = 0
        self.bytes_fetched = 0
        self._lock = threading.Lock()
        if ranges and callable(getattr(inner, "fetch_range", None)):
            self.fetch_range = self._fetch_range

    def _pay(self, nbytes: int) -> None:
        delay = self.latency_s
        if self.bandwidth_bps:
            delay += nbytes / self.bandwidth_bps
        if self.jitter_s:
            with self._lock:  # Random isn't thread-safe; draws stay seeded
                delay += self._rng.random() * self.jitter_s
        if delay > 0:
            time.sleep(delay)

    def fetch(self, name: str) -> bytes:
        data = self.inner.fetch(name)
        self._pay(len(data))
        with self._lock:
            self.fetches += 1
            self.bytes_fetched += len(data)
        return data

    def _fetch_range(self, name: str, start: int, length: int) -> bytes:
        data = self.inner.fetch_range(name, start, length)
        self._pay(len(data))
        with self._lock:
            self.range_fetches += 1
            self.bytes_fetched += len(data)
        return data


class SparseShardReader:
    """``ShardReader``-compatible reads over a partially-fetched shard.

    Built by index-first fetch: the header + index came down first (a
    ``ShardIndex``), and payload **spans** — coalesced byte ranges covering
    the hinted samples — arrive via ``fetch_range``.  ``read(i)`` serves
    resident samples as zero-copy ``memoryview`` slices of their span; a
    non-resident sample triggers a demand range fetch of exactly that
    sample.  ``ensure(samples)`` tops up residency in bulk (the background
    path).

    Spans are plain ``bytes`` objects, so dropping the reader (cache
    eviction) never invalidates views already handed out — refcounts keep
    them alive, mirroring the mmap/unlink contract of the on-disk cache.
    Growth is reported to the owning cache through ``_on_grow(delta)`` so
    ``bytes_cached`` tracks partial shards accurately.

    Spans are absolute file offsets, so the machinery is format-agnostic:
    over a columnar (v2) ``ShardIndexV2`` the same reader serves
    ``read_field``/``read_fields``, and a ``fields=`` projection restricts
    which columns a sample's ranges cover — ``ensure``/``missing`` and the
    coalescer then touch only the projected columns' byte ranges.
    """

    def __init__(
        self,
        name: str,
        index: ShardIndex | ShardIndexV2,
        range_fetch,
        *,
        coalesce_gap: int = 1 << 16,
        fields: tuple[str, ...] | None = None,
    ):
        self.name = name
        self.index = index
        self._range_fetch = range_fetch  # (start, length) -> bytes
        self.coalesce_gap = coalesce_gap
        self._names = getattr(index, "field_names", None)  # None ⇒ v1
        if self._names is None:
            if fields is not None:
                raise TypeError(f"{name}: fields= projection needs a columnar index")
            self.fields = None
            self._proj: tuple[str, ...] | None = None
            self._verified = np.zeros(index.n_samples, dtype=bool)  # crc memo
        else:
            # projection resolved once (unknown names raise here, loudly)
            self.fields = tuple(fields) if fields is not None else None
            self._proj = index.resolve_fields(self.fields)
            # per-(field, sample) crc memo, one bitset per column
            self._verified = {
                f: np.zeros(index.n_samples, dtype=bool) for f in self._names
            }
        self._lock = threading.Lock()
        self._starts: list[int] = []  # sorted span start offsets
        self._spans: list[bytes] = []  # parallel span payloads
        self._bytes_held = 0
        self._closed = False
        self._on_grow = None  # installed by the owning ShardPrefetcher
        #: wire bytes pulled by demand ``read()`` misses (NOT hinted ensure
        #: top-ups) — the mis-prediction signal sparse→full promotion watches
        self.demand_bytes = 0

    # -- ShardReader-compatible surface ------------------------------------
    @property
    def n_samples(self) -> int:
        return self.index.n_samples

    def __len__(self) -> int:
        return self.index.n_samples

    @property
    def field_names(self) -> tuple[str, ...] | None:
        """Columnar field names, or None over a v1 index — the same
        dispatch marker the full readers carry."""
        return self._names

    @property
    def offsets(self):
        return self.index.offsets

    @property
    def lengths(self):
        return self.index.lengths

    @property
    def crcs(self):
        return self.index.crcs

    @property
    def nbytes(self) -> int:
        """Bytes actually resident (index + fetched spans) — what this
        entry costs the cache, NOT the full shard size."""
        with self._lock:
            return self.index.index_nbytes + self._bytes_held

    # -- span bookkeeping ---------------------------------------------------
    def _find_locked(self, off: int, ln: int) -> memoryview | None:
        j = bisect.bisect_right(self._starts, off) - 1
        if j >= 0:
            start, span = self._starts[j], self._spans[j]
            if start + len(span) >= off + ln:
                rel = off - start
                return memoryview(span)[rel : rel + ln]
        return None

    def _insert_locked(self, start: int, data: bytes) -> int:
        """Insert a span, keeping the list **nesting-free**: an incoming
        span already covered by a resident one is skipped, and resident
        spans fully inside the incoming one are dropped (their bytes were
        double-held).  Nesting-freedom is what makes the single-candidate
        lookup in ``_find_locked`` exact — without it a short later-start
        span could shadow a longer earlier one and force redundant demand
        fetches.  Returns the net change in resident bytes."""
        end = start + len(data)
        pos = bisect.bisect_left(self._starts, start)
        if pos > 0 and self._starts[pos - 1] + len(self._spans[pos - 1]) >= end:
            return 0  # covered by an earlier-starting span
        removed = 0
        k = pos
        while k < len(self._starts) and self._starts[k] + len(self._spans[k]) <= end:
            removed += len(self._spans[k])
            del self._starts[k]
            del self._spans[k]
        if k < len(self._starts) and self._starts[k] == start:
            # a same-start, longer span survives: it covers the new one
            self._bytes_held -= removed
            return -removed
        self._starts.insert(pos, start)
        self._spans.insert(pos, data)
        self._bytes_held += len(data) - removed
        return len(data) - removed

    def _sample_ranges(self, s: int) -> list[tuple[int, int]]:
        """Absolute (offset, length) byte ranges sample ``s`` occupies —
        one range over a v1 index, one per **projected** column over a
        columnar index (the projection pushdown point: non-requested
        columns contribute no ranges, so they are never fetched)."""
        if self._proj is not None:
            return [self.index.locate(f, s)[:2] for f in self._proj]
        return [(int(self.index.offsets[s]), int(self.index.lengths[s]))]

    def _intervals(self, samples: list[int]) -> list[tuple[int, int]]:
        """Coalesce sample indices into (start, length) fetch runs.

        Adjacent samples are byte-adjacent within a column (and v1 shards
        are one column), so a run of hinted samples becomes one ranged
        request per touched column; gaps up to ``coalesce_gap`` are
        fetched too (one round trip beats two)."""
        ranges: list[tuple[int, int]] = []
        for s in samples:
            ranges.extend(self._sample_ranges(s))
        ranges.sort()
        out: list[list[int]] = []
        for a, ln in ranges:
            b = a + ln
            if out and a - out[-1][1] <= self.coalesce_gap:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b - a) for a, b in out]

    def missing(self, samples) -> list[int]:
        """Hinted samples not yet fully resident under the projection
        (sorted, deduped, in-range)."""
        wanted = sorted({int(s) for s in samples if 0 <= int(s) < self.n_samples})
        with self._lock:
            return [
                s
                for s in wanted
                if any(
                    ln and self._find_locked(off, ln) is None
                    for off, ln in self._sample_ranges(s)
                )
            ]

    def ensure(self, samples) -> int:
        """Fetch any non-resident hinted samples (coalesced); returns bytes
        added.  Used by the background top-up path."""
        gap = self.missing(samples)
        if not gap:
            return 0
        grown = 0
        for start, length in self._intervals(gap):
            data = self._range_fetch(start, length)
            with self._lock:
                if self._closed:
                    break
                grown += self._insert_locked(start, data)
        if grown and self._on_grow is not None:
            self._on_grow(grown)
        return grown

    def _read_range(self, off: int, ln: int) -> memoryview:
        """Resident bytes for ``[off, off+ln)``, demand-fetching exactly
        that range on a miss (the span race/growth bookkeeping both read
        paths share)."""
        if ln == 0:
            return memoryview(b"")
        with self._lock:
            if self._closed:
                raise RuntimeError(f"SparseShardReader({self.name}) is closed")
            view = self._find_locked(off, ln)
        if view is None:
            data = self._range_fetch(off, ln)  # demand: exactly this range
            grown = 0
            with self._lock:
                if self._closed:
                    raise RuntimeError(f"SparseShardReader({self.name}) is closed")
                # demand_bytes counts the wire bytes this miss cost even if
                # a racing read landed the same range first — promotion
                # watches what demand reads actually paid, not residency
                self.demand_bytes += len(data)
                view = self._find_locked(off, ln)  # demand race: keep winner
                if view is None:
                    grown = self._insert_locked(off, data)
                    view = self._find_locked(off, ln)  # nesting-free: found
            if grown and self._on_grow is not None:
                self._on_grow(grown)
        return view

    def read(self, i: int, *, verify: bool = True) -> memoryview:
        if self._names is not None:
            raise TypeError(
                f"{self.name}: columnar sparse entry — read one-blob samples "
                "via read_field/read_fields"
            )
        if not 0 <= i < self.n_samples:
            raise IndexError(f"sample {i} out of range [0, {self.n_samples})")
        off, ln = int(self.index.offsets[i]), int(self.index.lengths[i])
        view = self._read_range(off, ln)
        # crc memo (see ShardReader.read): spans are immutable once resident,
        # so one verification covers every later read; a mismatch is never
        # memoized, keeping the per-sample-hole corruption semantics
        if verify and not self._verified[i]:
            if zlib.crc32(view) != int(self.index.crcs[i]):
                raise ShardCorruption(f"{self.name}: sample {i} failed crc32 check")
            self._verified[i] = True
        return view

    def read_field(self, i: int, field: str, *, verify: bool = True) -> memoryview:
        """Sample ``i``'s ``field`` cell (columnar indexes only), demand-
        fetching exactly that cell's range on a miss."""
        if self._names is None:
            raise TypeError(f"{self.name}: v1 sparse entry has no fields")
        off, ln, crc = self.index.locate(field, i)
        view = self._read_range(off, ln)
        bits = self._verified[field]
        if verify and not bits[i]:
            if zlib.crc32(view) != crc:
                raise ShardCorruption(
                    f"{self.name}: sample {i} field {field!r} failed crc32 check"
                )
            bits[i] = True
        return view

    def read_fields(
        self, i: int, fields=None, *, verify: bool = True
    ) -> dict[str, memoryview]:
        """Projected read over the sparse entry: ``{field: memoryview}``.
        ``fields=None`` means this entry's own projection."""
        if self._names is None:
            raise TypeError(f"{self.name}: v1 sparse entry has no fields")
        if fields is None:
            fields = self.fields
        return {
            f: self.read_field(i, f, verify=verify)
            for f in self.index.resolve_fields(fields)
        }

    def raw(self, start: int, length: int) -> memoryview | None:
        """Resident raw shard bytes ``[start, start+length)`` or ``None``
        (the ``PeerShardServer`` ranged-read path).  The header and index
        regions are re-serialized from the parsed index — a sparse entry
        can always answer the index-first reads a peer's prefetcher issues;
        a payload range is served iff one resident span covers it whole."""
        if start < 0 or length < 0:
            return None
        with self._lock:
            if self._closed:
                return None
            if start + length <= HEADER_SIZE:
                return memoryview(self.index.header_bytes())[start : start + length]
            if start >= self.index.index_off:
                raw = self.index.index_bytes()
                rel = start - self.index.index_off
                if rel + length <= len(raw):
                    return memoryview(raw)[rel : rel + length]
                return None
            return self._find_locked(start, length)

    # -- warm-restart persistence ------------------------------------------
    def spans_snapshot(self) -> list[tuple[int, bytes]]:
        """Consistent ``(start, payload)`` snapshot of the resident spans —
        what the prefetcher's warm-restart sidecar persists.  Spans are
        immutable ``bytes``, so the copy is reference-cheap."""
        with self._lock:
            return list(zip(self._starts, self._spans))

    def restore_spans(self, spans) -> int:
        """Re-insert persisted ``(start, payload)`` spans (a restart's warm
        resume); returns resident bytes added.  Goes through the normal
        nesting-free insert, so overlapping/stale sidecar spans degrade to
        their net coverage instead of double-counting."""
        grown = 0
        with self._lock:
            if self._closed:
                return 0
            for start, data in spans:
                grown += self._insert_locked(int(start), bytes(data))
        if grown and self._on_grow is not None:
            self._on_grow(grown)
        return grown

    def close(self) -> None:
        with self._lock:
            self._closed = True
            # dropping the lists releases our refs; views already handed
            # out keep their span's bytes alive on their own
            self._starts = []
            self._spans = []
            self._bytes_held = 0


#: warm-restart sidecar magic (8 bytes) — versioned like the shard magic
_WARM_MAGIC = b"RPWARM01"
_WARM_DIR = ".warm"
_WARM_MANIFEST = "manifest.json"


class ShardPrefetcher:
    """Bounded local shard cache + background fetch scheduler.

    ``reader(name)`` is the synchronous path the dataset uses: cache hit →
    reader immediately; miss → fetch (joining an in-flight background
    fetch if one exists), install, evict LRU shards past ``max_bytes``.

    ``schedule(name, samples=None)`` is the asynchronous path the loader
    uses: start a background fetch (up to ``max_inflight`` concurrent)
    unless the shard is already cached or being fetched.  ``samples`` is
    the set of shard-local indices the caller's lookahead window wants —
    with an index-first-capable source it drives the sparse-vs-full
    decision (see the module docstring).  Scheduling is advisory —
    dropping a request is always safe because ``reader`` fetches on
    demand.
    """

    def __init__(
        self,
        source,
        cache_dir: str | pathlib.Path,
        *,
        max_bytes: int = 1 << 30,
        max_inflight: int = 2,
        index_first: bool | str = "auto",
        sparse_threshold: float = 0.75,
        promote_threshold: float | None = 0.5,
        coalesce_gap: int = 1 << 16,
        verify_on_install: bool = True,
        persist_state: bool = False,
    ):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.source = source
        self.cache_dir = pathlib.Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        #: warm restart: persist the cache manifest + sparse-span sidecars
        #: under ``cache_dir/.warm`` on close() (crash-safe fsync+rename)
        #: and re-open resident entries on construction instead of
        #: re-fetching them.  Needs a STABLE cache_dir across runs.
        self.persist_state = persist_state
        self._state_dir = self.cache_dir / _WARM_DIR
        self.max_bytes = max_bytes
        self.max_inflight = max_inflight
        has_range = callable(getattr(source, "fetch_range", None))
        if index_first == "auto":
            self.index_first = has_range
        else:
            self.index_first = bool(index_first)
            if self.index_first and not has_range:
                raise ValueError(
                    "index_first=True needs a source with fetch_range "
                    f"({type(source).__name__} has none)"
                )
        self.sparse_threshold = sparse_threshold
        #: crc-verify whole shards once at cache install (coalesced pass on
        #: the fetch thread) so reads skip the per-sample crc.  False for
        #: callers doing their own integrity checking (the URL-mode stack
        #: wires ``ShardDataset(verify_crc=False)`` through to here).
        self.verify_on_install = verify_on_install
        #: sparse→full promotion trigger: demand-fetched bytes as a fraction
        #: of the payload (None disables promotion)
        self.promote_threshold = promote_threshold
        self.coalesce_gap = coalesce_gap
        self._pool = ThreadPoolExecutor(
            max_workers=max_inflight, thread_name_prefix="shard-prefetch"
        )
        self._lock = threading.Lock()
        # name -> (reader, nbytes); insertion order is the LRU order
        self._cached: OrderedDict[str, tuple[ShardReader | SparseShardReader, int]] = (
            OrderedDict()
        )
        self._inflight: dict[str, Future] = {}
        self._indexes: dict[str, ShardIndex] = {}  # tiny: 16 B/sample arrays
        self._ensuring: set[str] = set()  # sparse top-ups in flight
        self._promoting: set[str] = set()  # sparse→full upgrades in flight
        #: cache-path writes running OUTSIDE _inflight/_promoting coverage
        #: (the demand-read RangeNotSupported install); counted because two
        #: demand reads on one shard can overlap
        self._writing: dict[str, int] = {}
        self._bg_inflight = 0  # pool fetches only (demand fetches excluded)
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.promotions = 0
        self.corrupt_samples = 0  # found by install-time verification
        self.bytes_cached = 0
        self.bytes_fetched = 0  # wire bytes: payloads + indexes + ranges
        self.bytes_skipped = 0  # payload bytes projection avoided fetching
        self._fields_requested: set[str] = set()  # distinct projected fields
        self.index_fetches = 0
        self.range_fetches = 0
        self.fetch_time = 0.0
        #: bytes re-opened from a previous run's persisted state instead of
        #: re-fetched (full cache files + sparse sidecar spans)
        self.warm_restart_bytes_reused = 0
        if self.persist_state:
            try:
                self._restore_state()
            except Exception:
                # a damaged warm state must never block a cold start
                logger.warning("warm-restart state unusable; starting cold",
                               exc_info=True)

    # -- manifest -----------------------------------------------------------
    def fetch_manifest(self) -> bytes:
        """The dataset manifest comes over the same wire as the shards."""
        data = self.source.fetch(MANIFEST_NAME)
        with self._lock:
            self.bytes_fetched += len(data)
        return data

    # -- fetch machinery ----------------------------------------------------
    def _range_fetch(self, name: str, start: int, length: int) -> bytes:
        with self._lock:
            # Owner-closed guard: a sparse reader that outlived the cache
            # (evicted, or handed out mid-shutdown) must not demand-fetch
            # into a closed/closing source — that surfaces backend socket
            # errors instead of the documented shutdown error.
            if self._closed:
                raise RuntimeError("ShardPrefetcher is closed")
            entry = self._cached.get(name)
        if entry is not None and isinstance(entry[0], MappedShardReader):
            # A full copy landed since this sparse reader was built
            # (promotion, or a Range-ignoring origin below): serve the range
            # locally — zero wire bytes, so no fetch counters move.
            return bytes(entry[0].raw(start, length))
        tracer = _trace.get_tracer()
        t0 = time.monotonic() if tracer.enabled else 0.0
        try:
            data = self.source.fetch_range(name, start, length)
        except RangeNotSupported as e:
            # the server ignored Range and the whole shard arrived: install
            # it as the disk entry (displacing the sparse one) and serve the
            # requested slice from the body in hand — one wire fetch, not
            # download-slice-discard-refetch
            with self._lock:
                self.range_fetches += 1
                self.bytes_fetched += len(e.body)
                # cover the path write: this runs on a demand reader's
                # thread, outside _inflight/_promoting, so a concurrent
                # eviction's unlink must be told the file is being replaced
                self._writing[name] = self._writing.get(name, 0) + 1
            try:
                reader = self._persist(name, e.body)
            finally:
                with self._lock:
                    left = self._writing[name] - 1
                    if left:
                        self._writing[name] = left
                    else:
                        del self._writing[name]
            self._replace_with_full(name, reader)
            data = bytes(memoryview(e.body)[start : start + length])
        else:
            with self._lock:
                self.range_fetches += 1
                self.bytes_fetched += len(data)
        if tracer.enabled:
            tracer.complete(
                f"range {name}", "shard", t0, time.monotonic() - t0,
                {"start": start, "length": length},
            )
        if len(data) != length:
            raise ShardCorruption(
                f"{name}: range {start}+{length} returned {len(data)} bytes"
            )
        return data

    def _get_index(self, name: str) -> ShardIndex | ShardIndexV2:
        """Header + index region of ``name`` via small ranged reads — two
        for v1 (header, then the fixed-size index), three for columnar v2
        (header, the 16-byte index preamble that says how long the column
        index is, then the rest of it).

        Cached in memory (indexes are tens of bytes/sample — thousands of
        shards fit in a few MB).  Concurrent first fetches of one index may
        duplicate the ~KB download; the setdefault keeps exactly one parse."""
        with self._lock:
            idx = self._indexes.get(name)
        if idx is not None:
            return idx
        header = self.source.fetch_range(name, 0, HEADER_SIZE)
        version, n, index_off, _payload_off = parse_shard_header(header, name)
        if version >= FORMAT_VERSION_V2:
            preamble = self.source.fetch_range(name, index_off, INDEX_PREAMBLE_SIZE)
            index_len, _n_fields = parse_index_preamble(preamble, name)
            rest = (
                self.source.fetch_range(
                    name,
                    index_off + INDEX_PREAMBLE_SIZE,
                    index_len - INDEX_PREAMBLE_SIZE,
                )
                if index_len > INDEX_PREAMBLE_SIZE
                else b""
            )
            index_bytes = preamble + rest
            idx = ShardIndexV2.parse(header, index_bytes, name)
        else:
            index_bytes = self.source.fetch_range(name, index_off, n * ENTRY_SIZE)
            idx = ShardIndex.parse(header, index_bytes, name)
        with self._lock:
            self.index_fetches += 1
            self.bytes_fetched += len(header) + len(index_bytes)
            return self._indexes.setdefault(name, idx)

    def _fetch_full(self, name: str) -> MappedShardReader:
        """Download one whole shard, persist it, open a reader."""
        data = self.source.fetch(name)
        with self._lock:
            self.bytes_fetched += len(data)
        return self._persist(name, data)

    def _persist(self, name: str, data: bytes) -> MappedShardReader:
        """Stage ``data`` durably under the cache dir and open a reader
        (format-version dispatched: v1 → ShardReader, v2 → ShardReaderV2)."""
        path = self.cache_dir / name
        # unique temp per fetch: two racing fetches of one shard must not
        # share a staging file (the loser's replace() would find it gone)
        tmp = path.with_suffix(f"{path.suffix}.{threading.get_ident():x}.part")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            # durable before the atomic rename: a crash right after
            # replace() must not leave a torn-but-magic-valid cache file
            os.fsync(f.fileno())
        tmp.replace(path)
        reader = open_shard_reader(path)
        if self.verify_on_install:
            # Coalesced crc: one whole-payload pass NOW, on this fetch
            # thread (pool worker or demand caller — never the event loop),
            # instead of one crc per sample on the hot read path; per-read
            # verification costs ~2x on cold reads.  Corrupt samples stay
            # unmemoized, so the per-sample-hole contract is untouched.
            # Local (non-prefetcher) datasets keep lazy per-sample verify —
            # their bytes were never on the wire, so the first-touch risk
            # profile is different.
            bad = reader.verify_all()
            if bad:
                # surface transit/origin corruption at the fetch, not one
                # ShardCorruption hole at a time later on the read path
                logger.warning(
                    "shard %s: %d corrupt sample(s) found at cache install",
                    name, bad,
                )
                with self._lock:
                    self.corrupt_samples += bad
        return reader

    def _fetch_entry(
        self, name: str, samples=None, fields=None
    ) -> MappedShardReader | SparseShardReader:
        """Fetch ``name`` honoring the index-first policy (any thread).

        With sample hints and a range-capable source: pull the index first,
        and if the hinted samples cover < ``sparse_threshold`` of the
        payload, fetch only their coalesced ranges (sparse entry).  On a
        columnar shard a ``fields`` projection narrows both the decision
        and the ranges to the requested columns — the avoided column bytes
        are credited to ``bytes_skipped``.  A ``fields`` projection with NO
        sample hints (a demand read through ``ShardDataset(fields=...)``
        whose schedule hint was dropped) still goes index-first with every
        sample wanted: fetching just the projected columns of the whole
        shard beats fetching the whole shard.  Otherwise — no hints, no
        ranges, or the window wants most of the shard anyway — fetch the
        whole shard to disk."""
        tracer = _trace.get_tracer()
        t0 = time.monotonic()
        try:
            # range_supported goes False the moment the source sees a server
            # ignore a Range header — from then on "ranged" reads move whole
            # bodies, so sparse fetch would COST bytes, not save them
            if (
                (samples or fields)
                and self.index_first
                and getattr(self.source, "range_supported", True)
            ):
                try:
                    idx = self._get_index(name)
                except RangeNotSupported as e:
                    # the index ranged read came back as the whole shard:
                    # the fetch is already done — persist the body in hand
                    # (one wire fetch; range_supported is now False, so
                    # later shards skip straight to _fetch_full)
                    with self._lock:
                        self.bytes_fetched += len(e.body)
                    return self._persist(name, e.body)
                if samples:
                    wanted = sorted(
                        {int(s) for s in samples if 0 <= int(s) < idx.n_samples}
                    )
                else:  # fields-only: every sample, projected columns only
                    wanted = list(range(idx.n_samples))
                columnar = hasattr(idx, "samples_nbytes")  # ShardIndexV2
                proj = tuple(fields) if (columnar and fields) else None
                if columnar:
                    # projection-aware cost: only the requested columns'
                    # bytes count (unknown field names raise KeyError here
                    # — a typo'd projection fails the fetch loudly)
                    wanted_bytes = idx.samples_nbytes(wanted, proj)
                else:
                    wanted_bytes = sum(int(idx.lengths[s]) for s in wanted)
                if wanted and wanted_bytes <= self.sparse_threshold * max(
                    idx.payload_bytes, 1
                ):
                    reader = SparseShardReader(
                        name,
                        idx,
                        functools.partial(self._range_fetch, name),
                        coalesce_gap=self.coalesce_gap,
                        fields=proj,
                    )
                    reader.ensure(wanted)
                    if proj:
                        skipped = idx.samples_nbytes(wanted, None) - wanted_bytes
                        if skipped > 0:
                            with self._lock:
                                self.bytes_skipped += skipped
                    return reader
            return self._fetch_full(name)
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self.fetch_time += dt
            if tracer.enabled:
                # one span per shard fetch, on whatever thread ran it
                # (prefetch pool or a demand caller)
                tracer.complete(f"fetch {name}", "shard", t0, dt)

    def _evict_over_budget_locked(self) -> list[str]:
        """LRU-evict past the byte budget; caller holds the lock and must
        pass the result to ``_unlink_evicted`` after releasing it."""
        evicted: list[str] = []
        while self.bytes_cached > self.max_bytes and len(self._cached) > 1:
            old_name, (old_reader, nbytes) = self._cached.popitem(last=False)
            self.bytes_cached -= nbytes
            self.evictions += 1
            evicted.append(old_name)
        return evicted

    def _unlink_evicted(self, evicted: list[str]) -> None:
        for old_name in evicted:
            # Unlink the file but do NOT close the reader: a concurrent
            # ``read`` may hold it (or views into it) right now.  The
            # mapping is dropped by refcount once the last holder lets go,
            # and the disk space returns with it (Linux unlink semantics).
            # Sparse entries have no file — unlink(missing_ok) covers both.
            # Re-check under the lock first: the shard may have been
            # re-fetched since we evicted it, in which case the file on
            # disk is the NEWER copy and belongs to that install (every
            # path write is covered by _inflight — or _promoting for a
            # sparse→full upgrade, or _writing for a demand-read whole-body
            # install — until the written file is safely open, so this
            # check is race-free).
            with self._lock:
                if (
                    old_name in self._cached
                    or old_name in self._inflight
                    or old_name in self._promoting
                    or old_name in self._writing
                ):
                    continue
                (self.cache_dir / old_name).unlink(missing_ok=True)

    def _install(self, name: str, reader) -> None:
        """Insert a fetched shard and evict LRU past the byte budget."""
        evicted: list[str] = []
        with self._lock:
            if name in self._cached:
                reader.close()  # lost an install race: keep the first copy
                return
            if self._closed:
                # Shutdown mid-fetch: don't cache, but leave the reader
                # open — the demand caller may still be about to use it
                # (it is reclaimed by refcount once dropped).
                return
            self._cached[name] = (reader, reader.nbytes)
            self.bytes_cached += reader.nbytes
            if isinstance(reader, SparseShardReader):
                # from here on demand/top-up growth adjusts bytes_cached
                reader._on_grow = functools.partial(self._sparse_grow, name, reader)
            evicted = self._evict_over_budget_locked()
        self._unlink_evicted(evicted)

    def _sparse_grow(self, name: str, reader: SparseShardReader, delta: int) -> None:
        """A sparse entry fetched more payload: keep ``bytes_cached`` honest,
        re-run eviction, and check the sparse→full promotion trigger.
        No-op if the entry was already evicted (the orphaned reader's spans
        are refcount-reclaimed on their own)."""
        evicted: list[str] = []
        with self._lock:
            entry = self._cached.get(name)
            if entry is None or entry[0] is not reader:
                return
            self._cached[name] = (reader, entry[1] + delta)
            self.bytes_cached += delta
            evicted = self._evict_over_budget_locked()
            # Promotion trigger: demand reads (not hinted top-ups) have paid
            # promote_threshold of the payload in round trips — the sparse
            # bet lost, so upgrade via ONE whole-shard GET.  The _promoting
            # guard makes this deterministic under concurrent demand reads:
            # however many cross the threshold at once, exactly one fetch.
            if (
                self.promote_threshold is not None
                and not self._closed
                and name in self._cached  # eviction above may have taken it
                and name not in self._promoting
                and reader.demand_bytes
                >= self.promote_threshold * max(reader.index.payload_bytes, 1)
            ):
                self._promoting.add(name)
                self._bg_inflight += 1
                self._pool.submit(self._promote_task, name, reader)
        self._unlink_evicted(evicted)

    def _replace_with_full(
        self, name: str, reader: MappedShardReader, *, promotion: bool = False
    ) -> None:
        """Install a freshly-persisted full reader over ``name``'s current
        entry (typically its sparse predecessor).  The displaced sparse
        reader is NOT closed — the caller is often one of its in-flight
        demand reads — just dropped; refcounts reclaim its spans."""
        evicted: list[str] = []
        with self._lock:
            if self._closed:
                # shutdown race: don't cache, but leave the reader open for
                # the caller (reclaimed by refcount once dropped)
                return
            entry = self._cached.get(name)
            if entry is not None and isinstance(entry[0], MappedShardReader):
                reader.close()  # lost the race to another full copy
                return
            self.bytes_cached += reader.nbytes - (entry[1] if entry else 0)
            self._cached[name] = (reader, reader.nbytes)
            self._cached.move_to_end(name)  # the shard is hot: refresh LRU
            if promotion:
                self.promotions += 1
            evicted = self._evict_over_budget_locked()
        self._unlink_evicted(evicted)

    def _promote_task(self, name: str, sparse_reader: SparseShardReader) -> None:
        """Sparse→full promotion (pool thread): one whole-shard GET turns a
        demand-chatty sparse entry into a normal disk entry — which a
        ``PeerShardServer`` can then serve whole to other ranks."""
        try:
            with self._lock:
                entry = self._cached.get(name)
                live = (
                    not self._closed
                    and entry is not None
                    and entry[0] is sparse_reader
                )
            if live:
                with _trace.get_tracer().span(f"promote {name}", "shard"):
                    self._replace_with_full(
                        name, self._fetch_full(name), promotion=True
                    )
        except Exception:
            pass  # advisory: the sparse entry keeps serving; demand reads may retrigger
        finally:
            with self._lock:
                self._promoting.discard(name)
                self._bg_inflight -= 1

    def _fetch_and_install(self, name: str, samples=None, fields=None):
        try:
            reader = self._fetch_entry(name, samples, fields)
            self._install(name, reader)
            with self._lock:
                installed = self._cached.get(name)
            # A racing install may have kept a different reader object;
            # always hand back the cached one so there is one live mapping.
            return installed[0] if installed is not None else reader
        finally:
            with self._lock:
                self._inflight.pop(name, None)
                self._bg_inflight -= 1

    def _ensure_task(self, name: str, reader: SparseShardReader, samples) -> None:
        try:
            # projection credit for the top-up: the gap samples' fetch pulls
            # only the projected columns, so the other columns' bytes are
            # skipped wire traffic too (same accounting as the first fetch)
            skipped = 0
            idx = reader.index
            if reader.fields is not None and hasattr(idx, "samples_nbytes"):
                gap = reader.missing(samples)
                if gap:
                    skipped = idx.samples_nbytes(gap, None) - idx.samples_nbytes(
                        gap, reader.fields
                    )
            reader.ensure(samples)
            if skipped > 0:
                with self._lock:
                    self.bytes_skipped += skipped
        except Exception:
            pass  # advisory top-up: demand reads cover whatever is missing
        finally:
            with self._lock:
                self._ensuring.discard(name)
                self._bg_inflight -= 1

    def schedule(self, name: str, samples=None, fields=None) -> bool:
        """Start a background fetch of ``name``; False if dropped (cached,
        already in flight, saturated, or closed).  Saturation counts only
        *background* fetches: a demand fetch runs on its caller's thread,
        so it must not consume a prefetch slot — otherwise a cold-miss
        stall would starve exactly the lookahead meant to prevent the next
        one.

        ``samples`` (shard-local indices the caller will read) feeds the
        index-first sparse/full decision; for an already-cached *sparse*
        entry it instead schedules a background top-up of any hinted
        samples not yet resident.  ``fields`` (columnar shards) projects
        the fetch onto the named columns only."""
        validate_shard_name(name)
        if fields:
            with self._lock:
                self._fields_requested.update(fields)
        with self._lock:
            if self._closed:
                return False
            entry = self._cached.get(name)
            if entry is None:
                if name in self._inflight or self._bg_inflight >= self.max_inflight:
                    return False
                self._bg_inflight += 1
                fut = self._pool.submit(
                    self._fetch_and_install, name, samples, fields
                )
                self._inflight[name] = fut
                return True
            reader = entry[0]
            if (
                not samples
                or not isinstance(reader, SparseShardReader)
                or name in self._ensuring
                or self._bg_inflight >= self.max_inflight
            ):
                return False
        # sparse top-up candidacy: compute missing() OUTSIDE the global lock
        # (it bisects per hinted sample under the reader's own lock — too
        # much work to serialize every concurrent cache hit behind)
        if not reader.missing(samples):
            return False
        with self._lock:
            if (
                self._closed
                or name in self._ensuring
                or self._bg_inflight >= self.max_inflight
            ):
                return False
            self._ensuring.add(name)
            self._bg_inflight += 1
            self._pool.submit(self._ensure_task, name, reader, samples)
        return True

    def reader(
        self, name: str, samples=None, fields=None
    ) -> MappedShardReader | SparseShardReader:
        """Blocking get: the reader for ``name``, fetching on miss.

        Concurrent requests for one shard share a single download: the
        first requester (or an earlier ``schedule``) owns the fetch, later
        ones join its future.  ``samples`` and ``fields`` hints behave as
        in ``schedule`` (they only matter on a miss).
        """
        my_fut: Future | None = None
        if fields:
            with self._lock:
                self._fields_requested.update(fields)
        with self._lock:
            if self._closed:
                raise RuntimeError("ShardPrefetcher is closed")
            entry = self._cached.get(name)
            if entry is not None:
                # hit path: no name validation — everything in _cached came
                # through a validated fetch.  Skip the LRU shuffle when the
                # name is already most-recent (the sequential common case).
                if next(reversed(self._cached)) != name:
                    self._cached.move_to_end(name)  # refresh LRU position
                self.hits += 1
                tracer = _trace.get_tracer()
                if tracer.enabled:
                    tracer.instant("cache:hit", "shard", {"shard": name})
                return entry[0]
            validate_shard_name(name)
            self.misses += 1
            tracer = _trace.get_tracer()
            if tracer.enabled:
                tracer.instant("cache:miss", "shard", {"shard": name})
            fut = self._inflight.get(name)
            if fut is None:
                my_fut = self._inflight[name] = Future()
        if my_fut is None:
            try:
                return fut.result()  # join the in-flight fetch
            except CancelledError:
                # close() cancelled the queued background fetch we joined;
                # surface the documented shutdown error, not pool internals
                raise RuntimeError("ShardPrefetcher is closed") from None
        try:
            reader = self._fetch_entry(name, samples, fields)
            self._install(name, reader)
            with self._lock:
                installed = self._cached.get(name)
            result = installed[0] if installed is not None else reader
            my_fut.set_result(result)
            return result
        except BaseException as e:
            my_fut.set_exception(e)
            raise
        finally:
            with self._lock:
                self._inflight.pop(name, None)

    def peek(self, name: str) -> ShardReader | SparseShardReader | None:
        """Non-mutating cache lookup — the ``PeerShardServer`` read path.

        Returns the resident reader or ``None``: no hit/miss accounting, no
        LRU refresh, and **never a fetch** — a peer asking for a shard must
        not make THIS rank download anything on its behalf."""
        with self._lock:
            if self._closed:
                return None
            entry = self._cached.get(name)
            return entry[0] if entry is not None else None

    # -- warm restart --------------------------------------------------------
    # A restarted rank re-fetching shards it already paid for is the
    # ROADMAP carry-over this closes: full entries are already durable
    # cache files (fsync+rename at _persist), so the manifest only has to
    # name them; sparse entries additionally persist their resident spans
    # to a ``.warm/<name>.spans`` sidecar.  Sidecar layout::
    #
    #     RPWARM01 | u32 meta_len | meta JSON | header | index | spans | u32 crc
    #
    # with the crc32 over everything between magic and trailer — a torn
    # sidecar (crash mid-rename is already impossible; crash mid-*write*
    # leaves a .part file we never read) or a hand-damaged one fails the
    # crc and is skipped, never trusted.

    def _write_atomic(self, path: pathlib.Path, data: bytes) -> None:
        """The PR-3 crash-safety pattern: write + fsync a unique temp, then
        atomically rename over the target."""
        tmp = path.with_suffix(f"{path.suffix}.{threading.get_ident():x}.part")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(path)

    @staticmethod
    def _encode_sparse(reader: SparseShardReader) -> bytes | None:
        spans = reader.spans_snapshot()
        try:
            header = bytes(reader.index.header_bytes())
            index_bytes = bytes(reader.index.index_bytes())
        except Exception:
            return None
        meta = {
            "name": reader.name,
            "fields": list(reader.fields) if reader.fields is not None else None,
            "index_len": len(index_bytes),
            "spans": [[int(s), len(d)] for s, d in spans],
        }
        meta_blob = json.dumps(meta).encode()
        parts = [struct.pack("<I", len(meta_blob)), meta_blob, header, index_bytes]
        parts.extend(bytes(d) for _, d in spans)
        payload = b"".join(parts)
        return _WARM_MAGIC + payload + struct.pack("<I", zlib.crc32(payload))

    def _restore_sparse(self, name: str, blob: bytes) -> SparseShardReader:
        if len(blob) < len(_WARM_MAGIC) + 8 or not blob.startswith(_WARM_MAGIC):
            raise ValueError(f"{name}: not a warm-restart sidecar")
        payload = blob[len(_WARM_MAGIC) : -4]
        (crc,) = struct.unpack("<I", blob[-4:])
        if zlib.crc32(payload) != crc:
            raise ValueError(f"{name}: sidecar crc mismatch (torn write?)")
        (meta_len,) = struct.unpack_from("<I", payload, 0)
        off = 4
        meta = json.loads(payload[off : off + meta_len])
        off += meta_len
        if meta.get("name") != name:
            raise ValueError(f"{name}: sidecar names {meta.get('name')!r}")
        header = payload[off : off + HEADER_SIZE]
        off += HEADER_SIZE
        index_len = int(meta["index_len"])
        index_bytes = payload[off : off + index_len]
        off += index_len
        version, _n, _index_off, _payload_off = parse_shard_header(header, name)
        if version >= FORMAT_VERSION_V2:
            idx = ShardIndexV2.parse(header, index_bytes, name)
        else:
            idx = ShardIndex.parse(header, index_bytes, name)
        fields = tuple(meta["fields"]) if meta.get("fields") else None
        reader = SparseShardReader(
            name,
            idx,
            functools.partial(self._range_fetch, name),
            coalesce_gap=self.coalesce_gap,
            fields=fields,
        )
        spans: list[tuple[int, bytes]] = []
        for start, ln in meta.get("spans", ()):
            spans.append((int(start), payload[off : off + int(ln)]))
            off += int(ln)
        if off != len(payload):
            raise ValueError(f"{name}: sidecar length mismatch")
        reader.restore_spans(spans)
        with self._lock:
            self._indexes.setdefault(name, idx)
        return reader

    def save_state(self) -> int:
        """Persist the cache manifest + sparse sidecars under
        ``cache_dir/.warm``; returns the number of entries saved.  Called
        automatically from ``close()`` when ``persist_state=True``; safe to
        call mid-run for checkpoint-style durability."""
        self._state_dir.mkdir(parents=True, exist_ok=True)
        with self._lock:
            snapshot = [(name, r) for name, (r, _) in self._cached.items()]
        entries: list[dict] = []
        kept: set[str] = set()
        for name, reader in snapshot:  # LRU order, oldest first
            if isinstance(reader, MappedShardReader):
                # the cache file IS the durable state; just index it
                if (self.cache_dir / name).exists():
                    entries.append({"name": name, "kind": "full"})
            elif isinstance(reader, SparseShardReader):
                blob = self._encode_sparse(reader)
                if blob is None:
                    continue
                side = self._state_dir / f"{name}.spans"
                self._write_atomic(side, blob)
                kept.add(side.name)
                entries.append({"name": name, "kind": "sparse"})
        manifest = {
            "version": 1,
            "verified": bool(self.verify_on_install),
            "entries": entries,
        }
        self._write_atomic(
            self._state_dir / _WARM_MANIFEST,
            json.dumps(manifest, indent=1).encode(),
        )
        # prune sidecars for entries that no longer exist (evicted/promoted)
        for p in self._state_dir.glob("*.spans"):
            if p.name not in kept:
                p.unlink(missing_ok=True)
        return len(entries)

    def _restore_state(self) -> None:
        """Re-open the previous run's resident entries (constructor path —
        single-threaded, cache empty).  Every entry is best-effort: a
        missing file, torn sidecar, or corrupt shard is skipped and simply
        re-fetched on demand like any cold shard."""
        manifest_path = self._state_dir / _WARM_MANIFEST
        try:
            manifest = json.loads(manifest_path.read_text())
        except (OSError, ValueError):
            return
        if manifest.get("version") != 1:
            return
        prior_verified = bool(manifest.get("verified"))
        reused = 0
        for entry in manifest.get("entries", ()):  # oldest-first keeps LRU
            name, kind = entry.get("name"), entry.get("kind")
            if not name:
                continue
            try:
                validate_shard_name(name)
                if kind == "full":
                    reader = open_shard_reader(self.cache_dir / name)
                    if self.verify_on_install and not prior_verified:
                        bad = reader.verify_all()
                        if bad:
                            logger.warning(
                                "shard %s: %d corrupt sample(s) at warm restart",
                                name, bad,
                            )
                            with self._lock:
                                self.corrupt_samples += bad
                elif kind == "sparse":
                    side = self._state_dir / f"{name}.spans"
                    reader = self._restore_sparse(name, side.read_bytes())
                else:
                    continue
            except Exception:
                continue
            nbytes = reader.nbytes
            self._install(name, reader)
            with self._lock:
                installed = self._cached.get(name)
                if installed is not None and installed[0] is reader:
                    reused += nbytes
        if reused:
            with self._lock:
                self.warm_restart_bytes_reused += reused
            tracer = _trace.get_tracer()
            if tracer.enabled:
                tracer.instant(
                    "cache:warm-restart", "shard", {"bytes_reused": reused}
                )

    # -- visibility / lifecycle --------------------------------------------
    @property
    def prefetch_depth(self) -> int:
        """In-flight *background* fetches (demand fetches excluded — they
        run on their caller's thread, not the prefetch pool)."""
        with self._lock:
            return self._bg_inflight

    def stats(self) -> dict[str, float]:
        with self._lock:
            out = {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes_cached": self.bytes_cached,
                "max_bytes": self.max_bytes,
                "prefetch_depth": self._bg_inflight,
                "fetch_time": self.fetch_time,
                "bytes_fetched": self.bytes_fetched,
                "bytes_skipped": self.bytes_skipped,
                "fields_requested": len(self._fields_requested),
                "index_fetches": self.index_fetches,
                "range_fetches": self.range_fetches,
                "promotions": self.promotions,
                "corrupt_samples": self.corrupt_samples,
                "warm_restart_bytes_reused": self.warm_restart_bytes_reused,
                "sparse_shards": sum(
                    1
                    for r, _ in self._cached.values()
                    if isinstance(r, SparseShardReader)
                ),
            }
        source_stats = getattr(self.source, "stats", None)
        if callable(source_stats):
            for k, v in source_stats().items():
                out[f"source_{k}"] = v
        return out

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # Queued-but-unstarted background fetches are cancelled by the pool
        # shutdown (joiners of a cancelled future get the documented
        # RuntimeError, translated in ``reader``); running ones finish
        # (their install no-ops once closed).  Demand-fetch futures in
        # ``_inflight`` are hand-made and owned by the fetching thread —
        # cancelling them here would make that thread's set_result() blow
        # up with InvalidStateError, so they are left to complete.
        self._pool.shutdown(wait=True, cancel_futures=True)
        if self.persist_state:
            # after the pool drains (cache content settled), before readers
            # close (sparse snapshots need their spans still resident)
            try:
                self.save_state()
            except Exception:
                logger.warning(
                    "failed to persist warm-restart state", exc_info=True
                )
        with self._lock:
            for reader, _ in self._cached.values():
                reader.close()
            self._cached.clear()
            self._indexes.clear()
            self.bytes_cached = 0
        source_close = getattr(self.source, "close", None)
        if callable(source_close):
            source_close()
