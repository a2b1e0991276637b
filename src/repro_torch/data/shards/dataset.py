"""Multi-shard dataset + the ``pack`` migration tool.

A sharded dataset on disk is a directory::

    dataset/
      manifest.json          {"version": 1, "total": N, "shards": [...]}
      shard-00000.rpshard
      shard-00001.rpshard
      ...

Each manifest entry records ``{"name", "n", "bytes"}``; global sample ``i``
lives in the shard whose cumulative-count bucket contains ``i``.

``ShardDataset`` implements the repo-wide dataset protocol
(``read_bytes``/``__getitem__``/``__len__``) so every existing loader and
baseline accepts it unchanged (local mode pickles for the multiprocessing
baselines by reopening its mmaps per process; remote mode refuses to
pickle — construct the prefetcher inside the worker instead) — with the
difference that ``read_bytes``
returns a zero-copy ``memoryview`` of the shard's mmap (the codec consumes
any buffer, and the zero-copy loader path decompresses it straight into a
slab slot: mmap → decode_into → arena, no intermediate copies).

Two access modes:

* local (default): shards are files under ``root``, mmap'd lazily on first
  touch and kept open;
* remote: pass a ``ShardPrefetcher`` (``prefetch.py``) and shards are
  fetched through its bounded local cache — ``read_bytes`` blocks only on a
  cache miss, and loaders overlap upcoming fetches with decode via
  ``prefetcher.schedule``.  Passing an ``http(s)://`` URL as ``root`` is
  shorthand for the standard remote stack: ``HttpShardSource`` (range
  reads, connection reuse) wrapped in ``RetryingSource`` (backoff +
  jitter) behind a ``ShardPrefetcher`` at ``cache_dir``.  Adding
  ``peers=[url, ...]`` (other ranks' ``PeerShardServer`` addresses) slots
  a ``peer.TieredSource`` between retry and cache, so a local miss tries
  the peers' warm caches before the origin — the full stack is
  origin → retry → peers → prefetcher.

Shard names from the manifest are validated (``validate_shard_name``) to a
single bare path component before any cache path is built from them — the
manifest is remote-controlled data in remote mode.

Columnar shards (format v2, see ``format.py``) add **projection**: the
manifest carries ``"format_version": 2`` and a ``"fields"`` schema, a
sample is a dict of named fields, and ``ShardDataset(fields=("image",))``
narrows every layer below — ``read_fields`` returns only the requested
columns, and in remote mode the projection rides the prefetch hints so
sparse fetches pull only the requested columns' byte ranges off the wire.
``read_bytes`` (the one-blob protocol every loader speaks) keeps working
on a v2 dataset whenever exactly one field is in play — the sole schema
field, or a single-field projection — so single-field columnar datasets
drop into existing loaders unchanged; a multi-field dataset with no
projection fails loudly rather than guessing which column you meant.

``pack(dataset, out_dir)`` converts anything with ``read_bytes``/``len`` —
an ``ArrayDataset`` directory in particular — into this layout;
``pack(..., format_version=2, fields=("image",))`` migrates to columnar
shards (sources exposing ``read_fields`` keep all their fields).
"""

from __future__ import annotations

import json
import pathlib
import threading
from typing import Any

import numpy as np

from ..codec import decode_sample, parse_header
from .format import ShardWriter, ShardWriterV2, open_shard_reader

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1


def validate_shard_name(name: str) -> str:
    """Reject shard names that are not a bare, single path component.

    Manifest contents are *remote-controlled data* in remote mode, and the
    prefetcher joins shard names onto a local cache directory — a hostile
    or corrupted manifest containing ``../`` (or an absolute path, or a
    name that hides inside a subdirectory) must never escape it.  Applied
    at manifest parse AND at every cache entry point (defense in depth).
    """
    if (
        not isinstance(name, str)
        or not name
        or name != name.strip()
        or name in (".", "..")
        or any(c in name for c in ("/", "\\", "\0"))
        or name.startswith("~")
    ):
        raise ValueError(
            f"unsafe shard name {name!r}: must be a bare file name "
            "(single path component, no separators)"
        )
    return name


def _is_url(root) -> bool:
    return isinstance(root, str) and root.startswith(("http://", "https://"))


def write_manifest(
    root: pathlib.Path, shards: list[dict], extra: dict | None = None
) -> dict:
    manifest = {
        "version": MANIFEST_VERSION,
        "total": sum(s["n"] for s in shards),
        "shards": shards,
        **(extra or {}),
    }
    (root / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2) + "\n")
    return manifest


class ShardDataset:
    """Map-style dataset over a packed-shard manifest (zero-copy reads).

    ``verify_crc`` controls where integrity checking runs:

    * ``True`` (default): lazily, per sample, on first read — memoized, so
      epoch 2+ is pure pointer math.  The right default for local shards
      whose bytes never crossed a wire.
    * ``"eager"``: one coalesced whole-payload pass per shard when the
      shard is first opened, on the opening thread (a loader's executor
      worker, never the event loop).  Every read afterwards is crc-free
      pointer math — this takes the ~2x per-read crc cost out of the cold
      hot path entirely (the engine bench's chunked-loader row).  Corrupt
      samples are never memoized, so they still raise per sample.
    * ``False``: no verification (caller does its own integrity checking).

    Prefetcher-backed (remote) datasets get eager semantics for free: the
    prefetcher verifies each shard once at cache-install time, on the
    fetching thread (see ``ShardPrefetcher._persist``).
    """

    def __init__(
        self,
        root: str | pathlib.Path,
        *,
        fields: tuple[str, ...] | list[str] | None = None,
        prefetcher: Any | None = None,
        verify_crc: bool | str = True,
        cache_dir: str | pathlib.Path | None = None,
        cache_bytes: int = 1 << 30,
        http_timeout: float = 30.0,
        retries: int = 4,
        peers: list[str] | None = None,
        peer_timeout: float = 2.0,
        fleet: str | None = None,
        persist_cache: bool = False,
    ):
        self._auto_cache_dir: pathlib.Path | None = None
        self._fleet_member = None
        owns_prefetcher = False
        if fleet and peers:
            raise TypeError(
                "fleet= discovers peers from the registry; don't also pass "
                "a static peers= list"
            )
        if (peers or fleet) and prefetcher is not None:
            raise TypeError(
                "peers= belongs to the URL-mode stack; with your own "
                "prefetcher, wrap its source in a peer.TieredSource instead"
            )
        if (peers or fleet) and not _is_url(root):
            raise TypeError("peers= needs an http(s):// root (no origin to tier)")
        if persist_cache and cache_dir is None:
            raise TypeError(
                "persist_cache= needs an explicit cache_dir= (an auto temp "
                "cache is deleted on close, so there is nothing to resume)"
            )
        if prefetcher is None and _is_url(root):
            # remote mode from a bare URL: build the standard source stack —
            # origin HTTP range reads → retry/backoff → (optional) warm-peer
            # tier → the prefetcher's local cache
            # (imports are local: prefetch.py imports this module)
            import tempfile

            from .prefetch import ShardPrefetcher
            from .sources import HttpShardSource, RetryingSource

            if cache_dir is None:
                cache_dir = tempfile.mkdtemp(prefix="repro-shard-cache-")
                self._auto_cache_dir = pathlib.Path(cache_dir)
            source = RetryingSource(
                HttpShardSource(root, timeout=http_timeout),
                max_retries=retries,
            )
            if peers:
                from .peer import PeerShardSource, TieredSource

                source = TieredSource(
                    source, PeerShardSource(peers, timeout=peer_timeout)
                )
            elif fleet:
                # elastic peer tier: membership comes from the registry and
                # shards route by consistent hash, so ranks can join/leave
                # mid-epoch without a config change
                from .membership import FleetMember
                from .peer import PeerShardSource, TieredSource

                ps = PeerShardSource(
                    [], timeout=peer_timeout, placement="ring"
                )
                source = TieredSource(source, ps)
                self._fleet_member = FleetMember(fleet, peers=ps)
            prefetcher = ShardPrefetcher(
                source,
                cache_dir,
                max_bytes=cache_bytes,
                verify_on_install=bool(verify_crc),
                persist_state=persist_cache,
            )
            owns_prefetcher = True
            if self._fleet_member is not None:
                self._fleet_member.start()
        self.root = root if _is_url(root) else pathlib.Path(root)
        self.prefetcher = prefetcher
        self.verify_crc = verify_crc
        try:
            if prefetcher is not None:
                manifest = json.loads(prefetcher.fetch_manifest())
            else:
                manifest_path = self.root / MANIFEST_NAME
                if not manifest_path.is_file():
                    raise FileNotFoundError(
                        f"no shard manifest at {manifest_path} — run "
                        "repro.data.shards.pack() (or python -m repro.data.shards) first"
                    )
                manifest = json.loads(manifest_path.read_text())
            if manifest.get("version", 0) > MANIFEST_VERSION:
                raise ValueError(
                    f"manifest version {manifest['version']} is newer than this reader"
                )
            self.manifest = manifest
            self.shard_names: list[str] = [
                validate_shard_name(s["name"]) for s in manifest["shards"]
            ]
            self.format_version = int(manifest.get("format_version", 1))
            schema = manifest.get("fields")
            self.schema_fields: tuple[str, ...] | None = (
                tuple(schema) if schema else None
            )
            self.fields: tuple[str, ...] | None = None
            if fields is not None:
                names = tuple(fields)
                if not names:
                    raise ValueError("fields= must name at least one field")
                if self.schema_fields is None:
                    raise TypeError(
                        "fields= projection needs a columnar (format v2) "
                        "dataset; this manifest has no field schema — "
                        "migrate with pack(..., format_version=2)"
                    )
                unknown = [f for f in names if f not in self.schema_fields]
                if unknown:
                    raise ValueError(
                        f"unknown fields {unknown} (schema has "
                        f"{list(self.schema_fields)})"
                    )
                self.fields = names
        except BaseException:
            # a stack built here must not leak its thread pool, sockets, or
            # temp cache dir when the manifest turns out to be bad
            if owns_prefetcher:
                if self._fleet_member is not None:
                    self._fleet_member.close()
                    self._fleet_member = None
                prefetcher.close()
                self._cleanup_auto_cache()
            raise
        self.shard_sizes: list[int] = [int(s["n"]) for s in manifest["shards"]]
        self._cum = np.cumsum([0] + self.shard_sizes)
        self._n = int(self._cum[-1])
        self._readers: dict[int, Any] = {}  # local mode, lazily opened
        self._readers_lock = threading.Lock()

    def _cleanup_auto_cache(self) -> None:
        if self._auto_cache_dir is not None:
            import shutil

            shutil.rmtree(self._auto_cache_dir, ignore_errors=True)
            self._auto_cache_dir = None

    # -- topology (consumed by the shard-aware sampler / prefetch wiring) ---
    @property
    def num_shards(self) -> int:
        return len(self.shard_names)

    def shard_of(self, i: int) -> int:
        """Shard index holding global sample ``i``."""
        if not 0 <= i < self._n:
            raise IndexError(f"sample {i} out of range [0, {self._n})")
        return int(np.searchsorted(self._cum, i, side="right")) - 1

    def shard_and_offset(self, i: int) -> tuple[int, int]:
        """(shard index, shard-local sample index) of global sample ``i`` —
        the shard-local half is what index-first prefetch hints carry."""
        shard = self.shard_of(i)
        return shard, i - int(self._cum[shard])

    @property
    def sample_meta(self) -> tuple[np.dtype, tuple[int, ...]] | None:
        """(dtype, shape) of sample 0 as recorded by ``pack`` in the
        manifest, or None for manifests predating the field.  Lets loaders
        sniff the sample layout without reading (for remote datasets:
        downloading a whole shard of) actual data.  On a columnar (v2)
        manifest this resolves through the single effective field when the
        projection (or sole schema field) narrows to one — the layout the
        one-blob loader path would actually read."""
        meta = self.manifest.get("sample0")
        if not meta:
            return None
        if "fields" in meta:  # v2 per-field layout
            names = self.fields or self.schema_fields or ()
            if len(names) == 1:
                return self.field_meta(names[0])
            return None
        return np.dtype(meta["dtype"]), tuple(meta["shape"])

    def field_meta(self, field: str) -> tuple[np.dtype, tuple[int, ...]] | None:
        """(dtype, shape) of ``field`` in sample 0 as recorded by a v2
        ``pack``, or None when unrecorded / not a codec blob."""
        meta = self.manifest.get("sample0") or {}
        fm = (meta.get("fields") or {}).get(field)
        if not fm or "dtype" not in fm:
            return None
        return np.dtype(fm["dtype"]), tuple(fm["shape"])

    def _sole_field(self, reader_fields) -> str:
        """The single field a one-blob ``read_bytes`` call maps to on a
        columnar shard — the projection if it names exactly one, else the
        shard's only field; anything wider fails loudly."""
        if self.fields is not None:
            if len(self.fields) == 1:
                return self.fields[0]
            raise TypeError(
                f"read_bytes is one-blob-per-sample but the projection names "
                f"{list(self.fields)}; use read_fields(i) for multi-field reads"
            )
        names = tuple(reader_fields)
        if len(names) == 1:
            return names[0]
        raise TypeError(
            f"read_bytes on a multi-field columnar dataset (fields "
            f"{list(names)}) needs a projection: ShardDataset(fields=(name,)) "
            "or read_fields(i, fields=...)"
        )

    def _reader(self, shard: int):
        if self.prefetcher is not None:
            name = self.shard_names[shard]
            if self.fields is not None:
                # projection rides along so sparse fetches pull only the
                # requested columns' ranges
                return self.prefetcher.reader(name, fields=self.fields)
            return self.prefetcher.reader(name)
        r = self._readers.get(shard)
        if r is None:
            # Open (and eagerly verify) OUTSIDE the lock: concurrent read
            # threads opening different shards must not serialize behind one
            # whole-payload crc pass.  The install is double-checked; a
            # losing duplicate is closed (safe — no views were handed out),
            # at worst duplicating one open/verify under a race.
            candidate = open_shard_reader(self.root / self.shard_names[shard])
            if self.verify_crc == "eager":
                # coalesced verification: one whole-payload pass on the
                # opening thread, then reads skip the crc (the per-sample
                # bitset keeps corrupt samples raising)
                candidate.verify_all()
            with self._readers_lock:
                r = self._readers.setdefault(shard, candidate)
            if r is not candidate:
                candidate.close()
        return r

    # -- dataset protocol ---------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def read_bytes(self, i: int) -> memoryview:
        """Zero-copy encoded bytes of sample ``i`` (mmap slice).  On a
        columnar (v2) shard this reads the single effective field — see
        ``_sole_field``."""
        shard = self.shard_of(i)
        local = i - int(self._cum[shard])
        reader = self._reader(shard)
        names = getattr(reader, "field_names", None)  # set ⇒ columnar v2
        if names is not None:
            field = self._sole_field(names)
            return reader.read_field(local, field, verify=bool(self.verify_crc))
        return reader.read(local, verify=self.verify_crc)

    def read_fields(self, i: int, fields=None) -> dict[str, memoryview]:
        """Projected read of sample ``i``: ``{field: zero-copy memoryview}``.
        ``fields=None`` means the dataset's projection (all schema fields if
        none was set).  Columnar (format v2) datasets only."""
        shard = self.shard_of(i)
        local = i - int(self._cum[shard])
        reader = self._reader(shard)
        if getattr(reader, "field_names", None) is None:
            raise TypeError(
                "read_fields needs a columnar (format v2) dataset — "
                "migrate with pack(..., format_version=2)"
            )
        if fields is None:
            fields = self.fields
        return reader.read_fields(local, fields, verify=bool(self.verify_crc))

    def read_bytes_many(self, indices) -> list[memoryview]:
        """Bulk ``read_bytes``: one vectorized index→shard resolution for
        the whole batch (one ``searchsorted`` call instead of one per
        sample) and one reader lookup per shard *run* — the shard-aware
        sampler makes runs the common case.  Built for chunked read stages
        (``pipe(read_many, chunk=N, vectorized=True)``); out-of-range
        indices raise for the whole call."""
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= self._n):
            raise IndexError(f"sample index out of range [0, {self._n})")
        shards = np.searchsorted(self._cum, idx, side="right") - 1
        locals_ = idx - self._cum[shards]
        verify = self.verify_crc
        out: list[memoryview] = []
        reader = None
        field = None
        cur = -1
        for s, li in zip(shards.tolist(), locals_.tolist()):
            if s != cur:
                reader = self._reader(s)
                names = getattr(reader, "field_names", None)
                field = self._sole_field(names) if names is not None else None
                cur = s
            if field is not None:
                out.append(reader.read_field(li, field, verify=bool(verify)))
            else:
                out.append(reader.read(li, verify=verify))
        return out

    def __getitem__(self, i: int) -> np.ndarray:
        return decode_sample(self.read_bytes(i))

    def close(self) -> None:
        for r in self._readers.values():
            r.close()
        self._readers.clear()
        if self._fleet_member is not None:
            self._fleet_member.close()
            self._fleet_member = None
        if self.prefetcher is not None:
            self.prefetcher.close()
        # a cache dir we mkdtemp'd is ours to remove — leaving it would
        # leak up to cache_bytes of downloaded shards per dataset
        self._cleanup_auto_cache()

    # -- pickling (multiprocessing baselines fork/spawn the dataset) --------
    def __getstate__(self) -> dict:
        if self.prefetcher is not None:
            raise TypeError(
                "a prefetcher-backed ShardDataset cannot be pickled (the "
                "prefetcher owns threads and mmaps); pickle a local-mode "
                "ShardDataset and construct the prefetcher in the worker"
            )
        state = self.__dict__.copy()
        state["_readers"] = {}  # mmaps/locks are per-process; reopen lazily
        del state["_readers_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._readers = {}
        self._readers_lock = threading.Lock()


def _sniff_meta(blob) -> dict:
    """Per-sample codec metadata for the manifest; samples that are not
    codec blobs record an empty dict."""
    try:
        dtype, shape, _ = parse_header(blob)
        return {"dtype": dtype.name, "shape": list(shape)}
    except Exception:
        return {}


def pack(
    dataset: Any,
    out_dir: str | pathlib.Path,
    *,
    samples_per_shard: int = 1024,
    max_shard_bytes: int | None = None,
    prefix: str = "shard",
    format_version: int = 1,
    fields: tuple[str, ...] | list[str] | None = None,
) -> ShardDataset:
    """Pack any ``read_bytes``/``__len__`` dataset into a sharded directory.

    A shard rolls over at ``samples_per_shard`` samples or (if given)
    ``max_shard_bytes`` of payload, whichever comes first.  Unreadable
    source samples are packed as-is only if ``read_bytes`` succeeds —
    failures propagate (migration should not silently drop data).

    ``format_version=2`` writes columnar shards: a source exposing
    ``read_fields(i)`` (another v2 ``ShardDataset``, or any dict-of-blobs
    provider) keeps all its fields (``fields=`` selects a subset); a plain
    one-blob source packs its payload into a single column named by
    ``fields=("name",)`` (default ``"data"``).  The manifest gains
    ``"format_version"``, the field schema, and per-field ``sample0``
    metadata, so a v1→v2 migration is one ``pack`` call and projection
    works end to end on the result.
    """
    if samples_per_shard < 1:
        raise ValueError("samples_per_shard must be >= 1")
    if format_version not in (1, 2):
        raise ValueError(f"format_version must be 1 or 2, got {format_version}")
    if fields is not None and format_version != 2:
        raise TypeError("fields= only applies to format_version=2 (columnar)")
    columnar = format_version == 2
    # a source provides fields if it has read_fields AND is not itself a
    # one-blob ShardDataset (v1 datasets carry the method but it raises)
    reads_fields = (
        columnar
        and callable(getattr(dataset, "read_fields", None))
        and getattr(dataset, "schema_fields", ...) is not None
    )
    field_names: tuple[str, ...] | None = tuple(fields) if fields else None
    if columnar and not reads_fields and field_names is not None and len(field_names) > 1:
        raise TypeError(
            f"source has no read_fields — its one blob per sample cannot "
            f"split into {list(field_names)}; name at most one field"
        )
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shards: list[dict] = []
    sample0: dict | None = None
    writer: ShardWriter | ShardWriterV2 | None = None

    def roll() -> None:
        nonlocal writer
        if writer is not None and writer.n_samples:
            writer.close()
            shards.append(
                {
                    "name": writer.path.name,
                    "n": writer.n_samples,
                    "bytes": writer.path.stat().st_size,
                }
            )
        writer = None

    try:
        for i in range(len(dataset)):
            if writer is None:
                path = out_dir / f"{prefix}-{len(shards):05d}.rpshard"
                writer = (
                    ShardWriterV2(path, fields=field_names)
                    if columnar
                    else ShardWriter(path)
                )
            if reads_fields:
                sample = {
                    k: bytes(v)
                    for k, v in dataset.read_fields(i, field_names).items()
                }
                if field_names is None:
                    field_names = tuple(sample)
            else:
                data = dataset.read_bytes(i)
                if columnar:
                    if field_names is None:
                        field_names = ("data",)
                    sample = {field_names[0]: data}
            if sample0 is None:
                # record sample 0's layout so loaders can sniff dtype/shape
                # from the manifest alone (a remote dataset would otherwise
                # download a whole shard just to peek at one header)
                if columnar:
                    sample0 = {
                        "fields": {k: _sniff_meta(v) for k, v in sample.items()}
                    }
                else:
                    sample0 = _sniff_meta(data)
            writer.add(sample if columnar else data)
            if writer.n_samples >= samples_per_shard or (
                max_shard_bytes is not None and writer.payload_bytes >= max_shard_bytes
            ):
                roll()
        roll()
    except BaseException:
        # failed migration: abort (never finalize a partial shard) and
        # remove the zero-header file so a retry doesn't find a stray
        if writer is not None:
            writer.abort()
            writer.path.unlink(missing_ok=True)
        raise
    extra: dict = {}
    if columnar:
        extra["format_version"] = 2
        extra["fields"] = list(field_names or ())
    if sample0:
        extra["sample0"] = sample0
    write_manifest(out_dir, shards, extra or None)
    return ShardDataset(out_dir)
