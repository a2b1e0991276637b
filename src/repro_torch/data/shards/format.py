"""Packed shard file format: header + payload + per-sample index.

One shard file holds many encoded samples (codec.py ``RPR1`` blobs, but the
format is payload-agnostic) packed back to back, so a million-sample dataset
becomes a few hundred large files instead of a million tiny ones — one
``mmap`` per shard replaces an ``open()+read()+close()`` syscall triple per
sample, and reads become pointer arithmetic into the page cache.

Two layouts share the magic and the 32-byte header; the header's
``version`` field dispatches between them (``open_shard_reader``).

Format v1 — one opaque blob per sample
--------------------------------------
On-disk layout (little-endian throughout)::

    [ header | payload region | index region ]

    header (32 bytes, fixed):
        magic         8s   b"RPRSHRD1"
        version       u32  1
        n_samples     u32
        index_offset  u64  file offset of the index region
        payload_off   u64  file offset of the payload region (= 32)

    payload: sample blobs packed back to back

    index (n_samples x 16 bytes, written AFTER the payload so the writer
    streams samples without knowing sizes up front):
        offset        u64  absolute file offset of the sample
        length        u32  sample byte length
        crc32         u32  zlib.crc32 of the sample bytes

Format v2 — columnar fields with projection
-------------------------------------------
A sample is a dict of named **fields**; each field's values are stored
contiguously as a **column region**, so a reader that wants only
``{image}`` touches only the image column's byte range — the layout that
makes projection pushdown a ranged read, not a parse-and-discard::

    [ header | column 0 | column 1 | ... | index region ]

    header (32 bytes): as v1, but version = 2; payload_off = 32 and
        index_offset marks the end of the last column.

    column c: field c's per-sample blobs packed back to back, in schema
        order.  A column whose blobs all share one length is a **fixed**
        (vectorized-chunk) column: sample i lives at
        ``col_off + i * item_size`` — no per-sample index lookups, and a
        run of samples is one contiguous slice (``read_field_chunk``).

    index region (starts at index_offset, extends to end of file):
        preamble (16 bytes):
            index_len u64   total index-region bytes (incl. this preamble)
            n_fields  u32
            reserved  u32   0
        field table (n_fields variable-size entries):
            name_len  u8    UTF-8 byte length of the field name
            kind      u8    0 = variable-width, 1 = fixed-width
            item_size u32   fixed: bytes per sample; variable: 0
            col_off   u64   absolute file offset of the column region
            col_len   u64   column region byte length
            arr_off   u64   absolute file offset of the per-sample arrays
            name      ...   UTF-8 field name bytes
        per-sample arrays (one block per column, at its arr_off):
            variable column: n_samples x (off u64, len u32, crc32 u32)
                             — offsets absolute, confined to the column
            fixed column:    n_samples x (crc32 u32)

Parsers reject overlapping or out-of-extent column regions, truncated
index regions, and duplicate/empty field names (``ShardCorruption``) —
the index is remote-controlled data on the prefetch path.

CRC policy (both versions): the crc is computed over the *encoded* bytes
at write time — per sample in v1, per (field, sample) cell in v2 — and
verified on first read by default; a mismatch raises ``ShardCorruption``
for that sample (v1) or that field of that sample (v2) only, so a flipped
bit surfaces as a per-sample hole in the pipeline rather than a dead
shard.  Verification is memoized (a bitset per column): the bytes behind a
shard file never change, so epoch 2+ over a warm cache skips the crc pass
it already paid — a failed check is never memoized, so a corrupt cell
stays a hole on every read.  ``verify_all()`` coalesces the whole check
into one sequential pass that fills the bitsets up front — the shard cache
runs it at install time (on the fetch thread) and
``ShardDataset(verify_crc="eager")`` at mmap-open, taking the ~2x per-read
crc cost off the hot path while keeping the per-sample-hole contract.
Callers doing their own integrity checking pass ``verify=False`` and the
read is pure pointer math.

Versioning: the header magic pins the major layout; ``version`` selects
the minor revision.  Readers reject a magic they don't know and a version
newer than ``MAX_FORMAT_VERSION`` (forward-incompatible), and must keep
reading every older version they ever shipped.  ``ShardReader`` is the v1
reader and fails loudly on a v2 version byte (and vice versa for
``ShardReaderV2``); ``open_shard_reader(path)`` peeks the header and
dispatches, which is how every pre-v2 call site keeps reading v1 shards
byte-identically with zero changes.

Reads return ``memoryview`` slices of the shard's mmap — zero payload
copies; the view stays valid for the life of the mapping (the reader keeps
it alive, and on Linux even an unlinked file's mapping stays readable,
which is what lets the local shard cache evict files with reads still in
flight).
"""

from __future__ import annotations

import mmap
import os
import pathlib
import struct
import zlib

import numpy as np

MAGIC = b"RPRSHRD1"
FORMAT_VERSION = 1  # the one-blob-per-sample layout ShardWriter/ShardReader speak
FORMAT_VERSION_V2 = 2  # the columnar layout (ShardWriterV2/ShardReaderV2)
MAX_FORMAT_VERSION = FORMAT_VERSION_V2
_HEADER = struct.Struct("<8sIIQQ")
HEADER_SIZE = _HEADER.size  # 32
_ENTRY = struct.Struct("<QII")
ENTRY_SIZE = _ENTRY.size  # 16
_INDEX_DTYPE = np.dtype([("off", "<u8"), ("len", "<u4"), ("crc", "<u4")])
_CRC_DTYPE = np.dtype("<u4")
# v2 index region: preamble + per-field table entries (name bytes follow)
_INDEX_PREAMBLE = struct.Struct("<QII")  # index_len, n_fields, reserved
INDEX_PREAMBLE_SIZE = _INDEX_PREAMBLE.size  # 16
_FIELD_HEAD = struct.Struct("<BBIQQQ")  # name_len, kind, item_size, col_off, col_len, arr_off
_FIELD_HEAD_SIZE = _FIELD_HEAD.size  # 30
_KIND_VAR, _KIND_FIXED = 0, 1


class ShardCorruption(ValueError):
    """A shard (or one sample inside it) failed an integrity check."""


def parse_shard_header(header: bytes, name: str = "shard") -> tuple[int, int, int, int]:
    """Validate a 32-byte header blob; returns
    ``(version, n_samples, index_offset, payload_offset)``.

    This is the first step of index-first fetch: a 32-byte ranged read
    through here tells a remote reader which format version it is dealing
    with and where the index region lives (and rejects unfinalized /
    foreign files) before any payload moves."""
    if len(header) < HEADER_SIZE:
        raise ShardCorruption(
            f"{name}: header blob is {len(header)} bytes, need {HEADER_SIZE}"
        )
    magic, version, n, index_off, payload_off = _HEADER.unpack_from(header, 0)
    if magic != MAGIC:
        raise ShardCorruption(
            f"{name}: bad magic {bytes(magic)!r} (unfinalized or foreign file)"
        )
    if version > MAX_FORMAT_VERSION:
        raise ShardCorruption(
            f"{name}: shard version {version} is newer than reader {MAX_FORMAT_VERSION}"
        )
    return version, n, index_off, payload_off


def parse_index_preamble(blob: bytes, name: str = "shard") -> tuple[int, int]:
    """Validate the 16-byte v2 index preamble; returns
    ``(index_len, n_fields)``.  A remote reader fetches this after the
    header to learn how many more index bytes to pull."""
    if len(blob) < INDEX_PREAMBLE_SIZE:
        raise ShardCorruption(
            f"{name}: truncated column index: preamble is {len(blob)} bytes, "
            f"need {INDEX_PREAMBLE_SIZE}"
        )
    index_len, n_fields, _reserved = _INDEX_PREAMBLE.unpack_from(blob, 0)
    if index_len < INDEX_PREAMBLE_SIZE:
        raise ShardCorruption(
            f"{name}: corrupt column index: index_len {index_len} below preamble size"
        )
    return index_len, n_fields


class ShardIndex:
    """A v1 shard's parsed header + index, held without its payload.

    This is what **index-first fetch** downloads: the fixed 32-byte header
    (which says where the index lives) and the 16-byte-per-sample index
    region — enough to know every sample's offset, length, and crc32, and
    therefore to fetch any subset of the payload with ranged reads instead
    of committing to the whole shard.
    """

    __slots__ = ("n_samples", "payload_off", "index_off", "offsets", "lengths", "crcs")

    def __init__(self, n_samples, payload_off, index_off, offsets, lengths, crcs):
        self.n_samples = n_samples
        self.payload_off = payload_off
        self.index_off = index_off
        self.offsets = offsets
        self.lengths = lengths
        self.crcs = crcs

    @property
    def total_bytes(self) -> int:
        """Size of the full shard file (header + payload + index)."""
        return self.index_off + self.n_samples * ENTRY_SIZE

    @property
    def payload_bytes(self) -> int:
        return self.index_off - self.payload_off

    @property
    def index_nbytes(self) -> int:
        """Bytes a reader must download to learn the index (header + index)."""
        return HEADER_SIZE + self.n_samples * ENTRY_SIZE

    def header_bytes(self) -> bytes:
        """Re-serialize the 32-byte header.  A sparse cache entry holds only
        the *parsed* index, so this is how a ``PeerShardServer`` answers a
        peer's header ranged read without keeping the original blob."""
        return _HEADER.pack(
            MAGIC, FORMAT_VERSION, self.n_samples, self.index_off, self.payload_off
        )

    def index_bytes(self) -> bytes:
        """Re-serialize the index region (16 B/sample) — the peer-serving
        twin of ``header_bytes``."""
        arr = np.empty(self.n_samples, dtype=_INDEX_DTYPE)
        arr["off"] = self.offsets
        arr["len"] = self.lengths
        arr["crc"] = self.crcs
        return arr.tobytes()

    @classmethod
    def parse(cls, header: bytes, index: bytes, name: str = "shard") -> "ShardIndex":
        """Validate + parse a header blob and its index-region blob.

        Applies the same checks as ``ShardReader.__init__`` (magic, version,
        extents) so a remote shard with a zero placeholder header — a
        crashed writer — is rejected here, before any payload is fetched.
        """
        version, n, index_off, payload_off = parse_shard_header(header, name)
        if version != FORMAT_VERSION:
            raise ShardCorruption(
                f"{name}: format version {version} is not v1 "
                "(columnar v2 indexes parse via ShardIndexV2)"
            )
        if payload_off > index_off:
            raise ShardCorruption(f"{name}: payload region starts past the index")
        if len(index) != n * ENTRY_SIZE:
            raise ShardCorruption(
                f"{name}: index region is {len(index)} bytes, expected {n * ENTRY_SIZE}"
            )
        parsed = np.frombuffer(index, _INDEX_DTYPE, count=n)
        offsets, lengths, crcs = parsed["off"], parsed["len"], parsed["crc"]
        if n and (
            int(offsets.min(initial=payload_off)) < payload_off
            or int((offsets.astype(np.int64) + lengths).max()) > index_off
        ):
            raise ShardCorruption(
                f"{name}: corrupt index: sample extents outside the payload region"
            )
        return cls(n, payload_off, index_off, offsets, lengths, crcs)


class _Column:
    """One parsed v2 column: extent + per-sample arrays (fixed columns
    carry only crcs — offsets are pointer math off ``item_size``)."""

    __slots__ = ("name", "fixed", "item_size", "col_off", "col_len",
                 "offsets", "lengths", "crcs")

    def __init__(self, name, fixed, item_size, col_off, col_len, offsets, lengths, crcs):
        self.name = name
        self.fixed = fixed
        self.item_size = item_size
        self.col_off = col_off
        self.col_len = col_len
        self.offsets = offsets  # None for fixed columns
        self.lengths = lengths  # None for fixed columns
        self.crcs = crcs


class ShardIndexV2:
    """A v2 shard's parsed header + column index, held without its payload.

    The v2 twin of ``ShardIndex``: what index-first fetch downloads before
    deciding which *column ranges* to pull.  Knows every field's column
    extent and every (field, sample) cell's offset/length/crc32, so a
    projection (``fields=...``) turns into ranged reads confined to the
    requested columns — the non-requested columns' bytes never move.
    """

    __slots__ = ("n_samples", "payload_off", "index_off", "index_len",
                 "columns", "field_names", "_header", "_index_raw")

    def __init__(self, n_samples, payload_off, index_off, index_len,
                 columns, header_raw, index_raw):
        self.n_samples = n_samples
        self.payload_off = payload_off
        self.index_off = index_off
        self.index_len = index_len
        self.columns: dict[str, _Column] = columns
        self.field_names: tuple[str, ...] = tuple(columns)
        self._header = header_raw
        self._index_raw = index_raw

    @property
    def total_bytes(self) -> int:
        """Size of the full shard file (header + columns + index)."""
        return self.index_off + self.index_len

    @property
    def payload_bytes(self) -> int:
        return self.index_off - self.payload_off

    @property
    def index_nbytes(self) -> int:
        """Bytes a reader must download to learn the index (header + index)."""
        return HEADER_SIZE + self.index_len

    def header_bytes(self) -> bytes:
        return self._header

    def index_bytes(self) -> bytes:
        """The raw index region, byte-identical to what the writer wrote —
        a sparse cache entry answers peers' index-first ranged reads from
        this without holding any payload."""
        return self._index_raw

    def column(self, field: str) -> _Column:
        col = self.columns.get(field)
        if col is None:
            raise KeyError(
                f"unknown field {field!r} (shard has {list(self.field_names)})"
            )
        return col

    def resolve_fields(self, fields=None) -> tuple[str, ...]:
        """Normalize a projection: ``None`` means every field; unknown
        names raise ``KeyError`` (loudly — a typo'd projection must not
        silently read nothing)."""
        if fields is None:
            return self.field_names
        out = tuple(fields)
        for f in out:
            if f not in self.columns:
                raise KeyError(
                    f"unknown field {f!r} (shard has {list(self.field_names)})"
                )
        return out

    def locate(self, field: str, i: int) -> tuple[int, int, int]:
        """(absolute offset, length, crc32) of sample ``i``'s ``field`` cell."""
        col = self.column(field)
        if not 0 <= i < self.n_samples:
            raise IndexError(f"sample {i} out of range [0, {self.n_samples})")
        if col.fixed:
            return col.col_off + i * col.item_size, col.item_size, int(col.crcs[i])
        return int(col.offsets[i]), int(col.lengths[i]), int(col.crcs[i])

    def samples_nbytes(self, samples, fields=None) -> int:
        """Total payload bytes of ``samples`` restricted to ``fields`` —
        what the prefetcher's sparse-vs-full decision (and its
        ``bytes_skipped`` accounting) is computed from."""
        names = self.resolve_fields(fields)
        if not len(samples):
            return 0
        total = 0
        for f in names:
            col = self.columns[f]
            if col.fixed:
                total += col.item_size * len(samples)
            else:
                total += int(col.lengths[np.asarray(samples, dtype=np.int64)].sum())
        return total

    @classmethod
    def parse(cls, header: bytes, index: bytes, name: str = "shard") -> "ShardIndexV2":
        """Validate + parse a v2 header blob and its index-region blob.

        The index is remote-controlled data on the prefetch path, so every
        extent is checked: truncated regions, out-of-payload or
        **overlapping** column regions, arrays outside the index region,
        and cell extents outside their column all raise ``ShardCorruption``
        before any payload byte is trusted."""
        version, n, index_off, payload_off = parse_shard_header(header, name)
        if version != FORMAT_VERSION_V2:
            raise ShardCorruption(
                f"{name}: format version {version} is not v2 "
                "(one-blob v1 indexes parse via ShardIndex)"
            )
        if payload_off > index_off:
            raise ShardCorruption(f"{name}: payload region starts past the index")
        index_len, n_fields = parse_index_preamble(index, name)
        if index_len != len(index):
            raise ShardCorruption(
                f"{name}: truncated column index: region is {len(index)} bytes, "
                f"preamble claims {index_len}"
            )
        columns: dict[str, _Column] = {}
        pos = INDEX_PREAMBLE_SIZE
        for _ in range(n_fields):
            if pos + _FIELD_HEAD_SIZE > index_len:
                raise ShardCorruption(f"{name}: truncated column index: field table")
            name_len, kind, item_size, col_off, col_len, arr_off = (
                _FIELD_HEAD.unpack_from(index, pos)
            )
            pos += _FIELD_HEAD_SIZE
            if pos + name_len > index_len:
                raise ShardCorruption(f"{name}: truncated column index: field name")
            try:
                fname = bytes(index[pos : pos + name_len]).decode("utf-8")
            except UnicodeDecodeError as e:
                raise ShardCorruption(f"{name}: corrupt field name ({e})") from e
            pos += name_len
            if not fname or fname in columns:
                raise ShardCorruption(
                    f"{name}: corrupt column index: empty or duplicate field "
                    f"name {fname!r}"
                )
            if kind not in (_KIND_VAR, _KIND_FIXED):
                raise ShardCorruption(
                    f"{name}: field {fname!r} has unknown column kind {kind}"
                )
            if col_off < payload_off or col_off + col_len > index_off:
                raise ShardCorruption(
                    f"{name}: field {fname!r} column region outside the payload"
                )
            fixed = kind == _KIND_FIXED
            arr_nbytes = n * (_CRC_DTYPE.itemsize if fixed else ENTRY_SIZE)
            rel = arr_off - index_off
            if rel < INDEX_PREAMBLE_SIZE or rel + arr_nbytes > index_len:
                raise ShardCorruption(
                    f"{name}: field {fname!r} index arrays outside the index region"
                )
            if fixed:
                if item_size * n != col_len:
                    raise ShardCorruption(
                        f"{name}: field {fname!r}: fixed column length {col_len} "
                        f"!= {n} x item_size {item_size}"
                    )
                crcs = np.frombuffer(index, _CRC_DTYPE, count=n, offset=rel)
                offsets = lengths = None
            else:
                arr = np.frombuffer(index, _INDEX_DTYPE, count=n, offset=rel)
                offsets, lengths, crcs = arr["off"], arr["len"], arr["crc"]
                if n and (
                    int(offsets.min(initial=col_off)) < col_off
                    or int((offsets.astype(np.int64) + lengths).max())
                    > col_off + col_len
                ):
                    raise ShardCorruption(
                        f"{name}: field {fname!r}: cell extents outside the column"
                    )
            columns[fname] = _Column(
                fname, fixed, item_size, col_off, col_len, offsets, lengths, crcs
            )
        # column regions must not overlap: a cell of one field aliasing
        # another field's bytes would let one flipped region corrupt two
        # columns while each column's crcs still "verify"
        spans = sorted((c.col_off, c.col_len, c.name) for c in columns.values())
        for (a_off, a_len, a_name), (b_off, _b_len, b_name) in zip(spans, spans[1:]):
            if a_off + a_len > b_off:
                raise ShardCorruption(
                    f"{name}: overlapping column regions ({a_name!r} and {b_name!r})"
                )
        return cls(
            n, payload_off, index_off, index_len, columns,
            bytes(header[:HEADER_SIZE]), bytes(index),
        )


class ShardWriter:
    """Streams samples into one v1 shard file; finalizes index + header on
    close.

    Usage::

        with ShardWriter(path) as w:
            for blob in blobs:
                w.add(blob)

    ``add`` returns the sample's position within the shard.  The file is not
    a valid shard until ``close()`` (the header is a zero placeholder while
    streaming), so a crashed writer leaves an obviously-invalid file rather
    than a silently short one.  That guarantee extends to exceptions raised
    inside the ``with`` body: ``__exit__`` then calls ``abort()`` — close
    without finalizing — instead of stamping a valid-looking header over a
    partial payload.  ``close()`` fsyncs the payload + index before the
    header write that validates them, so a crash between the two can't
    leave a magic-valid file whose contents never reached the disk.
    """

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._f = open(self.path, "wb")
        self._f.write(b"\0" * HEADER_SIZE)
        self._entries: list[tuple[int, int, int]] = []
        self._closed = False

    def add(self, data) -> int:
        """Append one encoded sample; returns its index within the shard."""
        if self._closed:
            raise RuntimeError("ShardWriter already closed")
        data = memoryview(data)
        off = self._f.tell()
        self._f.write(data)
        self._entries.append((off, data.nbytes, zlib.crc32(data)))
        return len(self._entries) - 1

    @property
    def n_samples(self) -> int:
        return len(self._entries)

    @property
    def payload_bytes(self) -> int:
        return sum(ln for _, ln, _ in self._entries)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        index_off = self._f.tell()
        for entry in self._entries:
            self._f.write(_ENTRY.pack(*entry))
        # payload + index must be durable BEFORE the header makes the file
        # claim to be a valid shard — otherwise a crash between the two
        # writes leaves a magic-valid header over unsynced (possibly lost)
        # contents, defeating the zero-placeholder scheme.
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.seek(0)
        self._f.write(
            _HEADER.pack(
                MAGIC, FORMAT_VERSION, len(self._entries), index_off, HEADER_SIZE
            )
        )
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()

    def abort(self) -> None:
        """Abandon the shard: close the file WITHOUT finalizing it.

        The zero placeholder header stays, so readers reject the file —
        this is the path for an exception mid-stream (``__exit__`` takes it
        automatically).  Idempotent; a no-op after ``close()``.
        """
        if self._closed:
            return
        self._closed = True
        self._f.close()

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # an exception inside the `with` body means the stream is partial:
        # finalizing would stamp a valid header over bad data — abort instead
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class ShardWriterV2:
    """Writes dict-of-fields samples into one columnar v2 shard file.

    Usage::

        with ShardWriterV2(path) as w:
            for sample in samples:          # {"image": b"...", "caption": b"..."}
                w.add(sample)

    The field set is fixed by ``fields=`` or by the first ``add`` (in dict
    order); every later sample must carry exactly the same fields.  Because
    columns are contiguous on disk but samples arrive row-wise, the writer
    buffers one shard's payload in memory and lays the columns out at
    ``close()`` — shard payloads are bounded (``pack`` rolls shards), so
    this is a per-shard, not per-dataset, cost.  A column whose blobs all
    share one length is stored **fixed** (item_size + per-sample crcs only);
    everything else gets the full per-sample (offset, length, crc) arrays.

    Crash/abort semantics match ``ShardWriter``: a zero placeholder header
    until the fsync'd close, ``abort()`` on exceptions inside ``with``.
    """

    def __init__(self, path: str | pathlib.Path, fields=None):
        self.path = pathlib.Path(path)
        self._f = open(self.path, "wb")
        self._f.write(b"\0" * HEADER_SIZE)
        self._names: tuple[str, ...] | None = (
            self._check_names(fields) if fields is not None else None
        )
        self._cols: dict[str, list[bytes]] = {}
        self._crcs: dict[str, list[int]] = {}
        self._n = 0
        self._payload = 0
        self._closed = False

    @staticmethod
    def _check_names(fields) -> tuple[str, ...]:
        names = tuple(fields)
        if not names:
            raise ValueError("a v2 shard needs at least one field")
        seen = set()
        for f in names:
            if not isinstance(f, str) or not f or len(f.encode("utf-8")) > 255:
                raise ValueError(f"bad field name {f!r} (non-empty str, <=255 UTF-8 bytes)")
            if f in seen:
                raise ValueError(f"duplicate field name {f!r}")
            seen.add(f)
        return names

    def add(self, sample: dict) -> int:
        """Append one dict-of-fields sample; returns its index."""
        if self._closed:
            raise RuntimeError("ShardWriterV2 already closed")
        if self._names is None:
            self._names = self._check_names(sample.keys())
        if set(sample.keys()) != set(self._names):
            raise ValueError(
                f"sample fields {sorted(sample)} != shard fields {sorted(self._names)}"
            )
        for name in self._names:
            blob = bytes(sample[name])
            self._cols.setdefault(name, []).append(blob)
            self._crcs.setdefault(name, []).append(zlib.crc32(blob))
            self._payload += len(blob)
        self._n += 1
        return self._n - 1

    @property
    def n_samples(self) -> int:
        return self._n

    @property
    def payload_bytes(self) -> int:
        return self._payload

    @property
    def field_names(self) -> tuple[str, ...] | None:
        return self._names

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        names = self._names or ()
        # columns: each field's blobs back to back, in schema order
        off = HEADER_SIZE
        col_meta: list[tuple[str, bool, int, int, list[int]]] = []
        for name in names:
            blobs = self._cols.get(name, [])
            lens = [len(b) for b in blobs]
            col_off = off
            for b in blobs:
                self._f.write(b)
            col_len = sum(lens)
            off += col_len
            fixed = self._n > 0 and len(set(lens)) == 1
            col_meta.append((name, fixed, col_off, col_len, lens))
        index_off = off
        # index region layout: preamble | field table | per-column arrays
        table_size = sum(_FIELD_HEAD_SIZE + len(n.encode("utf-8")) for n in names)
        arr_off = index_off + INDEX_PREAMBLE_SIZE + table_size
        table_parts: list[bytes] = []
        array_parts: list[bytes] = []
        for name, fixed, col_off, col_len, lens in col_meta:
            nb = name.encode("utf-8")
            if fixed:
                item_size = lens[0] if lens else 0
                arr = np.asarray(self._crcs.get(name, []), dtype=_CRC_DTYPE).tobytes()
            else:
                item_size = 0
                rec = np.empty(self._n, dtype=_INDEX_DTYPE)
                rec["off"] = col_off + np.concatenate(
                    ([0], np.cumsum(lens[:-1], dtype=np.int64))
                ) if lens else 0
                rec["len"] = lens
                rec["crc"] = self._crcs.get(name, [])
                arr = rec.tobytes()
            table_parts.append(
                _FIELD_HEAD.pack(
                    len(nb),
                    _KIND_FIXED if fixed else _KIND_VAR,
                    item_size,
                    col_off,
                    col_len,
                    arr_off,
                )
                + nb
            )
            array_parts.append(arr)
            arr_off += len(arr)
        index_len = (
            INDEX_PREAMBLE_SIZE
            + table_size
            + sum(len(a) for a in array_parts)
        )
        self._f.write(_INDEX_PREAMBLE.pack(index_len, len(names), 0))
        for part in table_parts:
            self._f.write(part)
        for part in array_parts:
            self._f.write(part)
        # same durability order as v1: columns + index durable BEFORE the
        # header write that makes the file claim to be a valid shard
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.seek(0)
        self._f.write(
            _HEADER.pack(MAGIC, FORMAT_VERSION_V2, self._n, index_off, HEADER_SIZE)
        )
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._cols = {}
        self._crcs = {}

    def abort(self) -> None:
        """Abandon the shard (zero placeholder header stays — see
        ``ShardWriter.abort``).  Idempotent; a no-op after ``close()``."""
        if self._closed:
            return
        self._closed = True
        self._f.close()
        self._cols = {}
        self._crcs = {}

    def __enter__(self) -> "ShardWriterV2":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class MappedShardReader:
    """Shared mmap plumbing for the full (on-disk) shard readers.

    ``isinstance(reader, MappedShardReader)`` is the "full shard resident
    on disk" test the cache and peer server dispatch on — true for both
    format versions, false for ``SparseShardReader`` entries."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._file = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:  # empty file
            self._file.close()
            raise ShardCorruption(f"{self.path}: not a shard file ({e})") from e
        self._buf = memoryview(self._mm)
        if len(self._mm) < HEADER_SIZE:
            self._fail(f"file is {len(self._mm)} bytes, header needs {HEADER_SIZE}")

    def _fail(self, msg: str) -> None:
        path = self.path
        self.close()
        raise ShardCorruption(f"{path}: {msg}")

    def __len__(self) -> int:
        return self.n_samples

    @property
    def nbytes(self) -> int:
        return len(self._mm)

    def raw(self, start: int, length: int) -> memoryview:
        """Zero-copy raw file bytes ``[start, start+length)`` — the ranged
        read a ``PeerShardServer`` serves to other ranks (unverified here;
        the consuming rank's reader applies the per-sample crc)."""
        if start < 0 or length < 0 or start + length > len(self._mm):
            raise ValueError(
                f"{self.path}: range {start}+{length} outside {len(self._mm)}-byte shard"
            )
        return self._buf[start : start + length]

    def close(self) -> None:
        """Release the mapping.  Best-effort: if sample views are still
        alive the pages stay mapped until they are dropped (the OS, not us,
        owns reclamation) — never a dangling pointer, at worst a deferred
        unmap."""
        if getattr(self, "_buf", None) is not None:
            self._buf.release()
            self._buf = None
        if getattr(self, "_mm", None) is not None:
            try:
                self._mm.close()
            except BufferError:  # exported sample views keep the mapping alive
                pass
            self._mm = None
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardReader(MappedShardReader):
    """mmap-backed random access into one **v1** shard file.

    ``read(i)`` returns a zero-copy ``memoryview`` of the sample bytes and
    (by default) verifies the per-sample crc32.  The whole index is parsed
    once into numpy arrays at open, so per-read work is two array loads, one
    slice, and (optionally) the crc pass.

    This is the v1 path: a columnar v2 shard is rejected loudly on the
    header's version byte (use ``ShardReaderV2``, or ``open_shard_reader``
    to dispatch automatically).
    """

    def __init__(self, path: str | pathlib.Path):
        super().__init__(path)
        size = len(self._mm)
        magic, version, n, index_off, payload_off = _HEADER.unpack_from(self._buf, 0)
        if magic != MAGIC:
            self._fail(f"bad magic {bytes(magic)!r} (unfinalized or foreign file)")
        if version > MAX_FORMAT_VERSION:
            self._fail(
                f"shard version {version} is newer than reader {MAX_FORMAT_VERSION}"
            )
        if version != FORMAT_VERSION:
            self._fail(
                f"format version {version} is not a v1 shard — columnar v2 "
                "shards need ShardReaderV2 (open_shard_reader dispatches on "
                "the version byte)"
            )
        if index_off + n * ENTRY_SIZE > size or payload_off > index_off:
            self._fail("truncated shard: index region extends past end of file")
        self.n_samples = n
        self._verified = np.zeros(n, dtype=bool)  # per-sample crc memo
        index = np.frombuffer(self._buf, _INDEX_DTYPE, count=n, offset=index_off)
        self.offsets = index["off"]
        self.lengths = index["len"]
        self.crcs = index["crc"]
        if n and (
            int(self.offsets.min(initial=payload_off)) < payload_off
            or int((self.offsets.astype(np.int64) + self.lengths).max()) > index_off
        ):
            self._fail("corrupt index: sample extents outside the payload region")

    def read(self, i: int, *, verify: bool = True) -> memoryview:
        """Zero-copy bytes of sample ``i`` (a slice of the shard's mmap)."""
        if not 0 <= i < self.n_samples:
            raise IndexError(f"sample {i} out of range [0, {self.n_samples})")
        off, ln = int(self.offsets[i]), int(self.lengths[i])
        view = self._buf[off : off + ln]
        # crc memo: the mapping is immutable, so one successful verification
        # covers every later read of the same sample (epoch 2+ of a warm
        # cache is pure pointer math).  A mismatch is never memoized — a
        # corrupt sample raises on every read, keeping the per-sample-hole
        # semantics.  Racing first reads both verify; both set the bit.
        if verify and not self._verified[i]:
            if zlib.crc32(view) != int(self.crcs[i]):
                raise ShardCorruption(f"{self.path}: sample {i} failed crc32 check")
            self._verified[i] = True
        return view

    def verify_all(self) -> int:
        """Verify every sample's crc32 in ONE sequential pass over the
        payload, memoizing each success into the per-sample bitset.

        This is the cache-install fast path: a freshly downloaded shard is
        checked once, in the fetching thread (off the hot read loop), and
        every subsequent ``read`` is pure pointer math.  The per-sample
        failure contract is preserved exactly: a corrupt sample's bit stays
        unset (it is never memoized), so reading it still raises
        ``ShardCorruption`` for that sample only.  Returns the number of
        corrupt samples found.
        """
        bad = 0
        for i in range(self.n_samples):
            if self._verified[i]:
                continue
            off, ln = int(self.offsets[i]), int(self.lengths[i])
            if zlib.crc32(self._buf[off : off + ln]) == int(self.crcs[i]):
                self._verified[i] = True
            else:
                bad += 1
        return bad


class ShardReaderV2(MappedShardReader):
    """mmap-backed random access into one **columnar v2** shard file.

    ``read_fields(i, fields=...)`` returns a dict of zero-copy
    ``memoryview`` slices — one per requested field, each verified against
    its own crc32 (memoized per (field, sample) cell, failures never
    memoized, so corruption stays a per-sample hole in exactly one field).
    Fixed-width columns additionally support ``read_field_chunk`` — one
    contiguous slice covering a run of samples, no per-sample work.
    """

    def __init__(self, path: str | pathlib.Path):
        super().__init__(path)
        size = len(self._mm)
        try:
            version, _n, index_off, _payload_off = parse_shard_header(
                bytes(self._buf[:HEADER_SIZE]), str(self.path)
            )
        except ShardCorruption as e:
            self._fail(str(e).split(": ", 1)[-1])
        if version != FORMAT_VERSION_V2:
            self._fail(
                f"format version {version} is not a v2 shard — one-blob v1 "
                "shards need ShardReader (open_shard_reader dispatches on "
                "the version byte)"
            )
        if index_off + INDEX_PREAMBLE_SIZE > size:
            self._fail("truncated column index: preamble extends past end of file")
        index_len, _n_fields = parse_index_preamble(
            bytes(self._buf[index_off : index_off + INDEX_PREAMBLE_SIZE]),
            str(self.path),
        )
        if index_off + index_len > size:
            self._fail("truncated column index: region extends past end of file")
        try:
            self.index = ShardIndexV2.parse(
                bytes(self._buf[:HEADER_SIZE]),
                bytes(self._buf[index_off : index_off + index_len]),
                str(self.path),
            )
        except ShardCorruption as e:
            self._fail(str(e).split(": ", 1)[-1])
        self.n_samples = self.index.n_samples
        self.field_names = self.index.field_names
        # per-(field, sample) crc memo — one bitset per column
        self._verified = {
            f: np.zeros(self.n_samples, dtype=bool) for f in self.field_names
        }

    def read_field(self, i: int, field: str, *, verify: bool = True) -> memoryview:
        """Zero-copy bytes of sample ``i``'s ``field`` cell."""
        off, ln, crc = self.index.locate(field, i)
        view = self._buf[off : off + ln]
        if verify and not self._verified[field][i]:
            if zlib.crc32(view) != crc:
                raise ShardCorruption(
                    f"{self.path}: sample {i} field {field!r} failed crc32 check"
                )
            self._verified[field][i] = True
        return view

    def read_fields(
        self, i: int, fields=None, *, verify: bool = True
    ) -> dict[str, memoryview]:
        """Projected read: ``{field: zero-copy memoryview}`` for the
        requested fields (all of them when ``fields`` is None).  Unknown
        field names raise ``KeyError``."""
        return {
            f: self.read_field(i, f, verify=verify)
            for f in self.index.resolve_fields(fields)
        }

    def read_field_chunk(
        self, field: str, start: int, count: int, *, verify: bool = True
    ) -> memoryview:
        """One contiguous slice covering samples ``[start, start+count)``
        of a **fixed-width** column — the vectorized-chunk read: no
        per-sample offsets, one memoryview, reshapeable by the caller.
        Each covered cell's crc is still checked (memoized), so corruption
        stays a per-sample hole: the bad sample index is named."""
        col = self.index.column(field)
        if not col.fixed:
            raise TypeError(
                f"field {field!r} is variable-width; chunk reads need a "
                "fixed (vectorized) column"
            )
        if start < 0 or count < 0 or start + count > self.n_samples:
            raise IndexError(
                f"chunk [{start}, {start + count}) outside [0, {self.n_samples})"
            )
        if verify:
            bits = self._verified[field]
            sz = col.item_size
            for i in range(start, start + count):
                if bits[i]:
                    continue
                off = col.col_off + i * sz
                if zlib.crc32(self._buf[off : off + sz]) != int(col.crcs[i]):
                    raise ShardCorruption(
                        f"{self.path}: sample {i} field {field!r} failed crc32 check"
                    )
                bits[i] = True
        a = col.col_off + start * col.item_size
        return self._buf[a : a + count * col.item_size]

    def verify_all(self) -> int:
        """One sequential crc pass over every column (the cache-install
        fast path; see ``ShardReader.verify_all``).  Corrupt cells are
        never memoized.  Returns the number of corrupt cells found."""
        bad = 0
        for f in self.field_names:
            col = self.index.column(f)
            bits = self._verified[f]
            for i in range(self.n_samples):
                if bits[i]:
                    continue
                off, ln, crc = self.index.locate(f, i)
                if zlib.crc32(self._buf[off : off + ln]) == crc:
                    bits[i] = True
                else:
                    bad += 1
        return bad


def open_shard_reader(path: str | pathlib.Path) -> ShardReader | ShardReaderV2:
    """Open a shard file, dispatching on the header's format-version byte:
    v1 → ``ShardReader``, v2 → ``ShardReaderV2``.  This is what the
    dataset and the shard cache call, so v1 shards written before the
    columnar format keep reading byte-identically with zero call-site
    changes."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    version, _n, _index_off, _payload_off = parse_shard_header(head, str(path))
    if version >= FORMAT_VERSION_V2:
        return ShardReaderV2(path)
    return ShardReader(path)
