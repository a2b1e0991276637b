"""Sharded record store: packed shards, mmap zero-copy reads, prefetch.

The storage-side counterpart of the SPDL compute pipeline: instead of one
file per sample (one ``open()+read()`` syscall pair each, hostile to both
local filesystems and object stores), samples are packed into a few large
**shard** files read through ``mmap`` with zero payload copies, fronted by
an async prefetcher with a byte-budgeted local cache for remote sources.

On-disk layout
--------------
A sharded dataset is a directory of shard files plus a JSON manifest::

    dataset/
      manifest.json            {"version": 1, "total": N,
                                "shards": [{"name", "n", "bytes"}, ...]}
      shard-00000.rpshard
      shard-00001.rpshard

Each ``.rpshard`` file is ``[header | payload | index]`` (little-endian):

* **header** (32 B): magic ``b"RPRSHRD1"``, ``version:u32``,
  ``n_samples:u32``, ``index_offset:u64``, ``payload_offset:u64``;
* **payload**: the encoded samples (codec.py ``RPR1`` blobs, but the format
  is payload-agnostic) packed back to back;
* **index** (16 B/sample, written after the payload so the writer streams):
  ``offset:u64``, ``length:u32``, ``crc32:u32``.

**Format v2 (columnar)** keeps the same header (``version=2``) but lays
the payload out as one contiguous *column region per named field*, with a
per-column index carrying per-(field, sample) offsets/lengths/crc32s.
Readers that only need some fields fetch only those columns — *projection
pushdown* — and the saving propagates through every layer: sparse
prefetch coalesces ranges per projected column, ranged sources download
only those spans, and peers serve column ranges from their warm caches.
See ``format.py`` for the byte-level spec.

Versioning: the magic pins the major layout, ``version`` the minor
revision; readers reject unknown magics and newer-than-self versions and
keep reading every older version ever shipped.  ``open_shard_reader``
peeks the header and returns the right reader class for either version.

CRC policy: crcs are computed over the encoded sample bytes at pack time
and verified on every read by default; a mismatch raises
``ShardCorruption`` for that sample only, so one flipped bit becomes a
per-sample hole under the pipeline's ``OnError.SKIP`` instead of a dead
shard or a silently wrong batch.

Remote source protocol
----------------------
The prefetcher talks to storage through a duck type:

``fetch(name) -> bytes``
    Download one whole object (shard or manifest).  Required.

``fetch_range(name, start, length) -> bytes``
    Download exactly ``length`` bytes at offset ``start``.  **Optional**;
    providing it unlocks *index-first fetch*: the prefetcher pulls the
    32-byte header + 16 B/sample index region first (``ShardIndex``),
    decides — from the sampler window's hints and the byte budget —
    whether the payload is worth committing to, and can serve reads from a
    sparse, partially-fetched shard (``SparseShardReader``), demand-
    fetching individual sample ranges as needed.  Sources advertise range
    support simply by having the method (wrappers like ``RetryingSource``
    forward it iff their inner source has it).

Error contract: ``FileNotFoundError`` = object does not exist (permanent);
``sources.SourceUnavailable`` (an ``OSError``) = transient, retryable.

Backends: ``LocalShardSource`` (directory), ``SimulatedLatencySource``
(deterministic object-storage stand-in), ``HttpShardSource`` (real HTTP(S)
with ``Range`` reads + connection reuse), ``RetryingSource`` (capped
exponential backoff + jitter around any of the above), and the peer
exchange tier (``peer.py``): ``PeerShardServer`` serves a rank's warm
cache out, ``PeerShardSource``/``TieredSource`` consult peers' warm caches
before the origin — the composed stack is origin → retry → peers →
prefetcher (``ShardDataset(url, peers=[...])`` builds it).  S3/GCS-native
sources are the next target behind the same duck type.

Public surface
--------------
``ShardWriter`` / ``ShardReader``  one-file pack/read (``format.py``;
                                   ``ShardIndex`` for index-only parses);
``ShardWriterV2`` / ``ShardReaderV2``  columnar (format v2) pack/read with
                                   field projection (``ShardIndexV2`` for
                                   index-only parses;
                                   ``open_shard_reader`` dispatches on the
                                   header version byte);
``ShardDataset`` / ``pack``        multi-shard dataset + migration tool
                                   (``dataset.py``; an ``http(s)://`` root
                                   builds the remote stack automatically);
``ShardPrefetcher`` + sources      async fetch, LRU-by-bytes local cache,
                                   index-first sparse fetch, sparse→full
                                   promotion
                                   (``prefetch.py``, ``sources.py``);
``PeerShardServer`` + tiers        peer-to-peer shard exchange between
                                   data ranks (``peer.py``);
``testing.serve_shards``           stdlib HTTP *origin* fixture with Range
                                   support for tests/benchmarks.

``python -m repro.data.shards SRC DST`` packs an ``ArrayDataset``
directory from the command line.
"""

from .dataset import (
    MANIFEST_NAME,
    ShardDataset,
    pack,
    validate_shard_name,
    write_manifest,
)
from .format import (
    MappedShardReader,
    ShardCorruption,
    ShardIndex,
    ShardIndexV2,
    ShardReader,
    ShardReaderV2,
    ShardWriter,
    ShardWriterV2,
    open_shard_reader,
)
from .membership import (
    TENANT_HEADER,
    AdmissionController,
    FleetMember,
    HashRing,
    MembershipRegistry,
    TokenBucket,
)
from .peer import PeerMiss, PeerShardServer, PeerShardSource, TieredSource
from .prefetch import (
    LocalShardSource,
    ShardPrefetcher,
    SimulatedLatencySource,
    SparseShardReader,
)
from .sources import (
    HttpShardSource,
    RangeNotSupported,
    RetryingSource,
    SourceUnavailable,
)

__all__ = [
    "MANIFEST_NAME",
    "TENANT_HEADER",
    "AdmissionController",
    "FleetMember",
    "HashRing",
    "HttpShardSource",
    "LocalShardSource",
    "MappedShardReader",
    "MembershipRegistry",
    "PeerMiss",
    "PeerShardServer",
    "PeerShardSource",
    "RangeNotSupported",
    "RetryingSource",
    "ShardCorruption",
    "ShardDataset",
    "ShardIndex",
    "ShardIndexV2",
    "ShardPrefetcher",
    "ShardReader",
    "ShardReaderV2",
    "ShardWriter",
    "ShardWriterV2",
    "SimulatedLatencySource",
    "SourceUnavailable",
    "SparseShardReader",
    "TieredSource",
    "TokenBucket",
    "open_shard_reader",
    "pack",
    "validate_shard_name",
    "write_manifest",
]
