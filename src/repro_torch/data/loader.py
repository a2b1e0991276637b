"""The image loader: an SPDL pipeline wired for the paper's benchmark.

``build_image_loader`` — sample indices → slot assignment → read bytes (I/O)
→ decode+resize (GIL-releasing CPU, written in place into slab slots) →
slab batch assembly → device transfer (concurrency=1) → the card.

This is the PyTorch port of ``repro.data.loader.build_image_loader``; the
pipeline, its options and their rules are the same (see that module's
docstring for the memory model, chunked + fused execution, the checkpoint
skip bounds and the failure semantics).  What differs is the device leg:

* ``device=`` names where batches go (``torch.device("cuda")`` when None);
  it takes the place of the JAX package's ``shardings``.
* A CUDA loader allocates its slab ring in pinned host memory
  (``arena.pinned_alloc``), so the transfer's copy from a slab is
  asynchronous on its own stream; a CPU loader keeps ``np.empty`` slabs.
* With ``device_decode=DeviceDecode(...)`` batches cross as uint8 and the
  fused ``dequant_normalize_augment`` CUDA kernel decodes them on the card
  (``kernels/csrc/dequant_normalize.cu``); on a CPU loader its plain
  PyTorch version runs instead.

The slab ring keeps the JAX package's size (``_ring_size``): the transfer's
hold window plus the slabs in flight.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from ..core import Pipeline, PipelineBuilder
from .arena import SlabArena, numpy_alloc, pinned_alloc
from .codec import (
    decode_into,
    decode_sample,
    parse_header,
    resize_nearest,
    resize_nearest_into,
)
from .sampler import CheckpointableSampler
from .transfer import DeviceDecode, DeviceTransfer


def _ring_size(
    arena_slabs: int | None, transfer: DeviceTransfer, transfer_chunk: int = 2
) -> int:
    """Slab-ring size for a loader: the ring must outsize the slabs pinned
    at once (transfer hold + inter-stage queues + the one being filled) or
    the binder deadlocks the pipeline.  The batch→transfer queue is widened
    to the transfer stage's chunk (so the chunked drain can actually fill
    its chunks), and every batch parked there pins a slab — the floor
    grows with ``transfer_chunk`` past the default 2.  An explicit request
    below the floor is an error, not a silent inflation — the caller set
    it as a memory cap and must raise it (or the sink buffer) knowingly."""
    in_flight = 2 + max(2, transfer_chunk)  # queue + assembling + mid-transfer
    floor = transfer.hold_slabs + in_flight
    if arena_slabs is None:
        return floor
    if arena_slabs < floor:
        raise ValueError(
            f"arena_slabs={arena_slabs} is below the deadlock floor "
            f"{floor} (= transfer hold {transfer.hold_slabs} + {in_flight} "
            "in-flight); raise arena_slabs or lower sink_buffer/transfer_chunk"
        )
    return arena_slabs


def _pipe_transfer(
    builder: PipelineBuilder, transfer: DeviceTransfer, transfer_chunk: int
) -> PipelineBuilder:
    """Wire the terminal transfer stage (§2.1: exactly one transfer task).

    ``transfer_chunk > 1`` dispatches a drained chunk of batches per engine
    hop (``transfer_many`` as a vectorized chunk stage) — one executor call
    issues the whole chunk's host→device copies (+ fused decode) in
    order.  The ``cache=transfer`` probe surfaces ``device_decode_ms`` /
    ``device_decode_batches`` on the transfer stage's stats row."""
    if transfer_chunk > 1:
        return builder.pipe(
            transfer.transfer_many, concurrency=1, name="transfer",
            chunk=transfer_chunk, vectorized=True, cache=transfer,
        )
    return builder.pipe(transfer, concurrency=1, name="transfer", cache=transfer)


#: how many samples of headroom the shard-prefetch wrapper keeps between
#: scheduling a shard's fetch and handing its first index to the pipeline —
#: the slack that lets the download overlap the decode of earlier shards.
_PREFETCH_LOOKAHEAD = 64


def _with_shard_prefetch(
    indices: Iterable[int],
    dataset: Any,
    lookahead: int = _PREFETCH_LOOKAHEAD,
    fields: tuple[str, ...] | None = None,
) -> Iterator[int]:
    """Index-stream wrapper for prefetcher-backed shard datasets: peek
    ``lookahead`` samples ahead of what the pipeline has been handed and
    schedule background fetches for the shards they live in, so by the time
    the read stage asks for a sample its shard is (usually) already in the
    local cache.  Scheduling is advisory — a dropped request just means the
    read stage fetches on demand.

    Index-first sources (``prefetcher.index_first``): instead of scheduling
    a whole-shard fetch on first sight, the wrapper accumulates the *run*
    of consecutive same-shard indices the sampler emits (the shard-aware
    shuffle makes runs the common case) and schedules the shard with those
    shard-local indices as ``samples=`` hints — the prefetcher then pulls
    the shard's header + index and fetches only the hinted sample ranges
    when they cover a small fraction of the payload.  A run that grows past
    ``lookahead`` clearly wants most of the shard, so it is committed early
    as a whole-shard fetch.

    The buffered indices have already advanced the sampler's cursor, so a
    checkpoint taken mid-stream treats them as consumed: resume skips at
    most ``lookahead`` samples beyond the sink-buffered batches (see the
    module docstring's checkpoint caveat).

    ``fields`` (columnar v2 shards) rides every hint: a sparse fetch then
    coalesces ranges over the requested columns only, so projection
    pushdown reaches the wire from here."""
    pf = dataset.prefetcher
    want_hints = bool(getattr(pf, "index_first", False))
    buf: deque[int] = deque()
    run_shard = -1
    run_samples: list[int] | None = []  # None = run already committed full

    def schedule(shard: int, samples=None) -> None:
        if fields is not None:
            pf.schedule(dataset.shard_names[shard], samples=samples, fields=fields)
        else:
            pf.schedule(dataset.shard_names[shard], samples=samples)

    def commit_run() -> None:
        if run_shard >= 0 and run_samples:
            schedule(run_shard, run_samples)

    for i in indices:
        shard, local = dataset.shard_and_offset(i)
        if shard != run_shard:  # run boundary; pf.schedule also dedups
            commit_run()
            run_shard, run_samples = shard, []
            if not want_hints:
                # no ranged reads available: schedule the whole shard as
                # early as possible (maximum fetch/decode overlap)
                schedule(shard)
                run_samples = None
        if want_hints and run_samples is not None:
            run_samples.append(local)
            if len(run_samples) >= lookahead:
                # the window wants most of this shard: commit to a full
                # fetch now rather than waiting for the run to end
                schedule(shard)
                run_samples = None
        buf.append(i)
        if len(buf) > lookahead:
            yield buf.popleft()
    commit_run()
    yield from buf


def _maybe_prefetch(
    indices: Iterable[int], dataset: Any, fields: tuple[str, ...] | None = None
) -> tuple[Iterable[int], Any]:
    """(index stream, cache probe) — wired only for prefetcher datasets.
    ``fields=None`` falls back to the dataset's own projection, so a
    ``ShardDataset(fields=...)`` hints its columns without loader help."""
    prefetcher = getattr(dataset, "prefetcher", None)
    if prefetcher is None:
        return indices, None
    if fields is None:
        fields = getattr(dataset, "fields", None)
    return _with_shard_prefetch(indices, dataset, fields=fields), prefetcher


def build_image_loader(
    dataset,
    *,
    batch_size: int = 32,
    hw: tuple[int, int] = (224, 224),
    read_concurrency: int = 4,
    decode_concurrency: int = 4,
    num_threads: int = 8,
    sink_buffer: int = 3,
    device: torch.device | str | None = None,  # None = torch.device("cuda")
    uint8_wire: bool = True,
    sampler: CheckpointableSampler | None = None,
    epochs: int | None = 1,  # None = stream forever (training);  N = bounded
    zero_copy: bool = True,
    arena_slabs: int | None = None,  # None = sized from the consumer window
    chunk: int = 16,  # items per executor dispatch; 1 = per-item path
    fuse_stages: bool = True,  # collapse read+decode into one worker call
    straggler_after: float | None = None,  # soft deadline on read/decode
    trace=None,  # core.trace.Tracer: flight-recorder spans for every layer
    fields: tuple[str, ...] | None = None,  # columnar projection, e.g. ("image",)
    device_decode: DeviceDecode | None = None,  # on-chip fused decode tail
    transfer_chunk: int = 2,  # batches per transfer dispatch; 1 = per-batch
) -> Pipeline:
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if transfer_chunk < 1:
        raise ValueError("transfer_chunk must be >= 1")
    if straggler_after is not None and chunk <= 1:
        raise ValueError("straggler_after requires chunk > 1 (see pipe())")
    # Columnar projection: this pipeline decodes exactly one image blob per
    # sample, so the projection must name exactly one field.  The name is
    # pushed down every layer — the read stage pulls only that column, the
    # prefetch hints carry it to the wire, and multi-field shards stop
    # paying fetch+decode for the columns this loader never touches.
    if fields is not None:
        fields = tuple(fields)
        if len(fields) != 1:
            raise ValueError(
                f"the image pipeline decodes one field per sample; "
                f"fields={list(fields)} names {len(fields)}"
            )
        if getattr(dataset, "schema_fields", None) is None:
            raise TypeError(
                "fields= needs a columnar (format v2) ShardDataset — "
                "migrate with pack(..., format_version=2)"
            )
    # fusion widens both stages to max(read, decode) concurrency — a
    # concurrency-1 stage may be deliberate (serialization), so don't
    fuse_stages = fuse_stages and (
        min(read_concurrency, decode_concurrency) > 1
        or read_concurrency == decode_concurrency
    )
    sampler = sampler or CheckpointableSampler(len(dataset), batch_size=1, shuffle=False)

    def indices():
        limit = None if epochs is None else sampler.batches_per_epoch() * epochs
        for k, batch in enumerate(sampler):
            if limit is not None and k >= limit:
                return
            yield from batch

    transfer = DeviceTransfer(
        device, uint8_wire=uint8_wire, consumer_window=sink_buffer,
        dispatch_chunk=transfer_chunk, device_decode=device_decode,
        tracer=trace,
    )

    index_stream, cache_probe = _maybe_prefetch(indices(), dataset, fields=fields)

    if fields is not None:
        _field = fields[0]

        def read_blob(i: int) -> memoryview:
            # projected read: only this column's bytes (zero-copy view)
            return dataset.read_fields(i, fields)[_field]
    else:
        read_blob = dataset.read_bytes

    if zero_copy and len(dataset) > 0:
        # The slab spec hard-codes uint8 (H, W, 3) slots.  A dataset of
        # incompatible samples (grayscale, float, video clips) would hole
        # out EVERY item under OnError.SKIP — a silent empty epoch — so
        # sniff one sample and fall back to list-collate instead.  Shard
        # manifests record sample 0's layout (per field on columnar
        # manifests), which answers the question without reading data (a
        # remote dataset would otherwise download a whole shard for this
        # one header).
        meta = (
            dataset.field_meta(fields[0])
            if fields is not None and callable(getattr(dataset, "field_meta", None))
            else getattr(dataset, "sample_meta", None)
        )
        if meta is not None:
            dtype, shape = meta
            if len(shape) != 3 or shape[2] != 3 or dtype != np.uint8:
                zero_copy = False
        else:
            try:
                probe = decode_sample(read_blob(0))
            except Exception:
                pass  # unreadable first sample: the runtime path will skip it
            else:
                if probe.ndim != 3 or probe.shape[2] != 3 or probe.dtype != np.uint8:
                    zero_copy = False

    if not zero_copy:
        # Classic list-collate fallback: each decode allocates its own
        # output, the collate stage allocates a fresh slab per batch.
        def read(i: int) -> bytes:
            return read_blob(i)

        def decode(data: bytes) -> np.ndarray:
            img = decode_sample(data)
            return resize_nearest(img, hw)

        def make_batch(imgs: list[np.ndarray]) -> dict:
            out = np.empty((len(imgs), *imgs[0].shape), imgs[0].dtype)
            for j, im in enumerate(imgs):
                out[j] = im
            return {"images": out}

        builder = (
            PipelineBuilder()
            .add_source(index_stream, name="sampler")
            .pipe(read, concurrency=read_concurrency, name="read",
                  cache=cache_probe, chunk=chunk,
                  straggler_after=straggler_after)
            .pipe(decode, concurrency=decode_concurrency, name="decode",
                  chunk=chunk, straggler_after=straggler_after)
        )
        if fuse_stages:
            builder.fuse("read", "decode")
        builder = builder.aggregate(
            batch_size, drop_last=True, name="batch"
        ).pipe(make_batch, name="collate")
        return (
            _pipe_transfer(builder, transfer, transfer_chunk)
            .add_sink(buffer_size=sink_buffer)
            .build(num_threads=num_threads, trace=trace)
        )

    # Zero-copy slab path (see module docstring "Memory model").
    arena = SlabArena(
        {"images": ((*hw, 3), np.uint8)},
        batch_size=batch_size,
        num_slabs=_ring_size(arena_slabs, transfer, transfer_chunk),
        alloc=pinned_alloc if transfer.device.type == "cuda" else numpy_alloc,
    )

    def read(item) -> tuple:
        i, ref = item
        try:
            return read_blob(i), ref
        except Exception:
            ref.mark_hole()  # the slot was already assigned; don't leak it
            raise

    def decode(item):
        data, ref = item
        try:
            out = ref.slab.arrays["images"][ref.slot]
            dtype, shape, _ = parse_header(data)
            if tuple(shape) == tuple(out.shape) and dtype == out.dtype:
                decode_into(data, out)  # native size: decompress into the slot
            else:
                resize_nearest_into(decode_sample(data), out)
            return ref
        except Exception:
            ref.mark_hole()  # the row will never arrive; unblock the batch
            raise

    builder = PipelineBuilder().add_source(index_stream, name="sampler")
    if chunk > 1:
        # chunked binder: one executor call assigns N slots in order (the
        # stage is concurrency=1 and order-preserving, so the stateful
        # cursor is single-writer).  Arena exhaustion blocks the worker
        # thread — the same backpressure, minus a loop poll per item.
        next_slot = arena.slot_writer()

        def bind(item):
            return item, next_slot()

        builder.pipe(bind, concurrency=1, name="slot", chunk=chunk)
    else:
        builder.pipe(arena.binder(), concurrency=1, name="slot")  # blocks = backpressure
    builder.pipe(
        read, concurrency=read_concurrency, name="read",
        cache=cache_probe, chunk=chunk, straggler_after=straggler_after,
    ).pipe(
        decode, concurrency=decode_concurrency, name="decode", chunk=chunk,
        straggler_after=straggler_after,
        # the batch stage drains via get_many: a chunk-wide queue of slot
        # REFS (tickets, not pixels) lets it amortize its loop hops too
        queue_size=max(2, chunk),
    )
    if fuse_stages:
        builder.fuse("read", "decode")
    builder = builder.aggregate_into(arena, batch_size, drop_last=True, name="batch")
    pipe = (
        _pipe_transfer(builder, transfer, transfer_chunk)
        .add_sink(buffer_size=sink_buffer)
        .build(num_threads=num_threads, trace=trace)
    )
    pipe.add_stop_callback(arena.close)
    pipe.add_stop_callback(transfer.flush)
    return pipe
