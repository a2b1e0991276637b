"""The paper's benchmark scenario end-to-end on the sharded record store,
with PyTorch on a CUDA card: 'ImageNet'-style directory → ``pack`` into
mmap shards → SPDL pipeline (shard-aware sampler → mmap read →
decode-into-slab → batch → uint8 copy to the card) with the visibility
dashboard (including shard-cache counters), vs the per-file path and the
multiprocessing baseline — plus the **real HTTP backend**: the same shards
served over a loopback ``http.server`` with Range support, consumed via
``ShardDataset("http://...")`` (which builds HTTP range reads →
retry/backoff → prefetcher cache automatically).

The twin of ``examples/imagenet_pipeline.py``, section for section and
line for line.  The consumer's last mile is the hand-written CUDA kernel
``dequant_normalize`` (uint8 → bf16 NCHW, normalized), and the hot-path
section's ``device_decode`` runs the fused ``dequant_normalize_augment``
kernel right after the copy; on the CPU (``--device cpu``) both run their
plain PyTorch versions.

Multi-field projection (columnar format v2): the last shard section packs
image + caption as named columns and trains image-only via
``build_image_loader(..., fields=("image",))`` — projection pushdown
means the caption column never crosses the wire, and the dashboard counts
the skipped bytes.

Flight recorder (``core/trace.py``): the remote-shards run executes under
``tracing()`` with the tracer passed to ``build_image_loader(trace=...)``,
so every layer records spans — per-chunk stage phases, queue waits, shard
fetches and cache hits/misses, the host→device copy — one track per worker
thread.  The capture is exported as Chrome Trace JSON (load it at
https://ui.perfetto.dev or ``chrome://tracing``) to ``$REPRO_TRACE_PATH``
(default ``imagenet_trace.json`` next to this file).

Run: PYTHONPATH=src python examples_torch/imagenet_pipeline.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import tempfile
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import PipelineBuilder, tracing
from repro_torch.data import (
    CheckpointableSampler,
    LocalShardSource,
    PeerShardServer,
    ShardDataset,
    ShardPrefetcher,
    SimulatedLatencySource,
    SyntheticImageDataset,
    build_image_loader,
    pack,
)
from repro_torch.data.baselines import MPLoader
from repro_torch.data.shards.testing import serve_shards
from repro_torch.data.transfer import DeviceDecode
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import dequant_normalize

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FRAMES, FRAME, HW, BATCH = 96, (128, 128), (112, 112), 16
SHARD_SAMPLES, SHARD_WINDOW = 24, 48


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def consume(pipe, mean: torch.Tensor, std: torch.Tensor) -> tuple[int, float]:
    t0 = time.monotonic()
    n_img = 0
    with pipe.auto_stop():
        for batch in pipe:
            # device-side last mile: uint8 → bf16 normalize (the CUDA kernel on the card)
            x = dequant_normalize(batch["images"], mean, std)
            n_img += x.shape[0]
    sync(mean.device)
    return n_img, time.monotonic() - t0


def shard_sampler(ds) -> CheckpointableSampler:
    """Shard-aware shuffle: shards shuffled, samples shuffled within a
    sliding window — random enough for SGD, local enough to cache."""
    return CheckpointableSampler(
        len(ds), batch_size=1, seed=0, shard_sizes=ds.shard_sizes, shard_window=SHARD_WINDOW,
    )


def proc_cpu_s() -> float:
    parts = pathlib.Path("/proc/self/stat").read_text().split()
    return (int(parts[13]) + int(parts[14])) / os.sysconf("SC_CLK_TCK")


class ImageCaptionSource:
    """dict-of-blobs view over the file directory: the encoded image plus a
    caption sidecar per sample."""

    schema_fields = ("image", "caption")

    def __init__(self, files_ds):
        self.files_ds = files_ds

    def __len__(self):
        return len(self.files_ds)

    def read_fields(self, i, fields=None):
        # the caption column carries a rich sidecar (tokenized text,
        # augmentation metadata, ...) — here sized like one (~64KB/sample)
        # so the wire saving is visible below
        blobs = {
            "image": self.files_ds.read_bytes(i),
            "caption": (b"a synthetic image, sample %d " % i) * 2200,
        }
        return {f: blobs[f] for f in (fields or self.schema_fields)}


def run(d: str, device: torch.device | str | None = None) -> Iterator[dict]:
    """Every section of the example, in order, with its files under ``d``
    and its batches on ``device`` (``None`` = the card).  Each section
    prints what the reference's prints and then yields its report:
    ``{"section": name, ...}``, with ``images`` and ``seconds`` where it
    consumes the dataset."""
    dev = resolve_device(device, "imagenet_pipeline")
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)

    print("materializing synthetic imagenet ...")
    files_ds = SyntheticImageDataset.materialize(d + "/files", FRAMES, hw=FRAME, seed=0)

    # migrate the one-file-per-sample directory into packed shards
    shard_ds = pack(files_ds, d + "/shards", samples_per_shard=SHARD_SAMPLES)
    print(
        f"packed {len(shard_ds)} samples into {shard_ds.num_shards} shards "
        f"under {shard_ds.root}"
    )
    yield {"section": "pack", "samples": len(shard_ds), "shards": shard_ds.num_shards}

    pipe = build_image_loader(
        shard_ds, batch_size=BATCH, hw=HW, decode_concurrency=4, device=dev,
        sampler=shard_sampler(shard_ds),
    )
    n_img, dt = consume(pipe, mean, std)
    print(f"SPDL (local shards, mmap): {n_img} images in {dt:.2f}s "
          f"= {n_img / dt:.0f} img/s")
    print(pipe.format_stats())
    yield {"section": "local", "images": n_img, "seconds": dt}

    # chunked vs per-item engine: the loader above ran with its default
    # chunk=16 and read→decode FUSED into one worker call per chunk.  The
    # engine overhead shows on the READ path, where the work per item is a
    # near-free mmap slice and every sample otherwise pays ~4-5 event-loop
    # round trips per stage; chunking makes that cost O(items/chunk):
    def read_epoch(chunk: int) -> float:
        def read(i: int) -> int:
            return shard_ds.read_bytes(i).nbytes

        p = (
            PipelineBuilder()
            .add_source(list(range(len(shard_ds))), name="sampler")
            .pipe(read, concurrency=2, chunk=chunk, name="read", queue_size=32)
            .aggregate(32, name="batch")
            .add_sink(buffer_size=4)
            .build(num_threads=4)
        )
        t0 = time.monotonic()
        with p.auto_stop():
            n = sum(len(b) for b in p)
        return n / (time.monotonic() - t0)

    per_item_rate = read_epoch(1)
    chunked_rate = read_epoch(32)
    print(f"\nread path, per-item engine: {per_item_rate:.0f} samples/s"
          f"\nread path, chunked engine:  {chunked_rate:.0f} samples/s"
          f" (x{chunked_rate / max(per_item_rate, 1e-9):.1f} from chunk=32"
          " — see benchmarks/bench_engine.py for the full sweep)")
    yield {"section": "read_path", "per_item_samples_per_s": per_item_rate,
           "chunked_samples_per_s": chunked_rate}

    # ---- the hot path to the device: uint8 wire + on-chip decode ----
    # device_decode finishes the decode ON the card: batches cross the
    # wire as uint8 (4x fewer bytes than f32) and the fused
    # dequant_normalize_augment kernel (dequant → normalize → flip/crop,
    # one pass) runs right after the copy — zero host-side float math on
    # pixels.  The consumer drains the sink in chunks (get_items) so the
    # batch leg pays one cross-thread hop per chunk.  The host-decode
    # baseline is what every classic pipeline pays per batch: uint8→f32
    # /255, normalize, NCHW transpose — on the consumer's CPU.
    def epoch(device_decode: bool):
        dd = DeviceDecode(mean=MEAN, std=STD) if device_decode else None
        p = build_image_loader(
            shard_ds, batch_size=BATCH, hw=HW, decode_concurrency=4, device=dev,
            device_decode=dd, transfer_chunk=2,
        )
        n, c0 = 0, proc_cpu_s()
        with p.auto_stop():
            p.start()
            while True:
                try:
                    chunk = p.get_items(2)  # chunked sink drain
                except StopIteration:
                    break
                for b in chunk:
                    if device_decode:
                        x = b["images"]  # already NCHW bf16, decoded on the card
                    else:  # classic host float tail
                        x = b["images"].cpu().numpy().astype(np.float32) / 255.0
                        x = (x - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
                        x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dev)
                    n += x.shape[0]
            sync(dev)
        return n, proc_cpu_s() - c0, p

    # load the fused decode outside the measured window (the kernel's
    # library builds at its first launch)
    from repro_torch.kernels.ops import dequant_normalize_augment

    dequant_normalize_augment(torch.zeros((BATCH, *HW, 3), dtype=torch.uint8, device=dev), mean, std)
    sync(dev)

    n_host, cpu_host, _ = epoch(device_decode=False)
    n_dev, cpu_dev, pipe = epoch(device_decode=True)
    wire_mb = BATCH * HW[0] * HW[1] * 3 / 2**20
    print(f"\nhot path to the device ({n_dev} images/epoch):"
          f"\n  wire bytes/batch:  {wire_mb:.2f}MB uint8"
          f" (vs {wire_mb * 4:.2f}MB as f32 — x4 off the wire)"
          f"\n  host CPU/epoch:    {cpu_host:.2f}s host-decode baseline"
          f" -> {cpu_dev:.2f}s with on-chip fused decode")
    print(pipe.format_stats())  # note the device-decode and sink rows
    yield {"section": "hot_path", "images": n_dev, "host_decode_images": n_host,
           "host_cpu_s": cpu_host, "device_decode_cpu_s": cpu_dev}

    # same shards behind a simulated-latency remote + local cache: the
    # prefetcher overlaps shard fetch with decode, the dashboard shows the
    # cache doing its job.  This run doubles as the flight-recorder
    # walkthrough: tracing() installs the tracer process-wide, trace= hands
    # it to the engine/queues/transfer, and the capture lands in a
    # Perfetto-loadable JSON with one track per worker thread.
    prefetcher = ShardPrefetcher(
        SimulatedLatencySource(LocalShardSource(d + "/shards"), latency_s=0.01),
        d + "/cache",
        max_bytes=1 << 30,
    )
    remote_ds = ShardDataset(d + "/shards", prefetcher=prefetcher)
    with tracing() as tracer:
        pipe = build_image_loader(
            remote_ds, batch_size=BATCH, hw=HW, decode_concurrency=4, device=dev,
            sampler=shard_sampler(remote_ds), trace=tracer,
        )
        n_img, dt = consume(pipe, mean, std)
    print(f"\nSPDL (remote shards + cache): {n_img / dt:.0f} img/s")
    print(pipe.format_stats())
    remote_ds.close()

    trace_path = os.environ.get(
        "REPRO_TRACE_PATH",
        str(pathlib.Path(__file__).resolve().parent / "imagenet_trace.json"),
    )
    tracer.export(trace_path)
    cats = {e.get("cat") for e in tracer.events()} - {None}
    print(f"flight recorder: {len(tracer)} spans across "
          f"{sorted(cats)} -> {trace_path} "
          "(open at https://ui.perfetto.dev)")
    yield {"section": "remote", "images": n_img, "seconds": dt, "spans": len(tracer),
           "trace_path": trace_path}

    # the same shards over a REAL http server (loopback, Range-capable): a
    # bare URL root builds HttpShardSource → RetryingSource →
    # ShardPrefetcher, and the loader's lookahead feeds index-first sample
    # hints so narrow windows fetch ranges, not whole shards
    with serve_shards(d + "/shards") as srv:
        http_ds = ShardDataset(srv.url, cache_dir=d + "/http_cache")
        pipe = build_image_loader(
            http_ds, batch_size=BATCH, hw=HW, decode_concurrency=4, device=dev,
            sampler=shard_sampler(http_ds),
        )
        n_img, dt = consume(pipe, mean, std)
        print(f"\nSPDL (HTTP shards + cache): {n_img / dt:.0f} img/s "
              f"({srv.requests} requests, "
              f"{srv.bytes_served / 2**20:.1f}MB served)")
        print(pipe.format_stats())
        yield {"section": "http", "images": n_img, "seconds": dt, "requests": srv.requests}

        # peer shard exchange: "rank A" above warmed its cache — serve it
        # over a PeerShardServer and let "rank B" read the whole epoch
        # through the origin → retry → peers → prefetcher stack.  Only what
        # rank A never fetched falls through to the origin.
        with PeerShardServer(http_ds.prefetcher) as peer:
            origin_before = srv.requests
            peer_ds = ShardDataset(srv.url, cache_dir=d + "/peer_cache", peers=[peer.url])
            pipe = build_image_loader(
                peer_ds, batch_size=BATCH, hw=HW, decode_concurrency=4, device=dev,
                sampler=shard_sampler(peer_ds),
            )
            n_img, dt = consume(pipe, mean, std)
            origin = srv.requests - origin_before
            print(f"\nSPDL (peer shards, rank B): {n_img / dt:.0f} img/s "
                  f"({origin} origin requests, "
                  f"{peer.stats()['bytes_served'] / 2**20:.1f}MB "
                  f"peer-served)")
            print(pipe.format_stats())
            peer_ds.close()
        http_ds.close()
        yield {"section": "peers", "images": n_img, "seconds": dt, "origin_requests": origin}

        # warm restart: a rank dies and comes back with its cache directory
        # intact.  With persist_cache=True the prefetcher writes a manifest
        # + sparse span sidecars (fsync+rename, crash-safe) on close; the
        # restarted rank re-opens resident shards and spans from disk
        # instead of re-fetching them.
        warm_dir = d + "/warm_cache"
        run1 = ShardDataset(srv.url, cache_dir=warm_dir, persist_cache=True)
        for i in range(len(run1)):
            run1[i]  # epoch 1: fill the cache
        run1.close()  # "crash": state persisted on the way down

        origin_before = srv.requests
        run2 = ShardDataset(srv.url, cache_dir=warm_dir, persist_cache=True)
        for i in range(len(run2)):
            run2[i]  # epoch 2: served from the restored cache
        reused = run2.prefetcher.stats()["warm_restart_bytes_reused"]
        origin = srv.requests - origin_before
        print(f"\nwarm restart: {reused / 2**20:.1f}MB re-opened from "
              f"the persisted cache, {origin} "
              "origin requests on the resumed epoch")
        run2.close()
        yield {"section": "warm_restart", "bytes_reused": reused, "origin_requests": origin}

    # ---- columnar shards + projection pushdown (format v2) ------------
    # pack image + caption as named fields of a columnar v2 shard, then
    # train image-only with fields=("image",): caption bytes never cross
    # the wire, and the shard-cache line grows skipped=/fields= counters.
    v2_ds = pack(
        ImageCaptionSource(files_ds), d + "/shards_v2", samples_per_shard=SHARD_SAMPLES,
        format_version=2,
    )
    print(
        f"\npacked {len(v2_ds)} samples into columnar v2 shards, "
        f"fields: {', '.join(v2_ds.schema_fields)}"
    )
    print(f"caption field rides along: "
          f"{bytes(v2_ds.read_fields(0)['caption'])[:28]!r}... "
          f"({len(v2_ds.read_fields(0)['caption']) / 1024:.0f}KB/sample)")
    with serve_shards(d + "/shards_v2") as srv:
        # fields= on the dataset pins the projection for every read
        proj_ds = ShardDataset(srv.url, cache_dir=d + "/proj_cache", fields=("image",))
        pipe = build_image_loader(
            proj_ds, batch_size=BATCH, hw=HW, decode_concurrency=4, device=dev,
            fields=("image",), sampler=shard_sampler(proj_ds),
        )
        n_img, dt = consume(pipe, mean, std)
        stats = proj_ds.prefetcher.stats()
        print(f"\nSPDL (HTTP v2 shards, image-only projection): "
              f"{n_img / dt:.0f} img/s "
              f"({srv.bytes_served / 2**20:.1f}MB on the wire, "
              f"{stats['bytes_skipped'] / 2**20:.1f}MB skipped — "
              "caption column never fetched)")
        print(pipe.format_stats())
        proj_ds.close()
        yield {"section": "projection", "images": n_img, "seconds": dt,
               "bytes_served": srv.bytes_served, "bytes_skipped": stats["bytes_skipped"]}
    v2_ds.close()

    # baselines: the seed per-file dataset through the same pipeline, and
    # the PyTorch-style multiprocessing loader
    pipe = build_image_loader(files_ds, batch_size=BATCH, hw=HW, decode_concurrency=4, device=dev)
    n_img, dt = consume(pipe, mean, std)
    print(f"\nSPDL (per-file): {n_img / dt:.0f} img/s")
    yield {"section": "per_file", "images": n_img, "seconds": dt}

    loader = MPLoader(files_ds, batch_size=BATCH, hw=HW, num_workers=2)
    t0 = time.monotonic()
    n_img = sum(b.shape[0] for b in loader)
    dt = time.monotonic() - t0
    print(f"MPLoader (PyTorch-style, 2 workers): {n_img / dt:.0f} img/s "
          f"(startup {loader.startup_s:.2f}s)")
    yield {"section": "mploader", "images": n_img, "seconds": dt, "startup_s": loader.startup_s}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        return list(run(d, args.device))


if __name__ == "__main__":
    main()
