"""The sharded record store in the port, held to the JAX package's.

Frames are materialized by the reference (16x16 RGB, seeded), packed into
shards of 8 and read back through the port's ``ShardDataset`` (local mmap,
a simulated-latency remote, HTTP from ``serve_shards``, the peer tier) into
the port's ``build_image_loader`` on the CPU.  Every delivered batch is
held to a ground truth built from ``decode_sample`` and ``resize_nearest``
in sampler order, and to the reference's loader over the same shards.  The
reference side runs ``zero_copy=False``: its zero-copy image loader can
recycle a slab under a batch it delivered (ROADMAP F-ref-3).

Servers bind loopback ports; every wait is bounded by the sources'
timeouts, ``HealthMonitor``'s ``stalled_after_s`` or an event timeout.
"""

import pathlib
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import data as ref_data  # noqa: E402
from repro.data import shards as ref_shards  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FaultInjectingStage,
    HealthMonitor,
    MetricsExporter,
    PipelineStalled,
    autotune,
    disable_verify,
    suggest,
)
from repro_torch.data import (  # noqa: E402
    CheckpointableSampler,
    LocalShardSource,
    PeerShardServer,
    ShardDataset,
    ShardPrefetcher,
    ShardReader,
    SimulatedLatencySource,
    SyntheticImageDataset,
    SyntheticTokenDataset,
    build_image_loader,
    build_lm_loader,
    pack,
)
from repro_torch.data.baselines import MPLoader  # noqa: E402
from repro_torch.data.codec import decode_sample, resize_nearest  # noqa: E402
from repro_torch.data.shards.testing import serve_shards  # noqa: E402

N, HW, PER_SHARD, BATCH, EPOCHS = 48, (16, 16), 8, 8, 2
SAMPLER = dict(batch_size=BATCH, seed=0, shard_window=16)


class _Captioned:
    """A two-column source: each frame's encoded image and a short caption."""

    schema_fields = ("image", "caption")

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    @staticmethod
    def caption(i: int) -> bytes:
        return b"a photo of synthetic frame %d" % i

    def read_fields(self, i, fields=None):
        blobs = {"image": self.frames.read_bytes(i), "caption": self.caption(i)}
        return {f: blobs[f] for f in (fields or self.schema_fields)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(frames dir, v1 shard dir, v2 image+caption shard dir), packed once."""
    root = tmp_path_factory.mktemp("corpus")
    ref_data.SyntheticImageDataset.materialize(root / "frames", N, hw=HW, seed=0)
    frames = SyntheticImageDataset(root / "frames")
    pack(frames, root / "v1", samples_per_shard=PER_SHARD).close()
    pack(_Captioned(frames), root / "v2", samples_per_shard=PER_SHARD, format_version=2).close()
    return root / "frames", root / "v1", root / "v2"


def _sampler(ds, cls=CheckpointableSampler):
    return cls(len(ds), shard_sizes=ds.shard_sizes, **SAMPLER)


def _truth(frames_dir, shard_sizes, hw=HW) -> list[np.ndarray]:
    """The loader's batches by hand: the sampler's indices, decoded and
    resized in order, cut into batches."""
    frames = SyntheticImageDataset(frames_dir)
    sampler = CheckpointableSampler(N, shard_sizes=shard_sizes, **SAMPLER)
    order = []
    for k, batch in enumerate(sampler):
        if k >= sampler.batches_per_epoch() * EPOCHS:
            break
        order += batch
    imgs = [resize_nearest(decode_sample(frames.read_bytes(i)), hw) for i in order]
    return [np.stack(imgs[j:j + BATCH]) for j in range(0, len(imgs) - BATCH + 1, BATCH)]


def _drain(pipe) -> list[np.ndarray]:
    with pipe.auto_stop():
        return [np.array(np.asarray(b["images"]), copy=True) for b in pipe]


def _port_loader(ds, **kw):
    return build_image_loader(
        ds, batch_size=BATCH, hw=HW, sampler=_sampler(ds), epochs=EPOCHS, device="cpu",
        read_concurrency=2, decode_concurrency=2, num_threads=4, **kw,
    )


def _ref_batches(ds) -> list[np.ndarray]:
    pipe = ref_data.build_image_loader(
        ds, batch_size=BATCH, hw=HW, sampler=_sampler(ds, ref_data.CheckpointableSampler),
        epochs=EPOCHS, zero_copy=False, read_concurrency=2, decode_concurrency=2, num_threads=4,
    )
    return _drain(pipe)


def _assert_batches(got, want):
    assert len(got) == len(want) == N * EPOCHS // BATCH
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_shard_written_by_either_package_reads_in_the_other(corpus, tmp_path, writer, version):
    frames_dir = corpus[0]
    frames = SyntheticImageDataset(frames_dir)
    write, read = (pack, ref_shards.ShardDataset) if writer == "port" else (ref_shards.pack, ShardDataset)
    kw = {"format_version": 2, "fields": ("image",)} if version == 2 else {}
    write(frames, tmp_path / "out", samples_per_shard=PER_SHARD, **kw).close()
    other = ref_shards.pack if writer == "port" else pack
    other(frames, tmp_path / "again", samples_per_shard=PER_SHARD, **kw).close()
    for name in sorted(p.name for p in (tmp_path / "out").iterdir()):
        assert (tmp_path / "out" / name).read_bytes() == (tmp_path / "again" / name).read_bytes(), name
    ds = read(tmp_path / "out")
    assert ds.format_version == version and len(ds) == N
    for i in range(N):
        blob = ds.read_fields(i)["image"] if version == 2 else ds.read_bytes(i)
        assert bytes(blob) == frames.read_bytes(i)
    ds.close()


@pytest.mark.parametrize("where", ["local", "simulated", "http"])
def test_image_loader_over_shards_matches_the_truth_and_the_reference(corpus, tmp_path, where):
    """Local shards read as zero-copy mmap views decoded into the slab; the
    remote runs fetch through the prefetcher, whose cache counters ride the
    read stage's row: a budget of two shards makes every epoch miss and
    evict, while the samples of a resident shard hit."""
    frames_dir, v1, _ = corpus
    want = _truth(frames_dir, [PER_SHARD] * (N // PER_SHARD))
    budget = 2 * max(p.stat().st_size for p in v1.glob("*.rpshard"))

    def open_both(server=None):
        if where == "local":
            return ShardDataset(v1), ref_shards.ShardDataset(v1)
        if where == "simulated":
            return tuple(cls(v1, prefetcher=pf_cls(SimulatedLatencySource(src_cls(v1), latency_s=0.002),
                                                   tmp_path / name, max_bytes=budget))
                         for cls, pf_cls, src_cls, name in (
                             (ShardDataset, ShardPrefetcher, LocalShardSource, "port"),
                             (ref_shards.ShardDataset, ref_shards.ShardPrefetcher, ref_shards.LocalShardSource, "ref")))
        return tuple(cls(server.url, cache_dir=tmp_path / name, cache_bytes=budget, http_timeout=10.0)
                     for cls, name in ((ShardDataset, "port"), (ref_shards.ShardDataset, "ref")))

    def run(server=None):
        port_ds, ref_ds = open_both(server)
        pipe = _port_loader(port_ds)
        got = _drain(pipe)
        read = {s.name: s for s in pipe.stats()}["read"]
        ref = _ref_batches(ref_ds)
        stats = port_ds.prefetcher.stats() if port_ds.prefetcher is not None else None
        port_ds.close()
        ref_ds.close()
        return got, ref, read, stats

    if where == "http":
        with serve_shards(v1) as srv:
            got, ref, read, stats = run(srv)
    else:
        got, ref, read, stats = run()
    _assert_batches(got, want)
    _assert_batches(ref, want)
    assert read.num_failed == 0
    if where == "local":
        assert stats is None
    else:
        assert read.cache_hits > 0 and read.cache_misses > 0
        assert stats["evictions"] > 0 and stats["bytes_fetched"] > 0


def test_field_projection_never_fetches_a_caption_byte(corpus, tmp_path):
    """A v2 corpus of image and caption columns read over HTTP with
    ``fields=("image",)``: every shard enters the cache as a projected
    sparse entry, and the origin serves no more than the shard files'
    bytes less their caption columns."""
    frames_dir, _, v2 = corpus
    want = _truth(frames_dir, [PER_SHARD] * (N // PER_SHARD))
    captions = sum(len(_Captioned.caption(i)) for i in range(N))
    files = sum(p.stat().st_size for p in v2.glob("*.rpshard")) + (v2 / "manifest.json").stat().st_size
    with serve_shards(v2) as srv:
        ds = ShardDataset(srv.url, fields=("image",), cache_dir=tmp_path / "cache", http_timeout=10.0)
        ds.prefetcher.sparse_threshold = 1.0  # the image column is most of a shard: fetch it sparse anyway
        ds.prefetcher.promote_threshold = None  # a sparse→full upgrade fetches whole shards, captions too
        got = _drain(_port_loader(ds, fields=("image",)))
        stats = ds.prefetcher.stats()
        with srv.lock:
            served = srv.bytes_served
        ds.close()
    _assert_batches(got, want)
    assert stats["sparse_shards"] == N // PER_SHARD and stats["fields_requested"] == 1
    assert stats["bytes_skipped"] > 0
    assert served <= files - captions


def _corrupt(shard_path: pathlib.Path, samples) -> None:
    r = ShardReader(shard_path)
    offsets = [int(r.offsets[k]) + 12 for k in samples]
    r.close()
    raw = bytearray(shard_path.read_bytes())
    for off in offsets:
        raw[off] ^= 0xFF
    shard_path.write_bytes(raw)


def test_a_corrupt_sample_is_a_hole_and_a_corrupt_tail_pins_no_slab(corpus, tmp_path):
    """Two corrupt samples in the middle: two holes, dense batches.  A
    corrupt tail: the last slab is sealed and recycled, so the drained
    loader holds as many slabs as a clean run's."""
    frames = SyntheticImageDataset(corpus[0])
    in_flight, counts = {}, {}
    for case, bad in (("clean", []), ("middle", [(1, (2, 5))]), ("tail", [(5, (6, 7))])):
        ds = pack(frames, tmp_path / case, samples_per_shard=PER_SHARD)
        for shard, samples in bad:
            _corrupt(ds.root / ds.shard_names[shard], samples)
        ds = ShardDataset(tmp_path / case)
        pipe = build_image_loader(
            ds, batch_size=6, hw=HW, num_threads=4, device="cpu",
            sampler=CheckpointableSampler(len(ds), batch_size=1, shuffle=False),
        )
        batches = _drain(pipe)
        stats = {s.name: s for s in pipe.stats()}
        counts[case] = (len(batches), stats["read"].num_failed)
        in_flight[case] = stats["batch"].slabs_in_flight
        good = [i for i in range(N) if not any(i // PER_SHARD == s and i % PER_SHARD in k for s, k in bad)]
        flat = np.concatenate(batches)
        np.testing.assert_array_equal(flat, np.stack([frames[i] for i in good[:len(flat)]]))
        ds.close()
    assert counts == {"clean": (8, 0), "middle": (7, 2), "tail": (7, 2)}
    assert in_flight["tail"] == in_flight["clean"] == in_flight["middle"]


def test_a_second_rank_reads_from_the_first_ranks_warm_cache(corpus, tmp_path):
    frames_dir, v1, _ = corpus
    want = _truth(frames_dir, [PER_SHARD] * (N // PER_SHARD))
    with serve_shards(v1) as origin:
        rank_a = ShardDataset(origin.url, cache_dir=tmp_path / "a", http_timeout=10.0)
        for name in rank_a.shard_names:
            rank_a.prefetcher.reader(name)
        with PeerShardServer(rank_a.prefetcher) as peer:
            before = origin.requests
            rank_b = ShardDataset(origin.url, cache_dir=tmp_path / "b", peers=[peer.url],
                                  peer_timeout=2.0, http_timeout=10.0)
            got = _drain(_port_loader(rank_b))
            stats = rank_b.prefetcher.stats()
            rank_b.close()
            assert origin.requests == before + 1  # rank b's manifest; every shard byte from the peer
        rank_a.close()
    _assert_batches(got, want)
    assert stats["source_peer_hits"] > 0 and stats["source_peer_bytes"] > 0


def test_health_monitor_raises_on_a_stuck_source_instead_of_hanging(corpus, tmp_path):
    """Reads past sample 20 block on an event: the guard degrades (the
    prefetcher's eager verification goes) and then raises
    ``PipelineStalled`` naming a stage, in well under the event's timeout."""
    import threading

    frames_dir, v1, _ = corpus
    release = threading.Event()
    with serve_shards(v1) as srv:
        ds = ShardDataset(srv.url, cache_dir=tmp_path / "cache", http_timeout=10.0)
        read = ds.read_bytes

        def stuck(i):
            if i >= 20:
                release.wait(timeout=30)
            return read(i)

        ds.read_bytes = stuck
        pipe = build_image_loader(ds, batch_size=4, hw=HW, num_threads=4, device="cpu",
                                  sampler=CheckpointableSampler(len(ds), batch_size=1, shuffle=False))
        mon = HealthMonitor(pipe, degraded_after_s=0.2, stalled_after_s=0.6,
                            actions=[disable_verify(ds.prefetcher)])
        got = []
        with pipe.auto_stop():
            with pytest.raises(PipelineStalled) as err:
                for batch in mon.guard(tick=0.05):
                    got.append(batch)
            release.set()
        assert not ds.prefetcher.verify_on_install
        ds.close()
    assert err.value.stage and len(got) <= 5
    assert mon.applied_actions() == ["disable_verify"]


def _fault_injected_run(v1, batch: int) -> None:
    """The loader over ``v1`` with 20% of reads failed, drained on a thread
    within 30 s: a loader that blocks is stopped and fails the test."""
    import threading

    ds = ShardDataset(v1)
    chaos = FaultInjectingStage(ds.read_bytes, seed=7, error_rate=0.2)
    ds.read_bytes = chaos
    pipe = build_image_loader(ds, batch_size=batch, hw=HW, num_threads=4, device="cpu",
                              sampler=CheckpointableSampler(len(ds), batch_size=1, shuffle=False))
    batches = []
    reader = threading.Thread(target=lambda: batches.extend(_drain(pipe)), daemon=True)
    reader.start()
    reader.join(timeout=30)
    if reader.is_alive():
        pipe.stop()  # closes the arena, which wakes a blocked slot wait
        ds.close()
        pytest.fail("the loader blocked")
    failed = {s.name: s for s in pipe.stats()}["read"].num_failed
    ds.close()
    errors = chaos.stats()["injected_errors"]
    assert errors == 6 and failed == errors  # the seed's draws fail reads 7, 16, 20, 24, 27 and 32
    assert len(batches) == (N - errors) // batch
    assert all(b.shape == (batch, *HW, 3) for b in batches)


def test_fault_injected_reads_become_holes_and_batches_stay_dense(corpus):
    _fault_injected_run(corpus[1], BATCH)


def test_fault_injected_reads_at_batch_4_end_with_dense_batches(corpus):
    """At a batch of 4 a chunk of 16 binds four slabs before it hands a row
    on; the ring counts them (ROADMAP F-ref-5), so the run ends."""
    _fault_injected_run(corpus[1], 4)


def test_metrics_exporter_serves_the_stage_and_shard_cache_families(corpus, tmp_path):
    """The exporter's text over loopback, scraped after an epoch: the
    families the reference's exporter renders for the reference's loader,
    and the port's slab arena beside them."""
    _, v1, _ = corpus
    families = {}
    with serve_shards(v1) as srv:
        for name, mod, exporter_cls in (("port", None, MetricsExporter),
                                        ("ref", ref_data, pytest.importorskip("repro.core").MetricsExporter)):
            dcls = ShardDataset if mod is None else ref_shards.ShardDataset
            ds = dcls(srv.url, cache_dir=tmp_path / name, http_timeout=10.0)
            kw = {"device": "cpu"} if mod is None else {"zero_copy": False}
            build = build_image_loader if mod is None else ref_data.build_image_loader
            pipe = build(ds, batch_size=BATCH, hw=HW, num_threads=4, **kw)
            exporter = exporter_cls()
            exporter.add_pipeline(pipe, name="images")
            with pipe.auto_stop():
                for _ in pipe:
                    pass
                with exporter.serve() as server:
                    text = urllib.request.urlopen(server.url, timeout=10).read().decode()
            ds.close()
            families[name] = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
            assert 'stage="read"' in text
    # the reference reads on its collate path (F-ref-3), which has no slab arena
    assert families["port"] - families["ref"] == {"repro_arena_slabs_in_flight", "repro_arena_bytes_allocated"}
    assert families["ref"] <= families["port"]
    for family in ("repro_stage_items_out_total", "repro_shard_cache_hits_total",
                   "repro_shard_fetched_bytes_total", "repro_arena_slabs_in_flight"):
        assert family in families["port"], family


def test_suggest_and_autotune_read_a_port_pipeline(corpus):
    _, v1, _ = corpus
    ds = ShardDataset(v1)

    def factory(conc):
        return build_image_loader(ds, batch_size=4, hw=HW, num_threads=4, device="cpu", epochs=2,
                                  read_concurrency=conc.get("read", 1), decode_concurrency=conc.get("decode", 1),
                                  sampler=CheckpointableSampler(len(ds), batch_size=1, shuffle=False))

    def probe(pipe):
        return float(sum(1 for _ in pipe))

    pipe = factory({})
    with pipe.auto_stop():
        for _ in pipe:
            pass
        hint = suggest(pipe)
    assert hint.reason
    best, log = autotune(factory, probe, rounds=2)
    ds.close()
    assert isinstance(best, dict) and 1 <= len(log) <= 2
    assert all(row["rate"] == 2 * N / 4 for row in log)


def test_lm_loader_over_shards_equals_the_in_memory_run(tmp_path):
    docs = SyntheticTokenDataset(40, vocab=97, min_len=8, max_len=40, seed=3)
    pack(docs, tmp_path / "docs", samples_per_shard=8).close()

    def run(ds, n=6):
        pipe, _ = build_lm_loader(ds, seq_len=32, batch_size=4, device="cpu", seed=1, read_concurrency=2,
                                  sampler=CheckpointableSampler(len(ds), batch_size=4, seed=1))
        out = []
        with pipe.auto_stop():
            for batch in pipe:
                out.append({k: v.clone() for k, v in batch.items()})
                if len(out) == n:
                    break
        return out

    want = run(docs)
    with serve_shards(tmp_path / "docs") as srv:
        ds = ShardDataset(srv.url, cache_dir=tmp_path / "cache", http_timeout=10.0)
        got = run(ds)
        ds.close()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k]), k


def test_mp_loader_reads_a_local_shard_dataset(corpus):
    """The process-pool baseline: each spawned worker unpickles the port's
    dataset (and so imports the port) and sends its batches back over a pipe."""
    frames_dir, v1, _ = corpus
    frames = SyntheticImageDataset(frames_dir)
    ds = ShardDataset(v1)
    got = list(MPLoader(ds, batch_size=BATCH, hw=(12, 12), num_workers=2))
    ds.close()
    assert len(got) == N // BATCH
    for j, batch in enumerate(got):
        want = np.stack([resize_nearest(frames[i], (12, 12)) for i in range(j * BATCH, (j + 1) * BATCH)])
        np.testing.assert_array_equal(batch, want)



def test_the_origin_fixture_answers_ranges_as_the_reference_does(corpus):
    """The port's ``serve_shards`` reads only the requested range; its
    answers (status, Content-Range, body) equal the reference's for a
    range, an open-ended range, one past the end, and a whole shard."""
    import http.client
    import urllib.parse

    from repro.data.shards.testing import serve_shards as ref_serve_shards

    _, v1, _ = corpus
    name = sorted(p.name for p in v1.glob("*.rpshard"))[2]
    size = (v1 / name).stat().st_size
    answers = {}
    for which, serve in (("port", serve_shards), ("ref", ref_serve_shards)):
        with serve(v1) as srv:
            host = urllib.parse.urlsplit(srv.url)
            conn = http.client.HTTPConnection(host.hostname, host.port, timeout=10)
            got = []
            for header in ("bytes=100-4099", f"bytes={size - 10}-", f"bytes={size}-", None):
                conn.request("GET", f"/{name}", headers={"Range": header} if header else {})
                r = conn.getresponse()
                got.append((r.status, r.getheader("Content-Range"), r.read()))
            conn.close()
            answers[which] = got
    assert answers["port"] == answers["ref"]
    assert [status for status, _, _ in answers["port"]] == [206, 206, 416, 200]
    assert answers["port"][0][2] == (v1 / name).read_bytes()[100:4100]
