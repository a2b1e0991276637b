"""A failed read at small batches: the port's loaders end, with dense batches.

One ``read_bytes`` index raises.  The image loader's chunked slot binder
hands a chunk's rows on only once the whole chunk is bound, and behind the
failed read each batch takes its last row from the next slab; a ring sized
without that run-ahead blocked for good at a batch of 4 and a chunk of 16
(ROADMAP F-ref-5).  Each case drains the pipe on a thread joined with its
own limit, so a regression fails here instead of hanging the suite, and
holds every batch to ground truth (the clean frames in sampler order, the
failed one left out, cut into batches) and to the JAX package's loader on
its collate path with the same failed read.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import data as ref_data  # noqa: E402
from repro_torch.data import (  # noqa: E402
    CheckpointableSampler,
    SyntheticImageDataset,
    SyntheticTokenDataset,
    build_image_loader,
    build_lm_loader,
)
from repro_torch.data.codec import decode_sample, resize_nearest  # noqa: E402
from repro_torch.data.packing import SequencePacker, collate  # noqa: E402

N, HW, LIMIT_S = 64, (16, 16), 30.0
SEQ, LM_SEED, LM_BATCHES = 32, 7, 12
LM_FIELDS = ("tokens", "labels", "positions", "segment_ids")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    ref_data.SyntheticImageDataset.materialize(root, N, hw=HW, seed=0)
    return root


def _failing(ds, *bad: int):
    """``ds`` with ``read_bytes`` raising at each of ``bad``, every other
    read unchanged."""
    read = ds.read_bytes

    def read_bytes(i):
        if i in bad:
            raise OSError(f"planted failed read of sample {i}")
        return read(i)

    ds.read_bytes = read_bytes
    return ds


def _drain_within(pipe, copy, limit: int | None = None) -> list:
    """Every batch (or the first ``limit``), drained on a thread joined
    within ``LIMIT_S``; a loader that blocks is stopped and fails."""
    got: list = []

    def drain():
        with pipe.auto_stop():
            for batch in pipe:
                got.append(copy(batch))
                if limit is not None and len(got) == limit:
                    break

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    reader.join(timeout=LIMIT_S)
    if reader.is_alive():
        pipe.stop()  # closes the arena, which wakes a blocked slot wait
        pytest.fail(f"the loader blocked after {len(got)} batches")
    return got


def _images(batch) -> np.ndarray:
    return np.array(np.asarray(batch["images"]), copy=True)


def _truth(frames, bad: int, batch: int) -> list[np.ndarray]:
    ds = SyntheticImageDataset(frames)
    imgs = [resize_nearest(decode_sample(ds.read_bytes(i)), HW) for i in range(N) if i != bad]
    return [np.stack(imgs[j:j + batch]) for j in range(0, len(imgs) - batch + 1, batch)]


def _sampler(cls=CheckpointableSampler):
    return cls(N, batch_size=1, shuffle=False)


@pytest.mark.parametrize(
    "batch,chunk,bad,zero_copy",
    [
        (4, 16, 7, True),
        (4, 16, 30, True),
        (2, 16, 7, True),
        (8, 16, 7, True),
        (4, 1, 7, True),
        (1, 16, 5, True),
        (3, 16, 7, True),
        (4, 16, 7, False),
    ],
)
def test_one_failed_read_ends_with_dense_batches(frames, batch, chunk, bad, zero_copy):
    pipe = build_image_loader(
        _failing(SyntheticImageDataset(frames), bad), batch_size=batch, hw=HW, chunk=chunk,
        zero_copy=zero_copy, sampler=_sampler(), device="cpu",
        read_concurrency=2, decode_concurrency=2, num_threads=4,
    )
    got = _drain_within(pipe, _images)
    failed = {s.name: s for s in pipe.stats()}["read"].num_failed
    want = _truth(frames, bad, batch)
    assert failed == 1
    assert len(got) == len(want) == (N - 1) // batch
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if (batch, chunk) == (4, 16):  # the reference's collate path, the same failed read
        ref = ref_data.build_image_loader(
            _failing(ref_data.SyntheticImageDataset(frames), bad), batch_size=batch, hw=HW,
            chunk=chunk, zero_copy=False, sampler=_sampler(ref_data.CheckpointableSampler),
            read_concurrency=2, decode_concurrency=2, num_threads=4,
        )
        for g, r in zip(got, _drain_within(ref, _images), strict=True):
            np.testing.assert_array_equal(g, r)


def test_every_failed_read_in_a_burst_still_ends(frames):
    """Every fifth read fails: at a batch of 4 the floor covers the
    assembling slabs of any hole pattern (see ``_ring_size``)."""
    bad = range(3, N, 5)
    pipe = build_image_loader(_failing(SyntheticImageDataset(frames), *bad), batch_size=4, hw=HW,
                              sampler=_sampler(), device="cpu", read_concurrency=2, decode_concurrency=2,
                              num_threads=4)
    got = _drain_within(pipe, _images)
    clean = SyntheticImageDataset(frames)
    imgs = [resize_nearest(decode_sample(clean.read_bytes(i)), HW) for i in range(N) if i not in bad]
    assert len(got) == (N - len(bad)) // 4
    np.testing.assert_array_equal(np.concatenate(got), np.stack(imgs[:4 * len(got)]))


@pytest.mark.parametrize(
    "batch,chunk,transfer_chunk,floor",
    [(4, 16, 2, 13), (8, 16, 2, 11), (4, 1, 2, 10), (128, 16, 2, 10), (2, 16, 4, 21)],
)
def test_arena_slabs_below_the_floor_raises_naming_it(frames, batch, chunk, transfer_chunk, floor):
    """The floor is the transfer's hold (sink buffer 3 + 1 + the transfer
    chunk), 2 + max(2, transfer chunk) in flight, and ``(chunk - 1) //
    batch`` slabs of the binder's run-ahead; one slab fewer raises."""
    ds = SyntheticImageDataset(frames)
    kw = dict(batch_size=batch, hw=HW, chunk=chunk, transfer_chunk=transfer_chunk, device="cpu")
    with pytest.raises(ValueError, match=f"deadlock floor {floor} "):
        build_image_loader(ds, arena_slabs=floor - 1, **kw)
    for slabs in (floor, None):  # the floor explicitly, and by default
        pipe = build_image_loader(ds, arena_slabs=slabs, **kw)
        assert len(_drain_within(pipe, _images)) == N // batch
        assert {s.name: s for s in pipe.stats()}["batch"].num_slabs == floor


def _lm_truth(ds, bad: int, batch: int) -> list[dict]:
    sampler = CheckpointableSampler(len(ds), batch_size=8, seed=LM_SEED, shuffle=True)
    packer, rows = SequencePacker(SEQ), []
    for ids in sampler:
        for i in ids:
            if i != bad:
                rows += packer.add(decode_sample(ds.read_bytes(i)))
        if len(rows) >= LM_BATCHES * batch:
            break
    return [collate(rows[j * batch:(j + 1) * batch]) for j in range(LM_BATCHES)]


def _lm_rows(batch) -> dict:
    return {k: np.array(np.asarray(batch[k]), copy=True) for k in LM_FIELDS}


@pytest.mark.parametrize("batch,zero_copy", [(1, True), (2, True), (4, True), (2, False)])
def test_lm_loader_one_failed_read_at_small_batches(batch, zero_copy):
    """The LM loader binds one row at a time after the packer, so a failed
    document read only leaves the document out: the packed rows are those
    of the other documents, as the reference's collate path packs them."""
    def dataset(cls):
        return cls(200, vocab=1000, min_len=16, max_len=80, seed=3)

    ds = dataset(SyntheticTokenDataset)
    bad = CheckpointableSampler(len(ds), batch_size=8, seed=LM_SEED, shuffle=True)._epoch_order(0)[5]
    pipe, _ = build_lm_loader(
        _failing(dataset(SyntheticTokenDataset), int(bad)), seq_len=SEQ, batch_size=batch,
        seed=LM_SEED, zero_copy=zero_copy, device="cpu", num_threads=4,
    )
    got = _drain_within(pipe, _lm_rows, LM_BATCHES)
    ref, _ = ref_data.build_lm_loader(
        _failing(dataset(ref_data.SyntheticTokenDataset), int(bad)), seq_len=SEQ,
        batch_size=batch, seed=LM_SEED, zero_copy=False, num_threads=4,
    )
    want = _drain_within(ref, _lm_rows, LM_BATCHES)
    truth = _lm_truth(ds, int(bad), batch)
    assert len(got) == len(want) == LM_BATCHES
    for g, w, t in zip(got, want, truth):
        for k in LM_FIELDS:
            assert g[k].shape == (batch, SEQ)
            np.testing.assert_array_equal(g[k], t[k], err_msg=k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
