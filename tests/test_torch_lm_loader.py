"""The port's LM loader against the JAX package's and against ground truth.

The same ``SyntheticTokenDataset`` (one seed, so the same documents) and
the same sampler seed go through both packages' ``build_lm_loader``; the
port's runs with ``device="cpu"``.  Ground truth is the sampler's document
order packed by ``SequencePacker`` directly.  The reference is read on its
collate path: its zero-copy path can deliver a batch from a recycled slab
(ROADMAP F-ref-3), which the port's guards rule out, so the port's
zero-copy path is also run past several slab rings against its collate path.
Documents many rows long (one packer chunk completing more rows than the
slab ring holds) must not block the port's zero-copy path (ROADMAP F-ref-4).
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.data import SyntheticTokenDataset as JTokens  # noqa: E402
from repro.data import build_lm_loader as jbuild_lm_loader  # noqa: E402
from repro_torch.data import CheckpointableSampler, SyntheticTokenDataset, build_lm_loader  # noqa: E402
from repro_torch.data.packing import SequencePacker, collate  # noqa: E402

SEQ, BATCH, SEED = 64, 4, 7
FIELDS = ("tokens", "labels", "positions", "segment_ids")


LONG = dict(min_len=300, max_len=900)  # 5-14 rows a document: a chunk of 16 fills ~150 rows


def _dataset(cls, min_len=16, max_len=80):
    return cls(200, vocab=1000, min_len=min_len, max_len=max_len, seed=3)


def _drain(pipe, n: int) -> list[dict]:
    """Copy each of the first n batches out before the next one arrives."""
    out = []
    with pipe.auto_stop():
        for batch in pipe:
            out.append({k: np.array(np.asarray(batch[k]), copy=True) for k in FIELDS})
            if len(out) == n:
                break
    return out


def _ground_truth(n: int, **lengths) -> list[dict]:
    ds = _dataset(SyntheticTokenDataset, **lengths)
    sampler = CheckpointableSampler(len(ds), batch_size=8, seed=SEED, shuffle=True)
    packer, rows = SequencePacker(SEQ), []
    for ids in sampler:
        for i in ids:
            rows += packer.add(ds[i])
        if len(rows) >= n * BATCH:
            break
    return [collate(rows[j * BATCH:(j + 1) * BATCH]) for j in range(n)]


def _port(zero_copy: bool, lengths: dict | None = None, **kw):
    pipe, _ = build_lm_loader(
        _dataset(SyntheticTokenDataset, **(lengths or {})), seq_len=SEQ, batch_size=BATCH, num_threads=4,
        seed=SEED, zero_copy=zero_copy, device="cpu", **kw,
    )
    return pipe


@pytest.mark.parametrize("zero_copy", [True, False])
def test_batches_equal_the_reference_and_ground_truth(zero_copy):
    n = 8
    ref_pipe, _ = jbuild_lm_loader(
        _dataset(JTokens), seq_len=SEQ, batch_size=BATCH, num_threads=4, seed=SEED, zero_copy=False
    )
    want = _drain(ref_pipe, n)
    got = _drain(_port(zero_copy), n)
    truth = _ground_truth(n)
    assert len(got) == len(want) == n
    for g, w, t in zip(got, want, truth):
        for k in FIELDS:
            assert g[k].dtype == np.int32 and g[k].shape == (BATCH, SEQ)
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(g[k], t[k], err_msg=k)
    assert any((g["segment_ids"] > 0).any() for g in got)  # rows pack several documents


@pytest.mark.parametrize("transfer_chunk", [1, 2])
def test_zero_copy_equals_collate_past_the_slab_ring(transfer_chunk):
    """40 batches through a ring of 8 or 9 slabs: each slab is reused four times
    or more while earlier batches are still held, and no delivered batch
    changes after delivery."""
    n = 40
    kept = _drain(_port(True, transfer_chunk=transfer_chunk), n)
    want = _drain(_port(False, transfer_chunk=transfer_chunk), n)
    assert len(kept) == len(want) == n
    for g, w in zip(kept, want):
        for k in FIELDS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_delivered_batches_do_not_alias_slabs():
    """The CPU transfer copies slab rows: batches kept past the consumer
    window (here all 30, never copied by the consumer) stay as delivered."""
    pipe = _port(True)
    held = []
    with pipe.auto_stop():
        for batch in pipe:
            held.append(batch)
            if len(held) == 30:
                break
    truth = _ground_truth(30)
    for g, t in zip(held, truth):
        for k in FIELDS:
            np.testing.assert_array_equal(g[k].numpy(), t[k], err_msg=k)


@pytest.mark.parametrize("zero_copy", [True, False])
def test_documents_longer_than_the_slab_ring(zero_copy):
    """Each 16-document packer chunk completes about 150 rows, several times
    the ring's 24-36: the zero-copy path binds slots after the packer, so
    the batches still come, equal to the reference's and to ground truth."""
    n = 12
    ref_pipe, _ = jbuild_lm_loader(
        _dataset(JTokens, **LONG), seq_len=SEQ, batch_size=BATCH, num_threads=4, seed=SEED, zero_copy=False
    )
    want = _drain(ref_pipe, n)
    pipe, got = _port(zero_copy, LONG), []
    reader = threading.Thread(target=lambda: got.extend(_drain(pipe, n)), daemon=True)
    reader.start()
    reader.join(timeout=60)
    if reader.is_alive():
        pipe.stop()  # closes the arena, which wakes a blocked slot wait
        pytest.fail("the loader blocked")
    truth = _ground_truth(n, **LONG)
    assert len(got) == len(want) == n
    for g, w, t in zip(got, want, truth):
        for k in FIELDS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(g[k], t[k], err_msg=k)
