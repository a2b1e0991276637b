"""The slice as a whole: the port's image loader against the JAX package's.

One dataset is materialized on disk by the reference and opened by both
packages.  Both loaders run with the same batch size, sampler seed and
``DeviceDecode``; the port's runs with ``device="cpu"``.  Host batches must
be byte-identical, decoded batches within one bf16 ulp, and a sampler
checkpoint taken from the reference's loader must resume the port's loader
where the reference's own resumed loader goes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.data import CheckpointableSampler as JSampler  # noqa: E402
from repro.data import SyntheticImageDataset as JDataset  # noqa: E402
from repro.data import build_image_loader as jbuild_image_loader  # noqa: E402
from repro.data.transfer import DeviceDecode as JDeviceDecode  # noqa: E402
from repro_torch.data import CheckpointableSampler, SyntheticImageDataset, build_image_loader  # noqa: E402
from repro_torch.data.transfer import DeviceDecode  # noqa: E402
from torch_parity import assert_bf16_within_ulp  # noqa: E402

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
N_FRAMES, HW, BATCH, SEED = 48, (40, 48), 8, 3
AUGMENT = dict(mean=MEAN, std=STD, out_hw=(32, 32), flip=True, crop=True, seed=11)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    JDataset.materialize(root, N_FRAMES, hw=HW, seed=0)
    return root


def _drain(pipe, to_numpy, limit=None) -> list[np.ndarray]:
    """Copy each delivered image batch out before the next one arrives (a
    delivered host batch aliases a slab that the loader recycles)."""
    out = []
    with pipe.auto_stop():
        for batch in pipe:
            out.append(np.array(to_numpy(batch["images"]), dtype=np.float32, copy=True))
            if limit is not None and len(out) == limit:
                break
    return out


def _reference(frames, sampler, device_decode=None, **kw):
    pipe = jbuild_image_loader(
        JDataset(frames), batch_size=BATCH, hw=HW, sampler=sampler,
        device_decode=device_decode, read_concurrency=2, decode_concurrency=2,
        num_threads=4, **kw,
    )
    return pipe


def _port(frames, sampler, device_decode=None, **kw):
    return build_image_loader(
        SyntheticImageDataset(frames), batch_size=BATCH, hw=HW, sampler=sampler,
        device_decode=device_decode, read_concurrency=2, decode_concurrency=2,
        num_threads=4, device="cpu", **kw,
    )


def _jnp(a):
    return np.asarray(a, np.float32)


def _tnp(t):
    return t.float().numpy()


@pytest.mark.parametrize("zero_copy", [True, False])
def test_host_batches_are_byte_identical(frames, zero_copy):
    want = _drain(
        _reference(frames, JSampler(N_FRAMES, batch_size=4, seed=SEED), zero_copy=zero_copy),
        _jnp,
    )
    got = _drain(
        _port(frames, CheckpointableSampler(N_FRAMES, batch_size=4, seed=SEED), zero_copy=zero_copy),
        _tnp,
    )
    assert len(got) == len(want) == N_FRAMES // BATCH
    for g, w in zip(got, want):
        assert g.shape == (BATCH, *HW, 3)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("transfer_chunk", [1, 2])
def test_decoded_batches_match_within_one_bf16_ulp(frames, transfer_chunk):
    want = _drain(
        _reference(
            frames, JSampler(N_FRAMES, batch_size=4, seed=SEED),
            JDeviceDecode(**AUGMENT, use_pallas="interpret"), transfer_chunk=transfer_chunk,
        ),
        _jnp,
    )
    got = _drain(
        _port(
            frames, CheckpointableSampler(N_FRAMES, batch_size=4, seed=SEED),
            DeviceDecode(**AUGMENT), transfer_chunk=transfer_chunk,
        ),
        _tnp,
    )
    assert len(got) == len(want) == N_FRAMES // BATCH
    for g, w in zip(got, want):
        assert g.shape == (BATCH, 3, 32, 32)
        assert_bf16_within_ulp(g, w)


def test_reference_sampler_checkpoint_resumes_the_port(tmp_path):
    """What a job carries between the packages is the sampler checkpoint:
    the port's sampler takes the reference's ``state_dict()`` unchanged."""
    n = 4 * N_FRAMES  # long enough that the loader's read-ahead stops mid-epoch
    JDataset.materialize(tmp_path, n, hw=HW, seed=1)
    sampler = JSampler(n, batch_size=4, seed=SEED)
    narrow = dict(chunk=1, sink_buffer=1, transfer_chunk=1)
    _drain(_reference(tmp_path, sampler, epochs=None, **narrow), _jnp, limit=1)
    state = sampler.state_dict()
    assert state["epoch"] == 0 and 0 < state["cursor"] < sampler.batches_per_epoch()

    resumed_ref = JSampler(n, batch_size=4, seed=0)
    resumed_ref.load_state_dict(dict(state))
    resumed_port = CheckpointableSampler(n, batch_size=4, seed=0)
    resumed_port.load_state_dict(dict(state))
    assert resumed_port.state_dict() == state
    want = _drain(_reference(tmp_path, resumed_ref), _jnp)
    got = _drain(_port(tmp_path, resumed_port), _tnp)
    assert len(got) == len(want) == n // BATCH
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
