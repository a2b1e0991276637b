"""The port's ``DeviceTransfer`` against the JAX package's, on the CPU.

Ports of the transfer tests of ``test_device_decode.py`` and of
``test_zero_copy.py::test_transfer_hold_window_protects_delivered_batches``,
run with ``device="cpu"``, plus a check that a seed draws the reference's
flips and crops.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.data.transfer import DeviceDecode as JDeviceDecode  # noqa: E402
from repro.data.transfer import DeviceTransfer as JDeviceTransfer  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.data.arena import SlabArena  # noqa: E402
from repro_torch.data.transfer import DeviceDecode, DeviceTransfer, to_uint8_wire  # noqa: E402
from torch_parity import assert_bf16_within_ulp  # noqa: E402

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _batches(k, n=2, hw=(6, 6), seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"images": rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)}
        for _ in range(k)
    ]


# ---------------------------------------------------------------------------
# uint8 wire contract
# ---------------------------------------------------------------------------
def test_uint8_wire_uint8_passes_through_without_copy():
    a = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    assert to_uint8_wire(a) is a


def test_uint8_wire_rejects_out_of_range_floats():
    with pytest.raises(ValueError, match="uint8_wire"):
        to_uint8_wire(np.full((1, 4, 4, 3), 17.0, np.float32))
    with pytest.raises(ValueError, match="uint8_wire"):
        to_uint8_wire(np.full((4, 4, 3), -0.5, np.float64))


def test_uint8_wire_non_image_payloads_pass_through():
    labels = np.arange(8, dtype=np.int64)
    assert to_uint8_wire(labels) is labels
    scalar = np.float32(0.5)
    assert to_uint8_wire(scalar) is scalar


@pytest.mark.parametrize("shape", [(3, 9, 7, 3), (4, 4, 3)])
def test_uint8_wire_matches_the_reference(shape):
    from repro.data.transfer import to_uint8_wire as jto_uint8_wire

    x = np.random.default_rng(0).random(shape, np.float32)
    x.flat[0] = 1.0 + 5e-4  # resize/antialias overshoot stays legal
    np.testing.assert_array_equal(to_uint8_wire(x), jto_uint8_wire(x))


# ---------------------------------------------------------------------------
# DeviceTransfer on the CPU
# ---------------------------------------------------------------------------
def test_transfer_many_dispatches_in_order():
    tr = DeviceTransfer("cpu", uint8_wire=True)
    batches = _batches(3)
    out = tr.transfer_many(list(batches))
    assert len(out) == 3
    assert tr.num_batches == 3
    for o, b in zip(out, batches):
        assert isinstance(o["images"], torch.Tensor)
        np.testing.assert_array_equal(o["images"].numpy(), b["images"])


def test_transfer_counts_the_bytes_the_reference_counts():
    imgs = np.random.default_rng(0).random((4, 8, 8, 3)).astype(np.float32)
    scalars = np.arange(4, dtype=np.float32)
    for wire in (True, False):
        tr = DeviceTransfer("cpu", uint8_wire=wire)
        ref = JDeviceTransfer(uint8_wire=wire)
        out = tr({"images": imgs, "t": scalars})
        ref({"images": imgs, "t": scalars})
        assert tr.bytes_moved == ref.bytes_moved
        assert out["images"].dtype == (torch.uint8 if wire else torch.float32)


def test_transfer_device_decode_matches_reference_and_counts():
    dd = DeviceDecode(mean=MEAN, std=STD)
    tr = DeviceTransfer("cpu", uint8_wire=True, device_decode=dd)
    batches = _batches(2, seed=3)
    out = tr.transfer_many([dict(b) for b in batches])
    for o, b in zip(out, batches):
        assert o["images"].dtype == torch.bfloat16
        want = jref.dequant_normalize_ref(
            jnp.asarray(b["images"]),
            jnp.asarray(MEAN, jnp.float32),
            jnp.asarray(STD, jnp.float32),
        )
        assert_bf16_within_ulp(o["images"].float().numpy(), want)
    probe = tr.stats()
    assert probe["device_decode_batches"] == 2
    assert probe["device_decode_ms"] > 0.0


@pytest.mark.parametrize("crop", [True, False])
def test_augment_draws_match_the_reference_per_seed(crop):
    """Same seed → the same flips and crops as the JAX package's transfer,
    batch after batch (draw order: flip, then top, then left)."""
    kw = dict(mean=MEAN, std=STD, out_hw=(4, 5), flip=True, crop=crop, seed=42)
    tr = DeviceTransfer("cpu", device_decode=DeviceDecode(**kw))
    ref = JDeviceTransfer(device_decode=JDeviceDecode(**kw, use_pallas="interpret"))
    for b in _batches(3, n=5, hw=(9, 8), seed=9):
        got = tr(dict(b))["images"]
        want = ref(dict(b))["images"]
        assert_bf16_within_ulp(got.float().numpy(), want)


def test_augment_is_deterministic_per_seed_and_varies_across_seeds():
    def run(seed):
        dd = DeviceDecode(mean=MEAN, std=STD, out_hw=(4, 4), flip=True, crop=True, seed=seed)
        tr = DeviceTransfer("cpu", uint8_wire=True, device_decode=dd)
        return tr(_batches(1, hw=(6, 6), seed=9)[0])["images"]

    a, b = run(42), run(42)
    assert torch.equal(a, b)
    assert tuple(a.shape) == (2, 3, 4, 4)
    assert not torch.equal(run(42), run(43))


def test_transfer_decode_skips_batches_without_the_field():
    tr = DeviceTransfer("cpu", device_decode=DeviceDecode(mean=MEAN, std=STD))
    out = tr({"tokens": np.arange(8, dtype=np.int32)})
    assert out["tokens"].dtype == torch.int32
    assert tr.stats()["device_decode_batches"] == 0


def test_hold_window_grows_with_dispatch_chunk():
    for kw in ({"consumer_window": 3}, {"consumer_window": 3, "dispatch_chunk": 4}):
        assert DeviceTransfer("cpu", **kw).hold_slabs == JDeviceTransfer(**kw).hold_slabs
    assert DeviceTransfer("cpu", consumer_window=3).hold_slabs == 5
    assert DeviceTransfer("cpu", consumer_window=3, dispatch_chunk=4).hold_slabs == 8


def test_transfer_hold_window_protects_delivered_batches():
    """Recycling a slab must never corrupt a delivered batch, inside the
    hold window or past it: the CPU path copies slab rows out, so even the
    batch whose slab went back to the arena stays intact.  The rows are
    slab-sized (440 KB) as in the JAX package's test."""
    tr = DeviceTransfer("cpu", consumer_window=0)  # hold = 2
    n = tr.hold_slabs
    assert n == 2
    row = 384 * 384 * 3  # the image loader's slab row
    arena = SlabArena({"x": ((row,), np.uint8)}, batch_size=4, num_slabs=n + 1)
    outs = []
    for i in range(n + 1):
        s = arena.acquire()
        s.arrays["x"][:] = i
        outs.append(tr(s.as_batch()))
    # n+1 transfers -> exactly one slab (batch 0's) was recycled; scribble it
    s = arena.acquire()
    s.arrays["x"][:] = 255
    for i in range(n + 1):
        assert bool((outs[i]["x"] == i).all()), f"batch {i} corrupted"
    tr.flush()
    assert arena.slabs_in_flight == 1  # only the scribbled slab is still out
