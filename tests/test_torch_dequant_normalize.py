"""The port's decode-tail kernels against the JAX package's Pallas kernels.

The same inputs, made from a seed with numpy, go through
``repro.kernels.ops`` (Pallas in interpret mode) and through
``repro_torch.kernels.ops`` on CPU tensors, which runs the plain PyTorch
version that the CUDA kernel is held to on the card.  bf16 output may
differ by one bf16 ulp, f32 output by 2e-5 (``torch_parity``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import dequant_normalize as dn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import assert_bf16_within_ulp, assert_f32_close  # noqa: E402

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _sample(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, np.float32)  # [0, 1) float wire


def _stats(c):
    return (
        torch.tensor(MEAN[:c], dtype=torch.float32),
        torch.tensor(STD[:c], dtype=torch.float32),
        jnp.asarray(MEAN[:c], jnp.float32),
        jnp.asarray(STD[:c], jnp.float32),
    )


def _draws(n, h, w, oh, ow, seed=7):
    rng = np.random.default_rng(seed)
    flip = rng.integers(0, 2, n, dtype=np.int32)
    crop = np.stack(
        [rng.integers(0, h - oh + 1, n), rng.integers(0, w - ow + 1, n)], axis=1
    ).astype(np.int32)
    return flip, crop


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize(
    "shape,out_hw",
    [
        ((2, 13, 17, 3), (9, 11)),  # odd sizes, odd crop window
        ((3, 8, 8, 3), None),  # full frame, no crop
        ((1, 5, 5, 1), (5, 3)),  # single sample, single channel, width-only crop
        ((4, 40, 48, 3), (32, 32)),  # the loader test's frames and window
    ],
)
def test_augment_matches_pallas(dtype, shape, out_hw, out_dtype):
    n, h, w, c = shape
    x = _sample(dtype, shape)
    tmean, tstd, jmean, jstd = _stats(c)
    oh, ow = out_hw if out_hw is not None else (h, w)
    flip, crop = _draws(n, h, w, oh, ow)
    got = ops.dequant_normalize_augment(
        torch.from_numpy(x), tmean, tstd, flip, crop,
        out_hw=out_hw, out_dtype=getattr(torch, out_dtype),
    )
    want = jops.dequant_normalize_augment(
        x, jmean, jstd, flip, crop, out_hw=out_hw,
        out_dtype=getattr(jnp, out_dtype), use_pallas="interpret",
    )
    assert tuple(got.shape) == (n, c, oh, ow)
    assert got.dtype == getattr(torch, out_dtype)
    assert got.is_contiguous()
    if out_dtype == "bfloat16":
        assert_bf16_within_ulp(got.float().numpy(), want)
    else:
        assert_f32_close(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_plain_dequant_normalize_matches_pallas(dtype):
    x = _sample(dtype, (3, 7, 10, 3), seed=2)
    tmean, tstd, jmean, jstd = _stats(3)
    got = ops.dequant_normalize(torch.from_numpy(x), tmean, tstd)
    want = jops.dequant_normalize(x, jmean, jstd, use_pallas="interpret")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 3, 7, 10)
    assert_bf16_within_ulp(got.float().numpy(), want)


def test_augment_without_crop_or_flip_is_dequant_normalize():
    """No flip, no crop → the fused kernel IS dequant_normalize (NCHW)."""
    x = torch.from_numpy(_sample(np.uint8, (2, 6, 10, 3)))
    tmean, tstd, _, _ = _stats(3)
    fused = ops.dequant_normalize_augment(x, tmean, tstd)
    plain = ops.dequant_normalize(x, tmean, tstd)
    assert torch.equal(fused, plain)


def test_crop_offsets_are_clamped_like_dynamic_slice():
    x = _sample(np.uint8, (2, 8, 8, 3))
    tmean, tstd, jmean, jstd = _stats(3)
    wild = np.array([[100, 100], [-5, -5]], np.int32)  # way out of bounds
    safe = np.array([[4, 4], [0, 0]], np.int32)  # what clamping yields
    flip = np.array([1, 0], np.int32)
    a = ops.dequant_normalize_augment(torch.from_numpy(x), tmean, tstd, flip, wild, out_hw=(4, 4))
    b = ops.dequant_normalize_augment(torch.from_numpy(x), tmean, tstd, flip, safe, out_hw=(4, 4))
    assert torch.equal(a, b)
    want = jops.dequant_normalize_augment(
        x, jmean, jstd, flip, wild, out_hw=(4, 4), use_pallas="interpret"
    )
    assert_bf16_within_ulp(a.float().numpy(), want)


def test_flip_mirrors_inside_the_cropped_window():
    x = np.arange(1 * 2 * 6 * 1, dtype=np.uint8).reshape(1, 2, 6, 1)
    zero, one = torch.zeros(1), torch.ones(1)
    out = ops.dequant_normalize_augment(
        torch.from_numpy(x), zero, one, np.array([1]), np.array([[0, 1]]),
        out_hw=(2, 3), out_dtype=torch.float32,
    )
    # window columns 1..3 of each row, mirrored: source column 1 + (2 - x)
    want = x[0, :, [3, 2, 1], 0].T.astype(np.float32) * np.float32(dn.U8_SCALE)
    np.testing.assert_array_equal(out[0, 0].numpy(), want)


def test_oversized_window_raises():
    x = torch.from_numpy(_sample(np.uint8, (1, 4, 4, 3)))
    tmean, tstd, _, _ = _stats(3)
    with pytest.raises(ValueError, match="out_hw"):
        ops.dequant_normalize_augment(x, tmean, tstd, out_hw=(8, 8))


@pytest.mark.parametrize(
    "bad",
    [
        {"x": np.zeros((4, 4, 3), np.uint8)},  # not (N, H, W, C)
        {"x": np.zeros((1, 4, 4, 3), np.int32)},  # unsupported input dtype
        {"mean": (0.5, 0.5)},  # stats of the wrong width
        {"out_dtype": torch.float16},  # unsupported output dtype
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = bad.get("x", np.zeros((1, 4, 4, 3), np.uint8))
    mean = torch.tensor(bad.get("mean", MEAN), dtype=torch.float32)
    std = torch.tensor(STD[: mean.shape[0]], dtype=torch.float32)
    with pytest.raises((ValueError, TypeError)):
        ops.dequant_normalize_augment(
            torch.from_numpy(x), mean, std, out_dtype=bad.get("out_dtype", torch.bfloat16)
        )


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (dn.dequant_normalize_augment.launches, dn.dequant_normalize.launches)
    x = torch.from_numpy(_sample(np.uint8, (2, 6, 6, 3)))
    tmean, tstd, _, _ = _stats(3)
    ops.dequant_normalize_augment(x, tmean, tstd, out_hw=(4, 4))
    ops.dequant_normalize(x, tmean, tstd)
    after = (dn.dequant_normalize_augment.launches, dn.dequant_normalize.launches)
    assert after == before


@pytest.mark.parametrize("fn", ["dequant_normalize_augment", "dequant_normalize"])
def test_a_tensor_on_neither_cpu_nor_cuda_raises(fn):
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises, never falling back."""
    x = torch.empty((1, 4, 4, 3), dtype=torch.uint8, device="meta")
    mean = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, fn)(x, mean, mean)
