"""The port's decode-tail kernels against the JAX package's Pallas kernels.

The same inputs, made from a seed with numpy, go through
``repro.kernels.ops`` (Pallas in interpret mode) and through
``repro_torch.kernels.ops`` on CPU tensors, which runs the plain PyTorch
version that the CUDA kernel is held to on the card.  bf16 output may
differ by one bf16 ulp, f32 output by 2e-5 (``torch_parity``).
"""

import pathlib
import re

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


# ---------------------------------------------------------------------------
# what the CUDA wrapper computes on the host, and the kernel's staging
# rehearsed on the CPU (the kernel itself runs only on the card)
# ---------------------------------------------------------------------------


def _kernel_clamp(packed: np.ndarray, h, w, oh, ow) -> np.ndarray:
    """The kernel's reading of a packed row (``csrc/dequant_normalize.cu``):
    any nonzero flip mirrors, the crop is clamped into the frame."""
    return np.stack(
        [packed[:, 0] != 0, np.clip(packed[:, 1], 0, h - oh), np.clip(packed[:, 2], 0, w - ow)], axis=1
    ).astype(np.int32)


@pytest.mark.parametrize(
    "flip,crop",
    [
        (np.array([0, 1, 1, 0]), np.array([[0, 0], [4, 4], [1, 3], [2, 0]])),  # in range
        (np.array([2, -1, 7, 0]), None),  # flips other than 0 and 1; no crop
        (None, np.array([[-5, -1], [100, 100], [-7, 9], [4, -2]], np.int64)),  # wild offsets; no flip
        (np.array([True, False, True, True]), [[3, 1], [0, 5], [9, 9], [-1, 2]]),  # bool flips, list crop
        (torch.tensor([1, 0, 3, 0]), torch.tensor([[1, 2], [3, 4], [-3, 4], [40, 0]])),  # CPU tensors
        (np.array([1, 0, 1, 0], np.int64) + (1 << 32), np.array([[2, 2]] * 4) - (1 << 32)),  # wrap to int32
        (None, None),
    ],
    ids=["in_range", "wild_flips", "wild_offsets", "bool_list", "tensors", "int64_wrap", "none"],
)
def test_packed_draws_are_as_drawn_and_the_kernels_clamp_gives_the_plain_params(flip, crop):
    n, h, w, oh, ow = 4, 8, 9, 4, 5
    packed = np.full((n, 3), 12345, np.int32)
    dn._pack_draws(packed, flip, crop)
    want_flip = np.zeros(n, np.int64) if flip is None else np.asarray(flip).astype(np.int64)
    want_crop = np.zeros((n, 2), np.int64) if crop is None else np.asarray(crop).astype(np.int64)
    as_int32 = lambda a: ((a + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)  # noqa: E731
    np.testing.assert_array_equal(packed[:, 0], as_int32(want_flip))
    np.testing.assert_array_equal(packed[:, 1:], as_int32(want_crop))
    x = torch.zeros((n, h, w, 3), dtype=torch.uint8)
    np.testing.assert_array_equal(
        _kernel_clamp(packed, h, w, oh, ow), dn._augment_params(x, flip, crop, oh, ow).numpy()
    )


@pytest.mark.parametrize(
    "flip,crop",
    [(np.zeros(3), None), (None, np.zeros((4, 3))), (np.zeros((4, 1)), np.zeros((4, 2))), ([0, 1], None)],
)
def test_draws_of_the_wrong_shape_raise_before_any_copy(flip, crop):
    with pytest.raises(ValueError, match=r"flip must be \(4,\) and crop \(4, 2\)"):
        dn._check_draws(flip, crop, 4)
    with pytest.raises(ValueError, match="flip must be"):
        dn._augment_params(torch.zeros((4, 6, 6, 3), dtype=torch.uint8), flip, crop, 4, 4)


def test_draws_of_the_right_shape_pass_the_check():
    dn._check_draws(None, None, 4)
    dn._check_draws(np.zeros(4), [[0, 0]] * 4, 4)
    dn._check_draws(torch.zeros(4), None, 4)


def _cu_constant(name: str) -> int:
    src = (pathlib.Path(dn.__file__).parent / "csrc" / "dequant_normalize.cu").read_text()
    expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", src).group(1)
    return int(np.prod([int(f) for f in expr.split("*")]))


def _rehearse_kernel(x: np.ndarray, mean, std, params, oh: int, ow: int, out_dtype) -> torch.Tensor:
    """``dn_rows`` step by step on a flat byte view of ``x``: blocks of
    ``rows`` output rows, each row's crop span staged in 16-byte words
    (words reaching past either end of x copied byte by byte), then read
    back at the span's offset inside its first word.  Staging bytes no word
    writes hold a poison value, so a word the kernel would miss shows."""
    n, h, w, c = x.shape
    flat = x.reshape(-1).view(np.uint8)
    isz = x.itemsize
    span = ow * c * isz
    stride = (span + 30) // 16 * 16
    stats = (2 * c * 4 + 15) // 16 * 16
    rows = max(1, min(_cu_constant("kMaxRows"), oh, (_cu_constant("kRowBudget") - stats) // stride))
    tiles = -(-oh // rows)
    scale = np.float32(dn.U8_SCALE if x.dtype == np.uint8 else 1.0)
    inv = np.float32(1.0) / std  # __fdiv_rn: correctly rounded, as numpy's f32 division
    out = np.empty((n, c, oh, ow), np.float32)
    packed = np.zeros((n, 3), np.int32) if params is None else params
    for block in range(n * tiles):
        s, y0 = block // tiles, block % tiles * rows
        flip, top, left = _kernel_clamp(packed, h, w, oh, ow)[s]
        first0 = ((s * h + top + y0) * w + left) * c * isz
        for r in range(min(rows, oh - y0)):
            staged = np.full(stride, 0xA5, np.uint8)
            first = first0 + r * w * c * isz
            end = first + span
            for k in range(stride // 16):
                a = (first & ~15) + 16 * k
                if a >= end:
                    continue
                if a >= 0 and a + 16 <= flat.size:
                    staged[16 * k:16 * k + 16] = flat[a:a + 16]
                else:
                    for b in range(max(a, first), min(a + 16, end)):
                        staged[16 * k + b - a] = flat[b]
            off = first & 15
            assert off + span <= stride
            pix = staged[off:off + span].view(x.dtype).reshape(ow, c)
            if flip:
                pix = pix[::-1]
            y = (pix.astype(np.float32) * scale - mean) * inv
            out[s, :, y0 + r, :] = y.T
    return torch.from_numpy(out).to(out_dtype)


@pytest.mark.parametrize(
    "shape,dtype,out_hw,corner,out_dtype",
    [
        ((3, 13, 17, 3), np.uint8, (9, 11), False, torch.bfloat16),  # 51-byte rows, ragged tiles
        ((3, 13, 17, 3), np.uint8, (9, 11), True, torch.bfloat16),  # last span ends at x's last byte
        ((2, 20, 24, 3), np.uint8, (16, 16), True, torch.float32),  # 16-byte-aligned rows
        ((1, 12, 22, 3), np.uint8, (10, 13), False, torch.bfloat16),  # batch 1, odd left offsets
        ((2, 9, 10, 3), np.float32, (5, 7), True, torch.bfloat16),  # f32 in
        ((2, 7, 5, 1), np.uint8, None, False, torch.bfloat16),  # whole frame, one channel (K2's path)
    ],
)
def test_the_kernels_row_staging_rehearsed_on_the_cpu_equals_the_plain_version(
    shape, dtype, out_hw, corner, out_dtype
):
    n, h, w, c = shape
    x = _sample(dtype, shape, seed=5)
    tmean, tstd, _, _ = _stats(c)
    oh, ow = out_hw if out_hw is not None else (h, w)
    params = None
    flip = crop = None
    if out_hw is not None:
        flip, crop = _draws(n, h, w, oh, ow, seed=11)
        if corner:
            crop = np.tile(np.array([[h - oh, w - ow]], np.int32), (n, 1))
        crop[:, 1] |= 1 if w - ow >= 1 and not corner else 0  # odd left: spans start mid-word
        params = np.full((n, 3), 0, np.int32)
        dn._pack_draws(params, flip, crop)
    got = _rehearse_kernel(x, tmean.numpy(), tstd.numpy(), params, oh, ow, out_dtype)
    want = dn.dequant_normalize_augment_plain(
        torch.from_numpy(x), tmean, tstd, flip, crop, out_hw=out_hw, out_dtype=out_dtype
    )
    assert torch.equal(got, want)
