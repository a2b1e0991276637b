"""uint8 → bf16 dequantize + normalize (+ augment): the image path's decode tail.

The loader ships image batches to the card as **uint8** (4x fewer
host→device bytes than f32) and these functions expand them on the card:
``(x * scale - mean_c) * (1 / std_c)``, emitted NCHW.

``dequant_normalize_augment`` — the whole decode tail in one pass: a
per-sample (top, left) crop to a fixed output window, a per-sample
horizontal flip inside that window, dequant and normalize.  This is what
``DeviceTransfer``'s ``device_decode`` dispatches.
``dequant_normalize`` — dequant + normalize of the full frame.

Each wrapper dispatches on the device of ``x``: a CPU tensor goes through
the plain PyTorch version beside it (``*_plain``), a CUDA tensor launches
the hand-written kernel in ``csrc/dequant_normalize.cu`` (or raises), and
each launch adds one to the wrapper's ``launches`` count.  The arithmetic
is the Pallas body's (``src/repro/kernels/dequant_normalize.py``), not the
``ref.py`` oracle's: multiply by 1/255 and by 1/std rather than divide,
all in f32, which can differ from dividing by one bf16 ulp.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

#: the Pallas kernel's ``1.0 / 255.0`` as the f32 it is multiplied in
U8_SCALE = float(np.float32(1.0 / 255.0))

_IN_KINDS = {torch.uint8: 0, torch.float32: 1}
_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1}


def _check(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, out_dtype) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C); got shape {tuple(x.shape)}")
    if x.dtype not in _IN_KINDS:
        raise TypeError(f"x must be uint8 or float32; got {x.dtype}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"out_dtype must be bfloat16 or float32; got {out_dtype}")
    c = x.shape[3]
    for name, t in (("mean", mean), ("std", std)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be float32 of shape ({c},); got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _augment_params(x: torch.Tensor, flip, crop, oh: int, ow: int) -> torch.Tensor:
    """(N, 3) int32 rows of (flip, top, left), crop clamped into
    [0, H-oh] x [0, W-ow] (``lax.dynamic_slice`` semantics), on the device
    the draws were given on (the host, for numpy draws)."""
    n, h, w, _ = x.shape
    flip = None if flip is None else torch.as_tensor(flip)
    crop = None if crop is None else torch.as_tensor(crop)
    given = [t for t in (flip, crop) if t is not None]
    dev = given[0].device if given else torch.device("cpu")
    flip = torch.zeros(n, dtype=torch.int32, device=dev) if flip is None else flip.to(dev, torch.int32)
    crop = torch.zeros((n, 2), dtype=torch.int32, device=dev) if crop is None else crop.to(dev, torch.int32)
    if tuple(flip.shape) != (n,) or tuple(crop.shape) != (n, 2):
        raise ValueError(f"flip must be ({n},) and crop ({n}, 2); got {tuple(flip.shape)}, {tuple(crop.shape)}")
    crop = crop.clamp(min=0)
    top, left = crop[:, 0].clamp(max=h - oh), crop[:, 1].clamp(max=w - ow)
    return torch.stack([(flip != 0).to(torch.int32), top, left], dim=1)


def _out_hw(x: torch.Tensor, out_hw) -> tuple[int, int]:
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw if out_hw is not None else (h, w)
    if oh > h or ow > w:
        raise ValueError(f"out_hw={out_hw} exceeds input frame {(h, w)}")
    return oh, ow


def _normalize_nchw(win: torch.Tensor, mean, std, scale: float, out_dtype) -> torch.Tensor:
    y = win.to(torch.float32) * scale
    y = (y - mean) * (1.0 / std)
    return y.permute(0, 3, 1, 2).to(out_dtype, memory_format=torch.contiguous_format)


def dequant_normalize_augment_plain(
    x, mean, std, flip=None, crop=None, *, out_hw=None, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """Plain PyTorch version of ``dequant_normalize_augment`` (any device)."""
    _check(x, mean, std, out_dtype)
    oh, ow = _out_hw(x, out_hw)
    params = _augment_params(x, flip, crop, oh, ow).to(x.device, torch.int64)
    flip_, top, left = params.unbind(1)
    rows = top[:, None] + torch.arange(oh, device=x.device)
    cols = torch.arange(ow, device=x.device)
    cols = left[:, None] + torch.where(flip_[:, None] != 0, ow - 1 - cols, cols)
    n = torch.arange(x.shape[0], device=x.device)[:, None, None]
    win = x[n, rows[:, :, None], cols[:, None, :]]  # (N, oh, ow, C)
    scale = U8_SCALE if x.dtype == torch.uint8 else 1.0
    return _normalize_nchw(win, mean, std, scale, out_dtype)


def dequant_normalize_plain(x, mean, std, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of ``dequant_normalize`` (any device)."""
    _check(x, mean, std, out_dtype)
    return _normalize_nchw(x, mean, std, U8_SCALE, out_dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("dequant_normalize")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dn_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.dn_launch.restype = i
    return lib


def _launch(x, mean, std, params, oh: int, ow: int, scale: float, out_dtype, what: str) -> torch.Tensor:
    if not x.is_contiguous() or not mean.is_contiguous() or not std.is_contiguous():
        raise ValueError(f"{what}: x, mean and std must be contiguous")
    n, h, w, c = x.shape
    if n > 65535:
        raise ValueError(f"{what}: batch {n} exceeds the grid's 65535 samples")
    out = torch.empty((n, c, oh, ow), dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dn_launch(
            x.data_ptr(), _IN_KINDS[x.dtype], mean.data_ptr(), std.data_ptr(),
            None if params is None else params.data_ptr(), out.data_ptr(),
            _OUT_KINDS[out_dtype], n, h, w, c, oh, ow, scale, stream,
        )
    _build.check(lib, err, what)
    return out


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must lie on the CPU or a CUDA device; got {x.device}")


def dequant_normalize_augment(
    x: torch.Tensor,  # (N, H, W, C) uint8, or float32 already in [0, 1]
    mean: torch.Tensor,  # (C,) float32, on x's device
    std: torch.Tensor,  # (C,) float32, on x's device
    flip=None,  # (N,) nonzero = horizontal flip; tensor or array, any device
    crop=None,  # (N, 2) (top, left) window offsets; tensor or array, any device
    *,
    out_hw: tuple[int, int] | None = None,  # None = full frame
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Fused decode tail: crop → flip → dequant → normalize → NCHW.

    Returns (N, C, out_h, out_w) ``out_dtype``.  Crop offsets are clamped
    in-bounds; integer input is dequantized by 1/255, float input is taken
    as [0, 1] already.  Raises ``ValueError`` when ``out_hw`` exceeds the
    frame.  Draws given on the host are copied to the card from pinned
    memory without a host sync."""
    if x.device.type == "cpu":
        return dequant_normalize_augment_plain(
            x, mean, std, flip, crop, out_hw=out_hw, out_dtype=out_dtype
        )
    what = "dequant_normalize_augment"
    _require_cuda(x, what)
    _check(x, mean, std, out_dtype)
    oh, ow = _out_hw(x, out_hw)
    params = _augment_params(x, flip, crop, oh, ow)
    if params.device != x.device:
        params = params.pin_memory().to(x.device, non_blocking=True)
    if x.shape[0] == 0 or oh == 0 or ow == 0:
        return torch.empty((x.shape[0], x.shape[3], oh, ow), dtype=out_dtype, device=x.device)
    scale = U8_SCALE if x.dtype == torch.uint8 else 1.0
    out = _launch(x, mean, std, params, oh, ow, scale, out_dtype, what)
    dequant_normalize_augment.launches += 1
    return out


def dequant_normalize(
    x: torch.Tensor,  # (N, H, W, C) uint8
    mean: torch.Tensor,  # (C,) float32, on x's device
    std: torch.Tensor,  # (C,) float32, on x's device
    *,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Returns (N, C, H, W) ``out_dtype``: ``(x / 255 - mean) / std``."""
    if x.device.type == "cpu":
        return dequant_normalize_plain(x, mean, std, out_dtype=out_dtype)
    what = "dequant_normalize"
    _require_cuda(x, what)
    _check(x, mean, std, out_dtype)
    n, h, w, c = x.shape
    if x.numel() == 0:
        return torch.empty((n, c, h, w), dtype=out_dtype, device=x.device)
    out = _launch(x, mean, std, None, h, w, U8_SCALE, out_dtype, what)
    dequant_normalize.launches += 1
    return out


dequant_normalize_augment.launches = 0
dequant_normalize.launches = 0
