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
import threading

import numpy as np
import torch

from . import _build

#: the Pallas kernel's ``1.0 / 255.0`` as the f32 it is multiplied in
U8_SCALE = float(np.float32(1.0 / 255.0))

_IN_KINDS = {torch.uint8: 0, torch.float32: 1}
_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1}
#: the kernel stages a window row (and 8 bytes a channel) in shared memory
_MAX_STAGED_BYTES = 128 * 1024


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


def _check_draws(flip, crop, n: int) -> None:
    for d, want in ((flip, (n,)), (crop, (n, 2))):
        if d is not None and tuple(np.shape(d)) != want:
            shapes = [None if v is None else tuple(np.shape(v)) for v in (flip, crop)]
            raise ValueError(f"flip must be ({n},) and crop ({n}, 2); got {shapes[0]}, {shapes[1]}")


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


def _host_array(d) -> np.ndarray:
    """A host draw as an array that int32 assignment casts as
    ``Tensor.to(torch.int32)`` casts it (wrapping, truncating)."""
    if isinstance(d, torch.Tensor):
        return (d if d.dtype == torch.int32 else d.to(torch.int32)).numpy()
    return d if isinstance(d, np.ndarray) else np.asarray(d)


def _pack_draws(dst: np.ndarray, flip, crop) -> None:
    """Write the host draws into ``dst``, (N, 3) int32 rows of (flip, top,
    left) as drawn (zeros for a draw of None): the kernel clamps the crop
    and takes any nonzero flip, as ``_augment_params`` does for the plain
    version."""
    dst[:, 0] = 0 if flip is None else _host_array(flip)
    dst[:, 1:] = 0 if crop is None else _host_array(crop)


class _Staging:
    """Slots of a pinned host buffer and a buffer on the card that host
    draws cross by, used in turn.  A call packs its draws into a slot's host
    buffer; ``dn_launch`` copies them to the slot's card buffer, launches
    the kernel on the same stream and records the slot's event.  A slot is
    written again only after that event, so a call makes one host→device
    copy, allocates nothing (except to grow the slots for a larger batch),
    and the host runs at most ``SLOTS`` calls ahead of the card."""

    SLOTS = 4

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.events = [_lib().dn_event_create(device.index) for _ in range(self.SLOTS)]
        if not all(self.events):
            raise RuntimeError(f"could not create CUDA events on {device}")
        self.slots: list[tuple[torch.Tensor, np.ndarray, torch.Tensor]] = []
        self.turn = 0

    def launch(self, x, mean, std, flip, crop, oh: int, ow: int, scale: float, out_dtype, what: str):
        n = x.shape[0]
        with self.lock:
            if not self.slots or self.slots[0][1].shape[0] < n:
                for event in self.events:
                    _sync(event)
                rows = 1 << (n - 1).bit_length()
                hosts = [torch.empty((rows, 3), dtype=torch.int32, pin_memory=True) for _ in range(self.SLOTS)]
                self.slots = [(host, host.numpy(), torch.empty((rows, 3), dtype=torch.int32, device=self.device))
                              for host in hosts]
            host, view, card = self.slots[self.turn]
            event = self.events[self.turn]
            self.turn = (self.turn + 1) % self.SLOTS
            _sync(event)
            _pack_draws(view[:n], flip, crop)
            return _launch(x, mean, std, card, oh, ow, scale, out_dtype, what, staged=(host.data_ptr(), event))


def _sync(event: int) -> None:
    lib = _lib()
    _build.check(lib, lib.dn_event_sync(event), "dequant_normalize_augment: waiting on a draws slot")


_staging: dict[torch.device, _Staging] = {}


def _card_draws(x: torch.Tensor, flip, crop) -> torch.Tensor:
    """(N, 3) int32 rows of (flip, top, left) as drawn, packed on ``x``'s
    device, for the kernel to clamp (draws of which one lies on the card)."""
    packed = torch.zeros((x.shape[0], 3), dtype=torch.int32, device=x.device)
    if flip is not None:
        packed[:, 0] = torch.as_tensor(flip, device=x.device).to(torch.int32)
    if crop is not None:
        packed[:, 1:] = torch.as_tensor(crop, device=x.device).to(torch.int32)
    return packed


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
    lib.dn_launch.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p, p]
    lib.dn_launch.restype = i
    lib.dn_event_create.argtypes = [i]
    lib.dn_event_create.restype = p
    lib.dn_event_sync.argtypes = [p]
    lib.dn_event_sync.restype = i
    return lib


def _launch(x, mean, std, params, oh: int, ow: int, scale: float, out_dtype, what: str,
            staged: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch the kernel on ``x``'s device and current stream.  ``params``:
    the (N, 3) draws on the card, or None; with ``staged`` = (pinned host
    draws, event), ``params`` is first filled from the host draws and the
    event is recorded after the launch."""
    if not x.is_contiguous() or not mean.is_contiguous() or not std.is_contiguous():
        raise ValueError(f"{what}: x, mean and std must be contiguous")
    n, h, w, c = x.shape
    if ow * c * x.element_size() + 8 * c > _MAX_STAGED_BYTES:
        raise ValueError(f"{what}: a window row of {ow} x {c} {x.dtype} exceeds the "
                         f"{_MAX_STAGED_BYTES} bytes the kernel stages")
    out = torch.empty((n, c, oh, ow), dtype=out_dtype, device=x.device)
    lib = _lib()
    host, done = staged if staged is not None else (None, None)
    err = lib.dn_launch(
        x.data_ptr(), _IN_KINDS[x.dtype], mean.data_ptr(), std.data_ptr(),
        None if params is None else params.data_ptr(), host, out.data_ptr(), _OUT_KINDS[out_dtype],
        n, h, w, c, oh, ow, scale, x.device.index, torch.cuda.current_stream(x.device).cuda_stream, done,
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
    frame.  On the card the kernel clamps the crop; draws given on the host
    cross to it in one copy from a pinned staging buffer."""
    if x.device.type == "cpu":
        return dequant_normalize_augment_plain(
            x, mean, std, flip, crop, out_hw=out_hw, out_dtype=out_dtype
        )
    what = "dequant_normalize_augment"
    _require_cuda(x, what)
    _check(x, mean, std, out_dtype)
    oh, ow = _out_hw(x, out_hw)
    _check_draws(flip, crop, x.shape[0])
    if x.shape[0] == 0 or oh == 0 or ow == 0:
        return torch.empty((x.shape[0], x.shape[3], oh, ow), dtype=out_dtype, device=x.device)
    scale = U8_SCALE if x.dtype == torch.uint8 else 1.0
    if flip is None and crop is None:
        out = _launch(x, mean, std, None, oh, ow, scale, out_dtype, what)
    elif any(isinstance(d, torch.Tensor) and d.device.type != "cpu" for d in (flip, crop)):
        out = _launch(x, mean, std, _card_draws(x, flip, crop), oh, ow, scale, out_dtype, what)
    else:
        staging = _staging.get(x.device)
        if staging is None:
            staging = _staging.setdefault(x.device, _Staging(x.device))
        out = staging.launch(x, mean, std, flip, crop, oh, ow, scale, out_dtype, what)
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
