"""Device transfer stage (paper §5.7.2) for PyTorch on a CUDA card.

``DeviceTransfer`` is the terminal pipe stage: it moves a host batch onto
``device`` (``torch.device("cuda")`` unless the caller asks for the CPU).
Per §2.1 there must be at most ONE transfer task: build the stage with
``concurrency=1`` (the loader does).

On CUDA the host→device copy runs on a dedicated copy stream (the paper's
"separate stream"), from the slab's pinned host memory with
``non_blocking=True``, so it overlaps the consumer's step.  An event
recorded on the copy stream after the copy orders it before everything the
consumer's stream does with the batch: the transfer makes the current
stream wait on it before the decode kernel, or before handing the raw batch
on, and marks each device tensor with ``record_stream`` because it was
allocated on the copy stream and is read on another.  Nothing on the hot
path synchronises the device.

``uint8_wire=True`` makes uint8 the end-to-end wire contract: slab rows
arrive uint8 and pass through untouched, [0, 1] float image payloads are
downcast (out-of-range floats raise), and the card expands to bf16.

``device_decode=DeviceDecode(mean, std, ...)`` finishes the decode on the
card: right after the copy the transfer dispatches the fused
``dequant_normalize_augment`` kernel (dequant, per-channel normalize,
per-sample flip and crop, NCHW out).  Augment draws come from a seeded
numpy generator in the JAX package's order (flip, then top, then left), so
a seed gives the same flips and crops in both packages.  Dispatch cost is
counted in ``device_decode_ms`` and reaches the transfer stage's stats row
through the ``stats()`` probe.

Double buffering (zero-copy arena path): a batch from an ``aggregate_into``
stage carries its owning slab under ``SLAB_KEY``.  The transfer keeps the
last ``hold_slabs`` slabs (default ``consumer_window + 1 + dispatch_chunk``)
and releases the oldest back to the arena only as new transfers are issued.
On CUDA a slab additionally waits for its copy event before it is released
(nearly always complete by then), so a delivered batch never shares memory
with a slab.  On the CPU a slab's rows are copied into the delivered
tensors: the window counts one dispatch chunk in the transfer worker, but
the engine's ordered runner starts the next chunks while an earlier one
waits for room in the sink, so batches that alias a slab can outlive it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from ..core import trace as _trace
from .arena import SLAB_KEY

#: absolute slack allowed past [0, 1] before a float wire payload is
#: rejected — covers resize/antialias ringing, not wrong normalization
_WIRE_EPS = 1e-3


def to_uint8_wire(v: Any) -> Any:
    """Downcast a [0,1]-normalized float image payload to the uint8 wire
    format (inverse of the on-chip ``x/255`` dequant).

    Already-uint8 arrays pass through unchanged — the zero-copy slab path
    ships uint8 natively and must not pay a copy here.  Float image
    payloads outside [0, 1] (beyond a tiny epsilon) raise ``ValueError``:
    silently clipping them would corrupt every pixel the consumer trains
    on, loudly is the only acceptable failure mode.  Anything that is not
    a floating-point image-shaped array passes through unchanged.
    """
    if (
        isinstance(v, np.ndarray)
        and v.dtype in (np.float32, np.float64)
        and v.ndim >= 3  # (H, W, C) or (N, H, W, C): image-like payloads only
    ):
        if v.size:
            lo, hi = float(v.min()), float(v.max())
            if lo < -_WIRE_EPS or hi > 1.0 + _WIRE_EPS:
                raise ValueError(
                    f"uint8_wire expects [0,1]-normalized floats "
                    f"(normalize_to_float convention); got range [{lo:.4g}, "
                    f"{hi:.4g}] — normalize on-chip via device_decode "
                    "instead of pre-scaling on the host"
                )
        return np.clip(np.rint(v * 255.0), 0.0, 255.0).astype(np.uint8)
    return v


@dataclasses.dataclass(frozen=True)
class DeviceDecode:
    """Config for the on-chip fused decode tail behind ``DeviceTransfer``.

    ``mean``/``std`` are per-channel (C,) stats in [0,1] units (the
    ImageNet convention).  ``out_hw`` crops every sample to a static
    window (random per-sample offsets when ``crop=True``, centered
    otherwise); ``flip=True`` mirrors each sample with p=0.5.  Augment
    randomness comes from a seeded numpy generator on the host — integer
    draws only, the pixels themselves are never touched host-side.
    """

    mean: tuple[float, ...]
    std: tuple[float, ...]
    field: str = "images"  # batch key holding (N, H, W, C) wire payloads
    out_hw: tuple[int, int] | None = None  # None = full frame
    flip: bool = False  # random horizontal flip (p=0.5)
    crop: bool = False  # random (vs centered) out_hw window placement
    out_dtype: torch.dtype = torch.bfloat16
    seed: int = 0


class DeviceTransfer:
    def __init__(
        self,
        device: torch.device | str | None = None,  # None = torch.device("cuda")
        *,
        uint8_wire: bool = False,
        hold_slabs: int | None = None,
        consumer_window: int = 3,
        dispatch_chunk: int = 1,
        device_decode: DeviceDecode | None = None,
        tracer=None,
    ):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"DeviceTransfer: {self.device} requested but torch sees no "
                    "CUDA device; pass device='cpu' to run on the host"
                )
            self._copy_stream = torch.cuda.Stream(self.device)
        elif self.device.type != "cpu":
            raise ValueError(f"DeviceTransfer: unsupported device {self.device}")
        if hold_slabs is None:
            # consumer window + the batch mid-handoff + every batch of the
            # current dispatch chunk still un-put in the worker (chunked
            # transfer_many issues the whole chunk before put_many runs)
            hold_slabs = consumer_window + 1 + max(1, dispatch_chunk)
        self.uint8_wire = uint8_wire
        self.hold_slabs = hold_slabs  # slabs kept alive behind the current one
        self.device_decode = device_decode
        self.bytes_moved = 0
        self.num_batches = 0
        # fused on-chip decode accounting (host-side dispatch cost only —
        # the kernel runs async); surfaced via stats() → the stage probe
        self.device_decode_ms = 0.0
        self.device_decode_batches = 0
        # explicit tracer, else whatever is installed process-wide at call
        # time (host→device spans land on the worker thread's track)
        self._tracer = tracer
        # (slab, copy event or None), oldest first
        self._held: deque[tuple[Any, torch.cuda.Event | None]] = deque()
        if device_decode is not None:
            self._decode_mean = torch.tensor(device_decode.mean, dtype=torch.float32, device=self.device)
            self._decode_std = torch.tensor(device_decode.std, dtype=torch.float32, device=self.device)
            self._decode_rng = np.random.default_rng(device_decode.seed)

    def __call__(self, batch: Any) -> Any:
        slab = None
        if isinstance(batch, dict):
            slab = batch.pop(SLAB_KEY, None)
            if self.uint8_wire:
                batch = {k: to_uint8_wire(v) for k, v in batch.items()}
        nbytes = (
            sum(v.nbytes for v in batch.values() if hasattr(v, "nbytes"))
            if isinstance(batch, dict)
            else getattr(batch, "nbytes", 0)
        )
        self.bytes_moved += nbytes
        self.num_batches += 1
        tracer = self._tracer if self._tracer is not None else _trace.get_tracer()
        t0 = time.monotonic() if tracer.enabled else 0.0
        out, copied = self._put(batch, slab)
        if tracer.enabled:
            # dispatch time only: the copy is async, so this span is the
            # host-side cost; the wire time overlaps the consumer's step
            tracer.complete(
                "device_put", "transfer", t0, time.monotonic() - t0,
                {"bytes": nbytes, "batch": self.num_batches},
            )
        out = self._maybe_decode(out, tracer)
        if slab is not None:
            # The copy for `slab` is now in flight; recycle the one from
            # hold_slabs batches ago, whose copy is certainly consumed.
            self._held.append((slab, copied))
            while len(self._held) > self.hold_slabs:
                self._release(*self._held.popleft())
        return out

    def transfer_many(self, batches: list) -> list:
        """Vectorized-chunk entry point: dispatch a drained chunk of batches
        back-to-back, in order (wire as ``pipe(transfer.transfer_many,
        chunk=N, vectorized=True)``).  The slab hold ring advances per
        batch exactly as on the per-item path.  The hold window must cover
        the chunk: up to ``len(batches) - 1`` results sit un-put in the
        worker while the chunk's tail is dispatched, so construct the
        transfer with ``dispatch_chunk=`` matching the stage's chunk (the
        loaders do) — an undersized window releases slabs the sink still
        aliases.
        """
        return [self(b) for b in batches]

    def _put(self, batch: Any, slab: Any) -> tuple[Any, torch.cuda.Event | None]:
        """Start the batch's copy to ``device``; returns (device batch, the
        copy's event on CUDA).  On the CPU, arrays outside a slab are
        aliased and slab rows are copied."""
        values = batch if isinstance(batch, dict) else {None: batch}
        if self.device.type == "cpu":
            out = {k: _host_tensor(v) for k, v in values.items()}
            if slab is not None:
                # a CPU tensor over the slab would alias memory the arena
                # recycles; the hold window alone does not cover the
                # engine's read-ahead past a backpressured transfer stage
                out = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
            return (out if isinstance(batch, dict) else out[None]), None
        consumer = torch.cuda.current_stream(self.device)
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in values.items():
                src = _slab_tensor(slab, k, v)
                if src is None:
                    src = _host_tensor(v)
                if isinstance(src, torch.Tensor):
                    src = src.to(self.device, non_blocking=True)
                out[k] = src
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        consumer.wait_event(event)
        for t in out.values():
            if isinstance(t, torch.Tensor):
                t.record_stream(consumer)
        return (out if isinstance(batch, dict) else out[None]), event

    @staticmethod
    def _release(slab: Any, copied: torch.cuda.Event | None) -> None:
        if copied is not None:
            copied.synchronize()  # the slab's copy has left host memory
        slab.release()

    def _maybe_decode(self, out: Any, tracer) -> Any:
        """Dispatch the fused on-chip decode for the configured field."""
        dd = self.device_decode
        if dd is None or not isinstance(out, dict) or dd.field not in out:
            return out
        from ..kernels.ops import dequant_normalize_augment

        x = out[dd.field]
        n, h, w, _c = x.shape
        oh, ow = dd.out_hw if dd.out_hw is not None else (h, w)
        flip = crop = None
        if dd.flip:
            flip = self._decode_rng.integers(0, 2, n, dtype=np.int32)
        if oh != h or ow != w:
            if dd.crop:
                crop = np.stack(
                    [
                        self._decode_rng.integers(0, h - oh + 1, n, dtype=np.int32),
                        self._decode_rng.integers(0, w - ow + 1, n, dtype=np.int32),
                    ],
                    axis=1,
                )
            else:
                crop = np.tile(
                    np.array([[(h - oh) // 2, (w - ow) // 2]], np.int32), (n, 1)
                )
        t0 = time.monotonic()
        decoded = dequant_normalize_augment(
            x, self._decode_mean, self._decode_std, flip, crop,
            out_hw=dd.out_hw, out_dtype=dd.out_dtype,
        )
        dt = time.monotonic() - t0
        self.device_decode_ms += dt * 1e3
        self.device_decode_batches += 1
        if tracer.enabled:
            tracer.complete(
                "device_decode", "transfer", t0, dt,
                {"batch": self.num_batches, "out_hw": [oh, ow]},
            )
        out = dict(out)
        out[dd.field] = decoded
        return out

    def stats(self) -> dict[str, float]:
        """Probe dict for the transfer stage's stats row (wire with
        ``pipe(..., cache=transfer)`` — the snapshot pulls these keys)."""
        return {
            "device_decode_ms": self.device_decode_ms,
            "device_decode_batches": self.device_decode_batches,
        }

    def flush(self) -> None:
        """Release every held slab (end of stream / teardown).  Callers must
        ensure pending transfers are consumed (e.g. the pipeline drained)."""
        while self._held:
            self._release(*self._held.popleft())


def _host_tensor(v: Any) -> Any:
    """A host array as a tensor over the same memory; other values as given."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v)
    return v


def _slab_tensor(slab: Any, key: Any, v: Any) -> torch.Tensor | None:
    """The pinned tensor behind ``v`` when ``v`` is (a leading slice of)
    ``slab``'s array for ``key``, else None.  Raises when that array is not
    in pinned memory: the copy from it could not run asynchronously."""
    if slab is None or not isinstance(v, np.ndarray):
        return None
    if key not in slab.arrays or v.ctypes.data != slab.arrays[key].ctypes.data:
        return None  # replaced on the way (e.g. a uint8 wire downcast)
    t = slab.tensors.get(key)
    if t is None or not t.is_pinned():
        raise RuntimeError(f"slab field {key!r} is not in pinned host memory")
    return t[: v.shape[0]]
