"""Array codec: the container's stand-in for JPEG/FFmpeg "media" decode.

``zstandard`` (C extension) releases the GIL during (de)compression and
numpy releases it for large array ops — exactly the property the paper's
thread-pool design exploits (§4: "functions that release the GIL entirely").
When ``zstandard`` is not installed we fall back to stdlib ``zlib`` (also a
GIL-releasing C extension); the decoder sniffs the payload's frame magic so
either decoder reads either format.  A ``py_decode`` pure-Python variant is
provided as the GIL-HOLDING counterpart for the Fig 1/2-style contention
benchmarks.

Zero-copy variants (slab-arena path, see ``repro.data.arena``):

``decode_into(data, out)``       — decompress straight into caller-owned
                                   memory (a batch-slab row), allocating no
                                   intermediate array;
``resize_nearest_into(img, out)``— nearest-neighbour resize written into a
                                   slab row via one cached-index gather.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

try:  # optional accelerated codec; the container may not ship it
    import zstandard
except ImportError:  # pragma: no cover - environment-dependent
    zstandard = None

_MAGIC = b"RPR1"
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"
_DTYPES = {0: np.uint8, 1: np.int32, 2: np.float32, 3: np.uint16}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}

# per-thread compressor/decompressor reuse (they are not thread-safe)
_tls = threading.local()


def _cctx():
    if not hasattr(_tls, "cctx"):
        _tls.cctx = zstandard.ZstdCompressor(level=1)
    return _tls.cctx


def _dctx():
    if not hasattr(_tls, "dctx"):
        _tls.dctx = zstandard.ZstdDecompressor()
    return _tls.dctx


def _compress(raw: bytes) -> bytes:
    if zstandard is not None:
        return _cctx().compress(raw)
    return zlib.compress(raw, 1)


def _decompress(payload: bytes) -> bytes:
    if payload[:4] == _ZSTD_FRAME_MAGIC:
        if zstandard is None:
            raise ValueError("zstd-compressed sample but zstandard is not installed")
        return _dctx().decompress(payload)
    return zlib.decompress(payload)


def parse_header(data: bytes) -> tuple[np.dtype, tuple[int, ...], int]:
    """Validate the header; returns (dtype, shape, payload_offset)."""
    if data[:4] != _MAGIC:
        raise ValueError("bad magic: corrupt sample")
    dt_id, ndim = struct.unpack_from("<BB", data, 4)
    shape = struct.unpack_from(f"<{ndim}I", data, 6)
    return np.dtype(_DTYPES[dt_id]), shape, 6 + 4 * ndim


def encode_sample(arr: np.ndarray) -> bytes:
    """Header (magic, dtype, ndim, dims) + compressed payload."""
    arr = np.ascontiguousarray(arr)
    hdr = _MAGIC + struct.pack(
        "<BB", _DTYPE_IDS[arr.dtype], arr.ndim
    ) + struct.pack(f"<{arr.ndim}I", *arr.shape)
    return hdr + _compress(arr.tobytes())


def decode_sample(data: bytes) -> np.ndarray:
    """GIL-releasing decode (zstd/zlib C ext + numpy frombuffer)."""
    dtype, shape, off = parse_header(data)
    payload = _decompress(data[off:])
    return np.frombuffer(payload, dtype=dtype).reshape(shape)


def decode_into(data: bytes, out: np.ndarray) -> np.ndarray:
    """Decode directly into caller-owned memory (a slab row): zero
    intermediate arrays with zstd (``stream_reader.readinto`` writes the
    decompressed bytes straight into ``out``'s buffer), one bounce buffer
    with the zlib fallback.  ``out`` must be C-contiguous and match the
    encoded dtype/shape exactly."""
    dtype, shape, off = parse_header(data)
    if out.dtype != dtype or tuple(out.shape) != tuple(shape):
        raise ValueError(
            f"decode_into mismatch: sample is {dtype}{shape}, "
            f"out is {out.dtype}{tuple(out.shape)}"
        )
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("decode_into requires a C-contiguous out buffer")
    payload = data[off:]
    if zstandard is not None and payload[:4] == _ZSTD_FRAME_MAGIC:
        view = memoryview(out).cast("B")
        need = out.nbytes
        got = 0
        with _dctx().stream_reader(payload) as reader:
            while got < need:
                n = reader.readinto(view[got:])
                if n == 0:
                    raise ValueError("truncated sample payload")
                got += n
            if reader.readinto(bytearray(1)):  # must be exhausted now
                raise ValueError("sample payload larger than header shape")
        return out
    raw = _decompress(payload)
    if len(raw) != out.nbytes:
        raise ValueError(
            f"sample payload is {len(raw)} bytes, header shape implies {out.nbytes}"
        )
    flat = out.reshape(-1)
    flat[:] = np.frombuffer(raw, dtype=dtype)
    return out


def py_decode(data: bytes) -> np.ndarray:
    """Pure-Python (GIL-holding) decode — the 'Pillow-like' baseline for the
    GIL-contention benchmark.  Byte-by-byte checksum walk keeps the
    interpreter busy the way PIL's Python layers do."""
    if data[:4] != _MAGIC:
        raise ValueError("bad magic")
    arr = decode_sample(data)
    acc = 0
    for bb in data[:: max(1, len(data) // 2048)]:  # interpreter-bound loop
        acc = (acc * 31 + bb) & 0xFFFFFFFF
    return arr if acc >= 0 else arr


def resize_nearest(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize with pure numpy (releases the GIL)."""
    h, w = hw
    ih, iw = img.shape[:2]
    yi = np.clip((np.arange(h) * ih / h).astype(np.int64), 0, ih - 1)
    xi = np.clip((np.arange(w) * iw / w).astype(np.int64), 0, iw - 1)
    return img[yi][:, xi]


# (ih, iw, h, w) -> flat gather indices; image sizes are few, so this stays
# tiny while letting resize_nearest_into run as one np.take with out=.
_RESIZE_IDX_CACHE: dict[tuple[int, int, int, int], np.ndarray] = {}
_RESIZE_IDX_LOCK = threading.Lock()


def _resize_indices(ih: int, iw: int, h: int, w: int) -> np.ndarray:
    key = (ih, iw, h, w)
    idx = _RESIZE_IDX_CACHE.get(key)
    if idx is None:
        yi = np.clip((np.arange(h) * ih / h).astype(np.int64), 0, ih - 1)
        xi = np.clip((np.arange(w) * iw / w).astype(np.int64), 0, iw - 1)
        idx = (yi[:, None] * iw + xi[None, :]).ravel()
        with _RESIZE_IDX_LOCK:
            _RESIZE_IDX_CACHE[key] = idx
    return idx


def resize_nearest_into(img: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Nearest-neighbour resize written directly into ``out`` (a slab row):
    a single gather, no intermediate row/column-indexed copies."""
    h, w = out.shape[:2]
    ih, iw = img.shape[:2]
    if img.shape[2:] != out.shape[2:]:
        raise ValueError(f"channel mismatch: {img.shape} -> {out.shape}")
    if img.dtype != out.dtype:
        raise ValueError(f"dtype mismatch: {img.dtype} -> {out.dtype}")
    if not out.flags["C_CONTIGUOUS"]:  # reshape below must be a view
        raise ValueError("resize_nearest_into requires a C-contiguous out buffer")
    idx = _resize_indices(ih, iw, h, w)
    src = np.ascontiguousarray(img).reshape(ih * iw, -1)
    np.take(src, idx, axis=0, out=out.reshape(h * w, -1))
    return out


def normalize_to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0
