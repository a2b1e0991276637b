"""Mamba2 SSD chunked scan: the prefill scan of the SSD block.

x (B, L, H, P) with step sizes dt (B, L, H) f32 and per-head decays a (H,)
f32 (negative) runs through the state-space recurrence whose input and
output maps b and c (B, L, G, N) are shared by the H // G heads of a group:
head ``hi`` reads group ``hi // (H // G)``, so b and c are never repeated
in memory.  Returns y (B, L, H, P) in x's dtype and the final state
h_final (B, H, P, N) f32.  The state starts from ``h0`` (B, H, P, N) f32
where one is given (a scan that continues another: the reference's
``ssd_chunked(..., h0=...)``), else from zero.

The arithmetic is the Pallas body's (``src/repro/kernels/ssd_scan.py``),
not ``ssd_chunked``'s or the stepwise oracle's.  Chunk by chunk, in f32,
with the state h (P, N) carried from chunk to chunk:

    cs   = cumsum(dt * a)
    L    = where(i >= j, exp(cs_i - cs_j), 0)
    y    = ((C . B^T) * L * dt_j) . x  +  exp(cs_i) * (C . h^T)
    h   <- exp(cs_last) * h + (x * exp(cs_last - cs) * dt)^T . B

y takes the state from before the chunk's update, and is rounded to x's
dtype once per chunk.  The running sum of ``cs`` is kept in float64 and
each prefix rounded to f32: a chunk of 256 steps reaches |cs| of a few
hundred, where an f32 ulp is 3e-5, and a sum taken in another order would
move ``exp(cs_i - cs_j)`` by as much as the f32 bar.  With the double sum
the kernel and the plain version agree on ``cs`` bit for bit.

``ssd_scan`` dispatches on the device of x: a CPU tensor goes through
``ssd_scan_plain`` beside it, a CUDA tensor launches one of the two
hand-written kernels in ``csrc/ssd_scan.cu`` (or raises), and each launch
of either adds one to ``ssd_scan.launches`` (one a call, whatever passes
the call launches).  The dtype picks the kernel (``kernel_route``): bf16
runs on the tensor cores (wgmma), its f32 operands (the scores, the state
and x * w) as sums of bf16 pieces, so its y and h_final differ from the
plain version's by rounding; f32 runs on the CUDA cores.  Both take
head_dim 16, 32, 48 or 64 and d_state a multiple of 16 up to 128; the bf16
kernel takes any chunk up to 256 (every chunk ``models.ssm.scan_chunk``
picks), the f32 kernel any chunk.

Where batch x heads blocks would not fill the card, the bf16 kernel splits
each sequence's chunks into ``segment_plan`` segments (``segment_bounds``):
a first pass scans each segment but the last from a zero state to its local
state and log-decay, and the second walks every segment from the state the
ones before it carry (see ``csrc/ssd_scan.cu``).  The recurrence is linear,
so the result is the same function, up to rounding.  An initial state h0
enters that carry's fold at segment 0 (the f32 kernel starts its walk from
it): a scan of a prompt's token windows, each from the state the one
before left, is the scan of the whole.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# P: the bf16 kernel takes x as one 64-column TMA panel (its columns past P read as zeros), and the f32
# kernel is built for P / 16 = 1 .. 4 column groups of 16
_KERNEL_HEAD_DIMS = (16, 32, 48, 64)
_KERNEL_MAX_STATE = 128  # N: a multiple of 16, in one or two 64-column panels
_BF16_MAX_CHUNK = 256  # bf16: a chunk is at most four 64-row tiles, all in the kernel's ring at once
_SMS_H100 = 132


def _check(x, dt, a, b, c, chunk: int, h0=None) -> None:
    """The reference's assertions, raised as errors, plus shapes and dtypes."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 or c.dim() != 4:
        raise ValueError(
            f"want x (B,L,H,P), dt (B,L,H), a (H,), b and c (B,L,G,N); got {tuple(x.shape)}, "
            f"{tuple(dt.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}"
        )
    bsz, l, h, _ = x.shape
    if tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,):
        raise ValueError(f"dt must be {(bsz, l, h)} and a {(h,)}; got {tuple(dt.shape)}, {tuple(a.shape)}")
    if b.shape != c.shape or tuple(b.shape[:2]) != (bsz, l):
        raise ValueError(f"b and c must both be ({bsz}, {l}, G, N); got {tuple(b.shape)}, {tuple(c.shape)}")
    g = b.shape[2]
    if g == 0 or h % g:
        raise ValueError(f"heads {h} must be a multiple of groups {g}")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"sequence length {l} must be a multiple of chunk={chunk}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must all be bfloat16 or all float32; got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32; got {dt.dtype}, {a.dtype}")
    if not (x.device == dt.device == a.device == b.device == c.device):
        raise ValueError(f"x, dt, a, b and c lie on {x.device}, {dt.device}, {a.device}, {b.device}, {c.device}")
    want = (bsz, h, x.shape[3], b.shape[3])
    if h0 is not None and (tuple(h0.shape) != want or h0.dtype != torch.float32 or h0.device != x.device):
        raise ValueError(f"h0 must be float32 {want} on {x.device}; got {h0.dtype} {tuple(h0.shape)} on {h0.device}")


def kernel_route(dtype: torch.dtype, head_dim: int, d_state: int) -> str:
    """The CUDA kernel that ``ssd_scan`` launches for a CUDA tensor:
    ``"wgmma_bf16"`` (bf16 on the tensor cores) or ``"cuda_f32"`` (f32 on
    the CUDA cores).  Raises ``ValueError`` for a head dim or d_state that the
    kernels do not take, ``TypeError`` for another dtype."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: no CUDA kernel for {dtype}")
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"ssd_scan: the CUDA kernels take head_dim in {_KERNEL_HEAD_DIMS}; got {head_dim}")
    if d_state <= 0 or d_state % 16 or d_state > _KERNEL_MAX_STATE:
        raise ValueError(f"ssd_scan: the CUDA kernels take d_state a multiple of 16 up to {_KERNEL_MAX_STATE}; got {d_state}")
    return "wgmma_bf16" if dtype == torch.bfloat16 else "cuda_f32"


@functools.cache
def segment_plan(bsz: int, heads: int, chunks: int, sms: int = _SMS_H100) -> int:
    """How many segments S the bf16 kernel splits each (batch, head)'s
    ``chunks`` chunks into.  A block walks one segment, and its shared
    memory holds it to one block an SM, so ``sms`` blocks run at a time (a
    wave).  S is 1 where bsz x heads blocks already fill two waves;
    otherwise the S that minimises the waves of blocks times the chunks of
    the longest segment, ceil(bsz heads S / sms) x ceil(chunks / S), over
    1 <= S <= min(chunks, 4 ceil(2 sms / (bsz heads))), ties to the smaller
    S (its first pass is shorter)."""
    blocks = bsz * heads
    if blocks >= 2 * sms or chunks <= 1:
        return 1
    top = min(chunks, 4 * -(-2 * sms // blocks))
    return min(range(1, top + 1), key=lambda s: -(-blocks * s // sms) * -(-chunks // s))


def segment_bounds(chunks: int, segments: int) -> list[tuple[int, int]]:
    """The chunks [first, end) of each segment, as the kernel cuts them:
    segment s is [s chunks // S, (s + 1) chunks // S)."""
    return [(s * chunks // segments, (s + 1) * chunks // segments) for s in range(segments)]


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_cumsum(da: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 prefix sums of ``da`` along ``dim``, summed in float64 (see the
    module docstring): what the kernel computes."""
    return torch.cumsum(da.double(), dim=dim).float()


def ssd_scan_plain(x, dt, a, b, c, *, chunk: int = 128, h0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``ssd_scan`` (any device): the Pallas body
    chunk by chunk, for all batches and heads at once, from ``h0`` or zero."""
    _check(x, dt, a, b, c, chunk, h0)
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    nc = l // chunk
    # heads as (group, head in group): head hi = gi * hg + k reads group gi
    xf = x.float().reshape(bsz, nc, chunk, g, hg, p)
    dtf = dt.reshape(bsz, nc, chunk, g, hg)
    bf = b.float().reshape(bsz, nc, chunk, g, n)
    cf = c.float().reshape(bsz, nc, chunk, g, n)
    ag = a.reshape(g, hg)
    idx = torch.arange(chunk, device=x.device)
    lower = (idx[:, None] >= idx[None, :])[None, :, :, None, None]  # (1, i, j, 1, 1)
    if h0 is None:
        state = torch.zeros((bsz, g, hg, p, n), dtype=torch.float32, device=x.device)
    else:
        state = h0.reshape(bsz, g, hg, p, n)
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci]
        cs = chunk_cumsum(dtc * ag, dim=1)  # (B, Q, G, HG)
        seg = cs[:, :, None] - cs[:, None, :]  # (B, i, j, G, HG)
        el = torch.where(lower, torch.exp(seg), 0.0)
        cb = torch.einsum("bign,bjgn->bijg", cc, bc)
        scores = cb[..., None] * el * dtc[:, None]  # column j scaled by dt_j
        y = torch.einsum("bijgk,bjgkp->bigkp", scores, xc)
        y = y + torch.exp(cs)[..., None] * torch.einsum("bign,bgkpn->bigkp", cc, state)
        xw = xc * (torch.exp(cs[:, -1:] - cs) * dtc)[..., None]
        upd = torch.einsum("bqgkp,bqgn->bgkpn", xw, bc)
        state = state * torch.exp(cs[:, -1])[..., None, None] + upd
        ys.append(y.reshape(bsz, chunk, h, p).to(x.dtype))
    return torch.cat(ys, dim=1), state.reshape(bsz, h, p, n)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.ssd_launch.restype = i
    return lib


def ssd_scan(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) f32
    a: torch.Tensor,  # (H,) f32, negative
    b: torch.Tensor,  # (B, L, G, N)
    c: torch.Tensor,  # (B, L, G, N)
    *,
    chunk: int = 128,
    h0: torch.Tensor | None = None,  # (B, H, P, N) f32: the state the scan starts from (None: zero)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P) in x's dtype, h_final (B, H, P, N) f32).
    Raises ``ValueError`` where the reference asserts: ``H % G`` and
    ``L % chunk``; on a CUDA device also where ``kernel_route`` does and
    for a bf16 chunk over 256.  A bf16 call that splits its chunks
    (``segment_plan``) allocates the first pass's scratch, (B, H, S - 1,
    P, N) f32 and (B, H, S - 1) f64."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: x must lie on the CPU or a CUDA device; got {x.device}")
    _check(x, dt, a, b, c, chunk, h0)
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    bf16 = kernel_route(x.dtype, p, n) == "wgmma_bf16"
    if bf16 and chunk > _BF16_MAX_CHUNK:
        raise ValueError(f"ssd_scan: the bf16 kernel takes chunk up to {_BF16_MAX_CHUNK}; got {chunk}")
    segments = segment_plan(bsz, h, l // chunk, _sms(x.device.index or 0)) if bf16 and x.numel() else 1
    if bsz * h * segments > 2**31 - 1 or bsz * l > 2**31 - 1:
        raise ValueError(f"ssd_scan: batch {bsz} x heads {h} x length {l} is too many blocks or rows")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} must be 16-byte aligned")
    y = torch.empty_like(x)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, h_final.zero_() if h0 is None else h_final.copy_(h0)
    h_loc = d_loc = None
    if segments > 1:
        h_loc = torch.empty((bsz, h, segments - 1, p, n), dtype=torch.float32, device=x.device)
        d_loc = torch.empty((bsz, h, segments - 1), dtype=torch.float64, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), h_loc.data_ptr() if segments > 1 else None,
            d_loc.data_ptr() if segments > 1 else None, _DTYPES[x.dtype], bsz, l, h, p, g, n, chunk, segments,
            stream,
        )
    _build.check(lib, err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
