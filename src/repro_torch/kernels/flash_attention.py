"""Attention forward, causal or not, GQA: the serving path's prefill attention.

q (B, H, Sq, hd) attends to k and v (B, Hkv, Skv, hd) with kv head
``h // (H // Hkv)``, so K and V are never repeated in memory.  Under the
causal mask q is right-aligned to kv: query row i sits at key position
``i + Skv - Sq``.  The output has q's dtype.

The arithmetic is the Pallas body's (``src/repro/kernels/flash_attention.py``),
not the ``ref.py`` oracle's full softmax: an online softmax over key tiles
of ``block_k`` keys with f32 m, l and acc; scores ``(q . k) * sm_scale`` in
f32, masked with the finite ``NEG_INF = -2**30``; per tile
``p = exp(s - m_new)`` rounded to v's dtype before the f32 p·v product;
``acc / max(l, 1e-20)`` at the end.

``flash_attention`` dispatches on the device of q: a CPU tensor goes
through ``flash_attention_plain`` beside it, a CUDA tensor launches one of
the two hand-written kernels in ``csrc/flash_attention.cu`` (or raises),
and each launch of either adds one to ``flash_attention.launches``.  The
dtype picks the kernel (``kernel_route``): bf16 runs on the tensor cores
(head dim 32, 64, 128 or 192; ``block_k`` 64 or 128), f32 on the CUDA cores
(head dim 32, 64, 128, 192 or 256; any ``block_k``).  Head dim 192 is
DeepSeek's MLA prefill: q and k of 128 + 64 rope dims, and v (128 dims)
zero-padded to 192 by its caller, as the kernel takes one head dim for q,
k and v, like the reference's.

With ``q_pos`` (B, Sq) and ``kv_pos`` (B, Skv), int32, the causal mask is
by position, not by index: a key is kept iff ``q_pos >= kv_pos``, the
reference's ``_plain_attention`` mask with every segment id 0, as its
``Model.prefill`` passes them.  Rows whose positions restart (packed
prompts), repeat or run backwards are then masked as the reference masks
them.  A query row that sees no key averages over the keys its kernel
visited (the plain version: over every key); callers drop such rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -(2.0**30)

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
TC_HEAD_DIMS = (32, 64, 128, 192)  # bf16: the f32 output of 16 rows stays in registers
TC_BLOCK_KS = (64, 128)  # bf16: the softmax step is one or two 64-key tiles
F32_HEAD_DIMS = (32, 64, 128, 192, 256)


def _check_positions(q, k, q_pos, kv_pos, causal: bool) -> None:
    """Both position tensors or neither; (B, Sq) and (B, Skv) int32 on q's device."""
    if (q_pos is None) != (kv_pos is None):
        raise ValueError("flash_attention: pass q_pos and kv_pos together")
    if q_pos is None:
        return
    if not causal:
        raise ValueError("flash_attention: q_pos and kv_pos give the causal mask; causal must be True")
    for name, pos, want in (("q_pos", q_pos, (q.shape[0], q.shape[2])), ("kv_pos", kv_pos, (k.shape[0], k.shape[2]))):
        if tuple(pos.shape) != want or pos.dtype != torch.int32 or pos.device != q.device:
            raise ValueError(f"flash_attention: {name} must be int32 {want} on {q.device}; "
                             f"got {pos.dtype} {tuple(pos.shape)} on {pos.device}")


def _check(q, k, v, causal: bool, block_q: int, block_k: int) -> None:
    """The reference's assertions, raised as errors, plus shapes and dtypes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be 4-d; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Hkv, Skv, {hd}) with B={b}; got {tuple(k.shape)}, {tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {hkv}")
    if causal and sq > skv:
        raise ValueError(f"causal requires sq <= skv (right-aligned); got sq={sq}, skv={skv}")
    if block_q <= 0 or block_k <= 0 or sq % block_q or skv % block_k:
        raise ValueError(f"sq={sq} and skv={skv} must be multiples of block_q={block_q} and block_k={block_k}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be bfloat16 or all float32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on {q.device}, {k.device}, {v.device}")


def kernel_route(dtype: torch.dtype, head_dim: int, block_k: int) -> str:
    """The CUDA kernel that ``flash_attention`` launches for a CUDA tensor:
    ``"tc_bf16"`` (bf16 on the tensor cores) or ``"cuda_f32"`` (f32 on the
    CUDA cores).  Raises ``ValueError`` for a head dim or ``block_k`` that
    the kernel does not take, ``TypeError`` for another dtype."""
    if dtype == torch.bfloat16:
        if head_dim not in TC_HEAD_DIMS:
            raise ValueError(f"flash_attention: the bf16 kernel takes head_dim in {TC_HEAD_DIMS}; got {head_dim}")
        if block_k not in TC_BLOCK_KS:
            raise ValueError(f"flash_attention: the bf16 kernel takes block_k in {TC_BLOCK_KS}; got {block_k}")
        return "tc_bf16"
    if dtype == torch.float32:
        if head_dim not in F32_HEAD_DIMS:
            raise ValueError(f"flash_attention: the f32 kernel takes head_dim in {F32_HEAD_DIMS}; got {head_dim}")
        return "cuda_f32"
    raise TypeError(f"flash_attention: no CUDA kernel for {dtype}")


def flash_attention_plain(
    q, k, v, *, causal: bool = True, sm_scale: float | None = None,
    block_q: int = 128, block_k: int = 128,
    q_pos: torch.Tensor | None = None, kv_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention`` (any device): the Pallas
    body's key-tile loop over all query rows at once."""
    _check(q, k, v, causal, block_q, block_k)
    _check_positions(q, k, q_pos, kv_pos, causal)
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (hd**0.5)
    qf = q.float().reshape(b, hkv, h // hkv, sq, hd)  # head h -> (h // group, h % group)
    if q_pos is None:  # by index: row i of q at key position i + skv - sq
        q_pos = (torch.arange(sq, device=q.device) + (skv - sq)).expand(b, sq)
        kv_pos = torch.arange(skv, device=q.device).expand(b, skv)
    m = torch.full((b, hkv, h // hkv, sq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, skv, block_k):  # the last row, at skv - 1, sees every tile
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k]
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kb) * sm_scale
        if causal:
            keep = q_pos[:, :, None] >= kv_pos[:, None, k0:k0 + block_k]  # (b, sq, block_k)
            s = torch.where(keep[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(), vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.to(q.dtype).reshape(b, h, sq, hd)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fa_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.fa_launch.restype = i
    return lib


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, Hkv, Skv, hd)
    v: torch.Tensor,  # (B, Hkv, Skv, hd)
    *,
    causal: bool = True,
    sm_scale: float | None = None,  # None = 1 / sqrt(hd)
    block_q: int = 128,
    block_k: int = 128,  # the softmax's key tile
    q_pos: torch.Tensor | None = None,  # (B, Sq) int32: mask by q_pos >= kv_pos
    kv_pos: torch.Tensor | None = None,  # (B, Skv) int32
) -> torch.Tensor:
    """Returns (B, H, Sq, hd) in q's dtype.  Raises ``ValueError`` where the
    reference asserts: ``H % Hkv``, causal with ``Sq > Skv``, and ``Sq`` or
    ``Skv`` not a multiple of ``block_q`` or ``block_k``; for one position
    tensor without the other, or either of another shape, dtype or device;
    on a CUDA device also where ``kernel_route`` does."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, sm_scale=sm_scale, block_q=block_q, block_k=block_k,
            q_pos=q_pos, kv_pos=kv_pos,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q must lie on the CPU or a CUDA device; got {q.device}")
    _check(q, k, v, causal, block_q, block_k)
    _check_positions(q, k, q_pos, kv_pos, causal)
    b, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kernel_route(q.dtype, hd, block_k)
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: batch {b} and heads {h} must each be at most 65535")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    if sm_scale is None:
        sm_scale = 1.0 / (hd**0.5)
    if q.numel() == 0 or skv == 0:
        return torch.zeros_like(q)  # the plain version's acc / 1e-20 over no keys
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(), None if kv_pos is None else kv_pos.data_ptr(),
            _DTYPES[q.dtype],
            b, h, hkv, sq, skv, hd, block_k, sm_scale, int(causal), stream,
        )
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
