"""Plain PyTorch oracles for every kernel (the allclose ground truth).

The counterpart of ``repro.kernels.ref``.  Each oracle computes its
kernel's function the straightforward way, apart from the kernel's
blocking: attention as one dense softmax over every key, the SSD scan as
the step-by-step recurrence, the decode tail as separate ops that divide
by 255 and by std.  The ``*_plain`` version beside each wrapper follows
the kernel's tiles and arithmetic instead, so a fault the kernel and its
plain version share shows only against these.
"""

from __future__ import annotations

import math

import torch

from ..models.ssm import ssd_recurrent


def flash_attention_ref(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """q (B,H,Sq,hd); k/v (B,Hkv,Skv,hd) — full-materialization attention,
    q right-aligned to the keys (row i sees keys 0 .. i + Skv - Sq)."""
    _, h, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        s = torch.where(rows >= torch.arange(skv, device=q.device)[None, :], s, -(2.0**30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def ssd_ref(x, dt, a, b, c, h0=None):
    """Stepwise SSD recurrence; see ``models.ssm.ssd_recurrent`` (re-exported
    here so kernel checks depend only on ``kernels/``)."""
    return ssd_recurrent(x, dt, a, b, c, h0)


def dequant_normalize_ref(x, mean, std, *, out_dtype=torch.bfloat16):
    """x (N,H,W,C) uint8 → (N,C,H,W) normalized."""
    y = x.float() / 255.0
    y = (y - mean[None, None, None, :]) / std[None, None, None, :]
    return y.permute(0, 3, 1, 2).to(out_dtype, memory_format=torch.contiguous_format)


def dequant_normalize_augment_ref(
    x, mean, std, *, flip=None, crop=None, out_hw=None, out_dtype=torch.bfloat16
):
    """Oracle for the fused decode: per-sample crop → horizontal flip →
    dequant → per-channel normalize → NCHW, as separate ops.

    ``x`` is (N,H,W,C) uint8 (dequantized by /255) or float already in
    [0,1] (dequant is then the identity).  ``flip`` (N,) nonzero = mirror
    the width axis; ``crop`` (N,2) = (top, left) offsets of an
    ``out_hw``-sized window, clamped in-bounds like ``lax.dynamic_slice``.
    """
    n, h, w, _ = x.shape
    oh, ow = out_hw if out_hw is not None else (h, w)
    flip = torch.zeros(n, dtype=torch.int64) if flip is None else torch.as_tensor(flip).long()
    crop = torch.zeros((n, 2), dtype=torch.int64) if crop is None else torch.as_tensor(crop).long()
    top = crop[:, 0].clamp(0, h - oh).tolist()
    left = crop[:, 1].clamp(0, w - ow).tolist()
    out = []
    for i in range(n):
        y = x[i, top[i]:top[i] + oh, left[i]:left[i] + ow].float()
        if not x.dtype.is_floating_point:
            y = y * (1.0 / 255.0)
        if flip[i] != 0:
            y = y.flip(1)
        out.append((y - mean) / std)
    return torch.stack(out).permute(0, 3, 1, 2).to(out_dtype, memory_format=torch.contiguous_format)
