"""GQA/MHA attention (optionally qk-norm and QKV bias) for serving.

Two entry points:
  - ``attn_prefill``: causal self-attention over the prompt through the
    hand-written ``flash_attention`` kernel; writes the layer's K/V into
    the head of a preallocated cache;
  - ``attn_decode``: one new token against a preallocated cache, written
    in place, with plain masked attention over the cache's capacity.

The reference's MLA (DeepSeek), ``attn_train`` and its chunked jnp
attention are not ported yet (ROADMAP).
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_rope, dtype_of, rms_norm_simple
from .params import ParamDef

NEG_INF = -(2.0**30)  # large finite negative: avoids NaN from (-inf) - (-inf)
FLASH_PAD = 64  # the prompt is padded to a multiple of this for the kernel's tiles


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None), dt),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None), dt),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None), dt),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed"), dt, fan_in_dims=(0, 1)),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDef((h, hd), ("heads", None), dt, "zeros")
        p["bk"] = ParamDef((kv, hd), ("kv_heads", None), dt, "zeros")
        p["bv"] = ParamDef((kv, hd), ("kv_heads", None), dt, "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((hd,), (None,), torch.float32, "ones")
        p["k_norm"] = ParamDef((hd,), (None,), torch.float32, "ones")
    return p


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale):
    """q: (B,Sq,K,G,hd), k/v: (B,Skv,K,hd). Returns (B,Sq,K,G,hd).

    Scores and softmax in f32; p is cast to v's dtype before p·v."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = (q_pos[:, :, None] >= kv_pos[:, None, :]) & (q_seg[:, :, None] == kv_seg[:, None, :])
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def _causal_flash(q, k, v):
    """q: (B,S,K,G,hd), k/v: (B,S,K,hd) → (B,S,K·G,hd) through the kernel.

    Query head ``kh·G + g`` maps to kv head ``kh``, the kernel's
    ``h // group``; k and v go over as (B,K,S,hd).  Any S: q, k and v are
    padded with zeros at the end to a multiple of 64, with tile 128 where
    that divides the padded length and 64 otherwise, and the output is cut
    back to S.  The padded keys come after every real query, so the causal
    mask already hides them; the padded query rows are dropped."""
    b, s, kh, g, hd = q.shape
    pad = -s % FLASH_PAD
    blk = 128 if (s + pad) % 128 == 0 else 64
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kh * g, s, hd)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    if pad:
        qh, kt, vt = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (qh, kt, vt))
    qh, kt, vt = qh.contiguous(), kt.contiguous(), vt.contiguous()
    o = ops.flash_attention(qh, kt, vt, causal=True, block_q=blk, block_k=blk)
    return o[:, :, :s].transpose(1, 2)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dkh->bskh") as one matrix product."""
    d, kh, hd = w.shape
    return (x @ w.reshape(d, kh * hd)).unflatten(-1, (kh, hd))


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm_simple(q, p["q_norm"])
        k = rms_norm_simple(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bskh,khd->bsd") on o (B,S,H,hd) as one matrix product."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:2], h * hd) @ wo.reshape(h * hd, d)


def attn_prefill(cfg: ModelConfig, p: dict, x, positions, cache: dict):
    """Causal attention over the prompt x (B,S,D) at ``positions`` (B,S),
    which RoPE reads; the kernel masks by index, so each row's positions
    must strictly increase (``Model.prefill`` checks).  Writes the layer's
    k and v into ``cache["k"|"v"][:, :S]`` (B,S_cap,K,hd)."""
    q, k, v = _qkv(cfg, p, x, positions)
    s = x.shape[1]
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    o = _causal_flash(_group(q, cfg.num_kv_heads), k, v)
    return _out(o, p["wo"])


def attn_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos: int):
    """x (B,1,D) is the token at position ``pos``; its k and v are written
    into the cache slot ``pos`` in place, and it attends to slots 0..pos."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    cache["k"][:, pos:pos + 1] = k_new
    cache["v"][:, pos:pos + 1] = v_new
    k, v = cache["k"], cache["v"]
    s_cap = k.shape[1]
    kv_pos = torch.arange(s_cap, device=x.device).expand(b, s_cap)
    kv_seg = torch.where(kv_pos <= pos, 0, -1)  # unwritten slots (> pos) masked
    q_seg = torch.zeros((b, 1), dtype=kv_seg.dtype, device=x.device)
    o = _plain_attention(
        _group(q, cfg.num_kv_heads), k, v, positions, kv_pos, q_seg, kv_seg,
        1.0 / math.sqrt(cfg.resolved_head_dim),
    )
    return _out(o.reshape(b, 1, cfg.num_heads, cfg.resolved_head_dim), p["wo"])
