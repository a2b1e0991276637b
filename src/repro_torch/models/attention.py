"""Attention blocks: GQA/MHA (optionally qk-norm and QKV bias) and
DeepSeek's Multi-head Latent Attention (MLA).

Three entry points for each:
  - ``attn_train``: causal self-attention over packed documents (positions
    and segment ids), differentiable, in plain PyTorch: the reference trains
    through its jnp ``_sdpa``, plain attention up to ``attn_chunk`` keys
    (2048 when unset) and a double-chunked online softmax beyond it, and so
    does the port.  The ``flash_attention`` kernel has no backward and no
    segment mask, so training never launches it;
  - ``attn_prefill``: causal self-attention over the prompt through the
    hand-written ``flash_attention`` kernel, masked by position as the
    reference's prefill masks (by index where the prompt carries no
    positions); writes the layer's K/V into the head of a preallocated
    cache.  A window of a prefill in token windows writes its slots and
    attends to every slot up to its last;
  - ``attn_decode``: one new token against a preallocated cache, written
    in place, with plain masked attention over the cache's capacity.

MLA (``mla_train``, ``mla_prefill``, ``mla_decode``) keeps a latent cache:
the normalized kv latent ``ckv`` (rank 512 at full size) and the shared
rope key ``k_rope`` (64), not per-head k and v.  Training and prefill take
the non-absorbed form, per-head q and k of 128 + 64 dims and v of 128:
training through ``_sdpa`` as above, prefill through the kernel with the
128 heads as kv groups of 1 and v zero-padded to q's head dim (the kernel
takes one head dim for q, k and v), the output cut back.  Decode takes the
absorbed form in plain tensor products: ``w_uk`` folded into the query,
scores against the latent cache, ``w_uv`` applied after, as the reference
does.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.flash_attention import kernel_head_dim
from .layers import apply_rope, dtype_of, rms_norm_simple
from .params import ParamDef

NEG_INF = -(2.0**30)  # large finite negative: avoids NaN from (-inf) - (-inf)
FLASH_PAD = 64  # the prompt is padded to a multiple of this for the kernel's tiles
Q_CHUNK = KV_CHUNK = 1024  # the reference's blocks for sequences past the threshold


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


def mla_defs(cfg: ModelConfig) -> dict:
    d, h, m = cfg.d_model, cfg.num_heads, cfg.mla
    dt = dtype_of(cfg)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamDef((d, m.q_lora_rank), ("embed", None), dt),
        "q_norm": ParamDef((m.q_lora_rank,), (None,), torch.float32, "ones"),
        "w_uq": ParamDef((m.q_lora_rank, h, qk), (None, "heads", None), dt),
        "w_dkv": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", None), dt),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), torch.float32, "ones"),
        "w_uk": ParamDef((m.kv_lora_rank, h, m.qk_nope_head_dim), (None, "heads", None), dt),
        "w_uv": ParamDef((m.kv_lora_rank, h, m.v_head_dim), (None, "heads", None), dt),
        "wo": ParamDef((h, m.v_head_dim, d), ("heads", None, "embed"), dt, fan_in_dims=(0, 1)),
    }


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------


def _scores(q, k, q_pos, kv_pos, q_seg, kv_seg, scale):
    """Masked f32 scores (B,K,G,Sq,Skv): f32 products of q (B,Sq,K,G,hd) and
    k (B,Skv,K,hd), as ``preferred_element_type=float32`` makes them."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = (q_pos[:, :, None] >= kv_pos[:, None, :]) & (q_seg[:, :, None] == kv_seg[:, None, :])
    return torch.where(mask[:, None, None, :, :], s, NEG_INF)


def _plain_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale):
    """q: (B,Sq,K,G,hd), k/v: (B,Skv,K,hd). Returns (B,Sq,K,G,hd).

    Scores and softmax in f32; p is cast to v's dtype before p·v."""
    p = torch.softmax(_scores(q, k, q_pos, kv_pos, q_seg, kv_seg, scale), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)


def _kv_scan_attention(q, kc, vc, q_pos, pc, q_seg, gc, scale):
    """Online softmax over pre-chunked KV for one q block.

    q: (B,Sq,K,G,hd); kc/vc: (NC,B,ckv,K,hd); pc/gc: (NC,B,ckv).  Scores
    of one kv chunk at a time, never (Sq x Skv)."""
    b, sq, kh, g, _ = q.shape
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kh, g, vc.shape[-1]), dtype=torch.float32, device=q.device)
    for kx, vx, px, gx in zip(kc, vc, pc, gc):
        s = _scores(q, kx, q_pos, px, q_seg, gx, scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bqkgh", p.to(vx.dtype), vx).float()
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = l.clamp(min=1e-20)
    return (acc / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype)


def _chunked_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale, q_chunk, kv_chunk):
    """Flash-style double-chunked attention in plain PyTorch, the reference's
    XLA fallback of its Pallas kernel: a loop over q blocks, each an online
    softmax over kv chunks.  Keys are padded to a multiple of ``kv_chunk``
    (position 2**30, segment -7: masked for every query), queries to one
    of ``q_chunk`` (position -1, segment -9; cut off after).  Each q block
    is recomputed in the backward pass instead of saving its scan's state,
    as the reference's ``jax.checkpoint`` does."""
    b, skv = k.shape[0], k.shape[1]
    nkv = -(-skv // kv_chunk)
    pad = nkv * kv_chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=2**30)
        kv_seg = torch.nn.functional.pad(kv_seg, (0, pad), value=-7)
    kc = k.reshape(b, nkv, kv_chunk, *k.shape[2:]).transpose(0, 1)
    vc = v.reshape(b, nkv, kv_chunk, *v.shape[2:]).transpose(0, 1)
    pc = kv_pos.reshape(b, nkv, kv_chunk).transpose(0, 1)
    gc = kv_seg.reshape(b, nkv, kv_chunk).transpose(0, 1)

    sq = q.shape[1]
    if sq <= q_chunk:
        return _kv_scan_attention(q, kc, vc, q_pos, pc, q_seg, gc, scale)

    nq = -(-sq // q_chunk)
    qpad = nq * q_chunk - sq
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, qpad))
        q_pos = torch.nn.functional.pad(q_pos, (0, qpad), value=-1)
        q_seg = torch.nn.functional.pad(q_seg, (0, qpad), value=-9)
    ys = [
        checkpoint(_kv_scan_attention, q[:, i:i + q_chunk], kc, vc, q_pos[:, i:i + q_chunk],
                   pc, q_seg[:, i:i + q_chunk], gc, scale, use_reentrant=False)
        for i in range(0, nq * q_chunk, q_chunk)
    ]
    return torch.cat(ys, dim=1)[:, :sq]


def _sdpa(cfg: ModelConfig, q, k, v, q_pos, kv_pos, q_seg, kv_seg):
    """The reference's dispatch: plain attention up to ``attn_chunk`` keys
    (2048 when unset), double-chunked online softmax beyond."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] <= (cfg.attn_chunk or 2048):
        return _plain_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale)
    return _chunked_attention(
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale, q_chunk=Q_CHUNK, kv_chunk=KV_CHUNK
    )


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _causal_flash(q, k, v, q_pos=None, kv_pos=None):
    """q: (B,Sq,K,G,hd), k/v: (B,Skv,K,hd), Sq <= Skv → (B,Sq,K·G,hd)
    through the kernel, q right-aligned to k (query i at key position
    i + Skv - Sq: a window of a prefill in token windows against every key
    up to its own last).

    Query head ``kh·G + g`` maps to kv head ``kh``, the kernel's
    ``h // group``; k and v go over as (B,K,Skv,hd).  Any lengths: q, k and
    v are padded with zeros at the end by the same number of rows, which
    keeps the alignment, to multiples of 64, and where Skv - Sq is not one,
    q takes the rows before it that make it so; the tile is 128 where that
    divides both padded lengths and 64 otherwise, and the padded query rows
    are dropped.  With ``q_pos`` (B,Sq) and ``kv_pos`` (B,Skv) the kernel
    keeps a key iff its position is at most the query's; the padded keys
    take position INT32_MAX and the padded queries INT32_MIN, so no real
    query sees a padded key.  Without, it masks by index, and the padded
    keys come after every real query.  A head dim the kernel does not take
    (the smoke configs' 16 or 24) is zero-padded to the next one it does
    (``kernel_head_dim``), at the scale 1/sqrt(hd), and the output's padded
    columns are cut off."""
    b, sq, kh, g, hd = q.shape
    skv = k.shape[1]
    front = (skv - sq) % FLASH_PAD
    pad = -(front + sq) % FLASH_PAD
    blk = 128 if (front + sq + pad) % 128 == 0 and (skv + pad) % 128 == 0 else 64
    widen = kernel_head_dim(q.dtype, hd) - hd
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kh * g, sq, hd)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    if front or pad or widen:
        qh = torch.nn.functional.pad(qh, (0, widen, front, pad))
        kt, vt = (torch.nn.functional.pad(x, (0, widen, 0, pad)) for x in (kt, vt))
    qh, kt, vt = qh.contiguous(), kt.contiguous(), vt.contiguous()
    if q_pos is not None:
        q_pos = torch.nn.functional.pad(q_pos.to(torch.int32), (front, pad), value=INT32_MIN).contiguous()
        kv_pos = torch.nn.functional.pad(kv_pos.to(torch.int32), (0, pad), value=INT32_MAX).contiguous()
    o = ops.flash_attention(qh, kt, vt, causal=True, sm_scale=1.0 / (hd**0.5), block_q=blk, block_k=blk,
                            q_pos=q_pos, kv_pos=kv_pos)
    return o[:, :, front:front + sq, :hd].transpose(1, 2)


def _prompt_positions(x: torch.Tensor, positions, t0: int = 0):
    """RoPE's positions for the prompt's tokens t0 .. t0+S-1, x (B,S,D):
    those columns of ``positions`` (B, the whole prompt), or ``arange`` of
    them in every row when the prompt carries none."""
    s = x.shape[1]
    if positions is None:
        return torch.arange(t0, t0 + s, device=x.device).expand(x.shape[0], s)
    return positions[:, t0:t0 + s]


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


def attn_train(cfg: ModelConfig, p: dict, x, positions, segment_ids):
    """Causal attention over x (B,S,D) within each document: a query sees
    the keys of its own segment at positions up to its own."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = _sdpa(cfg, _group(q, cfg.num_kv_heads), k, v, positions, positions, segment_ids, segment_ids)
    return _out(o.reshape(*x.shape[:2], cfg.num_heads, cfg.resolved_head_dim), p["wo"])


def _window_positions(positions, t0: int, t1: int):
    """The kernel's (q_pos, kv_pos) for the prompt's tokens t0 .. t1-1
    against its keys 0 .. t1-1, or (None, None): masked by index."""
    if positions is None:
        return None, None
    return positions[:, t0:t1], positions[:, :t1]


def attn_prefill(cfg: ModelConfig, p: dict, x, positions, cache: dict, t0: int = 0):
    """Causal attention over the prompt's tokens t0 .. t0+S-1, x (B,S,D), at
    ``positions`` (B, the whole prompt), which RoPE reads and the kernel
    masks by (a key is seen from positions at or after its own, as in the
    reference); ``None`` means ``arange`` in every row, masked by index.
    Writes the tokens' k and v into ``cache["k"|"v"][:, t0:t0+S]``
    (B,S_cap,K,hd); the queries attend to slots 0 .. t0+S-1, the cache's
    for the tokens before t0 (a window of a prefill in token windows)."""
    q, k, v = _qkv(cfg, p, x, _prompt_positions(x, positions, t0))
    t1 = t0 + x.shape[1]
    cache["k"][:, t0:t1] = k
    cache["v"][:, t0:t1] = v
    if t0:
        k, v = cache["k"][:, :t1], cache["v"][:, :t1]
    o = _causal_flash(_group(q, cfg.num_kv_heads), k, v, *_window_positions(positions, t0, t1))
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


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _mla_q(cfg: ModelConfig, p: dict, x, positions):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope)), RoPE on the rope dims only."""
    m = cfg.mla
    q = _proj(rms_norm_simple(x @ p["w_dq"], p["q_norm"]), p["w_uq"])
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_kv_latent(cfg: ModelConfig, p: dict, x, positions):
    """(ckv (B,S,rank), k_rope (B,S,rope)): what the cache holds."""
    m = cfg.mla
    dkv = x @ p["w_dkv"]
    ckv = rms_norm_simple(dkv[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def _mla_kv(p: dict, ckv, k_rope):
    """The non-absorbed k (B,S,H,nope+rope), every head's sharing the one
    rope key, and v (B,S,H,v_head_dim) of the latents."""
    k_nope = _proj(ckv, p["w_uk"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], k_rope.shape[-1])], dim=-1)
    return k, _proj(ckv, p["w_uv"])


def _mla_qkv(cfg: ModelConfig, p: dict, x, positions):
    """The non-absorbed form: q and k (B,S,H,nope+rope), every head's k
    sharing the one rope key, and v (B,S,H,v_head_dim); and the latents."""
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_kv_latent(cfg, p, x, positions)
    k, v = _mla_kv(p, ckv, k_rope)
    return torch.cat([q_nope, q_rope], dim=-1), k, v, ckv, k_rope


def mla_train(cfg: ModelConfig, p: dict, x, positions, segment_ids):
    """Causal MLA over x (B,S,D) within each document, through ``_sdpa``
    with the heads as kv groups of 1; the scale is 1/sqrt(nope + rope)."""
    q, k, v, _, _ = _mla_qkv(cfg, p, x, positions)
    o = _sdpa(cfg, q[:, :, :, None, :], k, v, positions, positions, segment_ids, segment_ids)
    return _out(o[:, :, :, 0, :], p["wo"])


def mla_prefill(cfg: ModelConfig, p: dict, x, positions, cache: dict, t0: int = 0):
    """Causal MLA over the prompt's tokens t0 .. t0+S-1, x (B,S,D), in the
    kernel (masked by ``positions`` or by index, as ``attn_prefill``): q
    and k of nope + rope dims, v zero-padded to that width, whose extra
    output columns are then zero and cut off; the scale is the kernel's
    default 1/sqrt(nope + rope), the reference's.  Writes the latents into
    ``cache["ckv"|"k_rope"][:, t0:t0+S]``; a window after the first takes
    the k and v of the tokens before it from the cache's latents."""
    q, k, v, ckv, k_rope = _mla_qkv(cfg, p, x, _prompt_positions(x, positions, t0))
    t1 = t0 + x.shape[1]
    cache["ckv"][:, t0:t1] = ckv
    cache["k_rope"][:, t0:t1] = k_rope
    if t0:
        k, v = _mla_kv(p, cache["ckv"][:, :t1], cache["k_rope"][:, :t1])
    vd = v.shape[-1]
    o = _causal_flash(q[:, :, :, None, :], k, torch.nn.functional.pad(v, (0, q.shape[-1] - vd)),
                      *_window_positions(positions, t0, t1))
    return _out(o[..., :vd], p["wo"])


def mla_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos: int):
    """x (B,1,D) at position ``pos``: its latents are written into the cache
    slot ``pos`` in place, and it attends to slots 0..pos in the absorbed
    form, scores in f32 against the latent cache."""
    m = cfg.mla
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)  # (B,1,H,·)
    ckv_new, kr_new = _mla_kv_latent(cfg, p, x, positions)
    cache["ckv"][:, pos:pos + 1] = ckv_new
    cache["k_rope"][:, pos:pos + 1] = kr_new
    ckv, k_rope = cache["ckv"], cache["k_rope"]
    q_lat = torch.einsum("bqkh,rkh->bqkr", q_nope, p["w_uk"])  # w_uk folded into the query
    s_lat = torch.einsum("bqkr,bsr->bkqs", q_lat.float(), ckv.float())
    s_rope = torch.einsum("bqkh,bsh->bkqs", q_rope.float(), k_rope.float())
    s = (s_lat + s_rope) * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    kv_ok = torch.arange(ckv.shape[1], device=x.device) <= pos  # unwritten slots masked
    prob = torch.softmax(torch.where(kv_ok, s, NEG_INF), dim=-1)
    o_lat = torch.einsum("bkqs,bsr->bqkr", prob.to(ckv.dtype), ckv)
    o = torch.einsum("bqkr,rkh->bqkh", o_lat, p["w_uv"])  # (B,1,H,v_head_dim)
    return _out(o, p["wo"])
