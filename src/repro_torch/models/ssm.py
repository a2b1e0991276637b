"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060].

Prefill runs the chunked SSD scan in the hand-written ``ssd_scan`` kernel
(quadratic-within-chunk "dual" form plus the linear state recurrence
between chunks); decode runs the plain one-token recurrence.  Both write
the layer's state into a preallocated cache in place: ``cache["ssm"]``
(B, H, P, N) f32 and ``cache["conv"]`` (B, K-1, conv_dim), the last K-1
inputs of the causal conv.

Training (``ssd_block_train``) runs the same block through ``ssd_chunked``,
the reference's plain scan over chunks, under autograd: the ``ssd_scan``
kernel has no backward, and the reference trains through its jnp scan too.
``ssd_recurrent`` is the naive stepwise oracle the tests hold both to.

Shapes: x (B,L,H,P) head-split inputs, dt (B,L,H), A (H,) negative decay,
B/C (B,L,G,N) with G groups broadcast over heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dtype_of, rms_norm_simple, silu
from .params import ParamDef


def ssd_recurrent(x, dt, A, B, C, h0=None):
    """Naive stepwise oracle.  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ ;
    y_t = C_t · h_t.   Returns (y in x's dtype, h_final f32)."""
    b, l, nh, p = x.shape
    rep = nh // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2).float()  # (B,L,H,N)
    Ch = C.repeat_interleave(rep, dim=2).float()
    h = torch.zeros((b, nh, p, B.shape[-1]), device=x.device) if h0 is None else h0
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]  # (B,H,1,1)
        upd = (dt[:, t, :, None] * x[:, t].float())[..., None] * Bh[:, t, :, None, :]
        h = decay * h + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _segsum(z):
    """Stable 'segment sum': out[..., i, j] = sum_{j < k <= i} z[..., k],
    lower-triangular (i >= j), -inf above the diagonal."""
    l = z.shape[-1]
    cs = torch.cumsum(z, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (j, i]
    mask = torch.ones((l, l), dtype=torch.bool, device=z.device).tril()
    return torch.where(mask, diff, -torch.inf)


def _chunk_body(A, hprev, x_c, dt_c, B_c, C_c):
    """One chunk of ``ssd_chunked``: x_c (B,Q,H,P), dt_c (B,Q,H), B_c/C_c
    (B,Q,H,N), all f32; returns (y (B,Q,H,P), the state after the chunk)."""
    dA = dt_c * A  # (B,Q,H)
    dA_cs = torch.cumsum(dA, dim=1)
    # intra-chunk dual form
    L = torch.exp(_segsum(dA.transpose(1, 2)))  # (B,H,Q,Q)
    scores = torch.einsum("bqhn,bkhn->bhqk", C_c, B_c) * L
    y_diag = torch.einsum("bhqk,bkhp->bqhp", scores, dt_c[..., None] * x_c)
    # contribution of the carried prefix state
    in_decay = torch.exp(dA_cs)  # (B,Q,H)
    y_off = torch.einsum("bqhn,bhpn->bqhp", C_c, hprev) * in_decay[..., None]
    # state update
    decay_to_end = torch.exp(dA_cs[:, -1:, :] - dA_cs)  # (B,Q,H)
    s_c = torch.einsum("bqhn,bqhp->bhpn", B_c * (dt_c * decay_to_end)[..., None], x_c)
    hnew = hprev * torch.exp(dA_cs[:, -1, :])[:, :, None, None] + s_c
    return y_diag + y_off, hnew


def ssd_chunked(x, dt, A, B, C, h0=None, chunk: int = 64):
    """Chunked SSD scan, differentiable: the reference's ``lax.scan`` over
    chunks as a loop.  Per chunk, the dual (attention-like) form computes
    the intra-chunk terms, the carried state adds the prefix, and the state
    advances by one decay and a rank-Q update.  Each chunk is recomputed in
    the backward pass, as the reference's ``jax.checkpoint`` does, so the
    saved state is one (B,H,P,N) tensor a chunk.  Returns (y in x's dtype,
    h_final f32)."""
    b, l, nh, p = x.shape
    rep = nh // B.shape[2]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")
    xf = x.float()
    dtf = dt.float()
    Bf = B.repeat_interleave(rep, dim=2).float()
    Cf = C.repeat_interleave(rep, dim=2).float()
    h = torch.zeros((b, nh, p, B.shape[-1]), device=x.device) if h0 is None else h0
    ys = []
    for i in range(0, l, chunk):
        c = slice(i, i + chunk)
        y, h = checkpoint(_chunk_body, A, h, xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c], use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def ssd_decode_step(x, dt, A, B, C, h):
    """One-token recurrence.  x (B,H,P), dt (B,H), B/C (B,G,N), h (B,H,P,N).
    Returns (y (B,H,P) in x's dtype, h_new)."""
    b, nh, p = x.shape
    g, n = B.shape[1], B.shape[2]
    # heads as (group, head in group), so B and C broadcast instead of repeating
    xg = x.float().reshape(b, g, nh // g, p)
    dtg = dt.reshape(b, g, nh // g)
    decay = torch.exp(dt * A)[:, :, None, None]
    upd = (dtg[..., None] * xg)[..., None] * B.float()[:, :, None, None, :]  # (B,G,HG,P,N)
    hnew = decay * h + upd.reshape(b, nh, p, n)
    y = torch.einsum("bgkpn,bgn->bgkp", hnew.reshape(b, g, nh // g, p, n), C.float())
    return y.reshape(b, nh, p).to(x.dtype), hnew


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------


def ssd_defs(cfg: ModelConfig) -> dict:
    s = cfg.ssd
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    zxbcdt = 2 * di + 2 * s.n_groups * s.d_state + nh
    dt = dtype_of(cfg)
    return {
        "in_proj": ParamDef((d, zxbcdt), ("embed", "d_inner"), dt),
        "conv_w": ParamDef((s.d_conv, conv_dim), (None, "conv_dim"), dt),
        "conv_b": ParamDef((conv_dim,), ("conv_dim",), dt, "zeros"),
        "A_log": ParamDef((nh,), ("ssd_heads",), torch.float32, "zeros"),
        "dt_bias": ParamDef((nh,), ("ssd_heads",), torch.float32, "zeros"),
        "D": ParamDef((nh,), ("ssd_heads",), torch.float32, "ones"),
        "norm": ParamDef((di,), ("d_inner",), torch.float32, "ones"),
        "out_proj": ParamDef((di, d), ("d_inner", "embed"), dt),
    }


def _split_zxbcdt(cfg: ModelConfig, zxbcdt):
    s = cfg.ssd
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di : 2 * di + 2 * gn]
    dt_raw = zxbcdt[..., 2 * di + 2 * gn :]
    return z, xBC, dt_raw


def _causal_conv(xBC, w, b, ctx=None):
    """Depthwise causal conv over time.  xBC (B,L,C), w (K,C): the K-tap
    FIR summed tap by tap in xBC's dtype, as the reference does.  The K-1
    inputs before the first are zeros, or ``ctx`` (B,K-1,C): those of a
    window before this one."""
    k, l = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0)) if ctx is None else torch.cat([ctx, xBC], dim=1)
    y = pad[:, 0:l, :] * w[0]
    for i in range(1, k):
        y = y + pad[:, i : i + l, :] * w[i]
    return y + b


def _conv_step(x_t, conv_state, w, b):
    """x_t (B,C); conv_state (B,K-1,C) holding the previous inputs."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B,K,C)
    y = torch.einsum("bkc,kc->bc", full, w) + b
    return y, full[:, 1:, :]


def _last_conv_window(xBC, d_conv):
    l = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, max(0, d_conv - 1 - l), 0))
    return pad[:, -(d_conv - 1) :, :]


def _best_chunk(l, pref):
    for c in (pref, 128, 64, 32, 16, 8, 4, 2, 1):
        if c <= l and l % c == 0:
            return c
    return 1


def scan_chunk(cfg: ModelConfig, l: int) -> int:
    """The reference's chunk for a prompt of ``l`` tokens: ``SSDConfig.chunk``
    where it divides ``l``, else the largest of 128, 64, ... that does."""
    c = min(cfg.ssd.chunk, l)
    return c if l % c == 0 else _best_chunk(l, cfg.ssd.chunk)


def _gate_norm_out(p: dict, y, xs, z):
    """y + D * x, gated by silu(z), normed and projected.  ``D * xs`` makes
    y f32, as in the reference, so the norm and the output projection run
    in f32 (the bf16 ``out_proj`` is widened to f32 for the product)."""
    y = y + p["D"][:, None] * xs
    y = y.reshape(*y.shape[:-2], -1)
    y = rms_norm_simple(y * silu(z), p["norm"])
    return y @ p["out_proj"].float()


def _mixer_inputs(cfg: ModelConfig, p: dict, xBC_raw, dt_raw, conv_ctx=None):
    """The scan's inputs from the in-projection: conv (its left context
    ``conv_ctx``, else zeros) + silu, split into x (B,L,H,P), B and C
    (B,L,G,N); dt (B,L,H) f32 and A (H,)."""
    s = cfg.ssd
    b, l = xBC_raw.shape[:2]
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    xBC = silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"], conv_ctx))
    xs = xBC[..., :di].reshape(b, l, s.n_heads(cfg.d_model), s.head_dim).contiguous()
    Bm = xBC[..., di : di + gn].reshape(b, l, s.n_groups, s.d_state).contiguous()
    Cm = xBC[..., di + gn :].reshape(b, l, s.n_groups, s.d_state).contiguous()
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,L,H)
    return xs, dtv, -torch.exp(p["A_log"]), Bm, Cm


def ssd_block_train(cfg: ModelConfig, p: dict, x, positions=None, segment_ids=None):
    """The block over x (B,L,D) with ``ssd_chunked`` in the reference's
    chunk (``scan_chunk``).  Like the reference it ignores ``positions``
    and ``segment_ids``: the state runs on across packed documents."""
    l = x.shape[1]
    z, xBC_raw, dt_raw = _split_zxbcdt(cfg, x @ p["in_proj"])
    xs, dtv, A, Bm, Cm = _mixer_inputs(cfg, p, xBC_raw, dt_raw)
    y, _ = ssd_chunked(xs, dtv, A, Bm, Cm, chunk=scan_chunk(cfg, l))
    return _gate_norm_out(p, y, xs, z)


def ssd_block_prefill(cfg: ModelConfig, p: dict, x, positions, cache: dict, t0: int = 0):
    """The block over the prompt's tokens t0 .. t0+L-1, x (B,L,D); writes the
    state after them and the last conv window into ``cache["ssm"]`` and
    ``cache["conv"]``.  With ``t0`` > 0 (a window of a prefill in token
    windows) it continues from the cache: the conv window is its left
    context and the state the scan's ``h0``."""
    l = x.shape[1]
    z, xBC_raw, dt_raw = _split_zxbcdt(cfg, x @ p["in_proj"])
    ctx = h0 = None
    if t0:
        ctx, h0 = cache["conv"].clone(), cache["ssm"]
        tail = torch.cat([ctx, xBC_raw[:, -(cfg.ssd.d_conv - 1):]], dim=1)
        cache["conv"].copy_(_last_conv_window(tail, cfg.ssd.d_conv))
    else:
        cache["conv"].copy_(_last_conv_window(xBC_raw, cfg.ssd.d_conv))  # for decode continuation
    xs, dtv, A, Bm, Cm = _mixer_inputs(cfg, p, xBC_raw, dt_raw, ctx)
    y, h_fin = ops.ssd_scan(xs, dtv, A, Bm, Cm, chunk=scan_chunk(cfg, l), h0=h0)
    cache["ssm"].copy_(h_fin)
    return _gate_norm_out(p, y, xs, z)


def ssd_block_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos: int):
    """x (B,1,D); advances ``cache["ssm"]`` (B,H,P,N) f32 and
    ``cache["conv"]`` (B,K-1,C) in place by one token."""
    s = cfg.ssd
    b = x.shape[0]
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state

    zxbcdt = x[:, 0, :] @ p["in_proj"]  # (B, zxbcdt)
    z, xBC, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    xBC, conv_state = _conv_step(xBC, cache["conv"], p["conv_w"], p["conv_b"])
    cache["conv"].copy_(conv_state)
    xBC = silu(xBC)
    xs = xBC[..., :di].reshape(b, nh, s.head_dim)
    Bm = xBC[..., di : di + gn].reshape(b, s.n_groups, s.d_state)
    Cm = xBC[..., di + gn :].reshape(b, s.n_groups, s.d_state)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])

    y, h_new = ssd_decode_step(xs, dtv, A, Bm, Cm, cache["ssm"])
    cache["ssm"].copy_(h_new)
    return _gate_norm_out(p, y, xs, z)[:, None, :]
