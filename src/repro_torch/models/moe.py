"""Top-k routed Mixture-of-Experts with capacity-based, batch-local dispatch.

The reference's formulation, kept shape for shape: routing in f32, the
Switch load-balance aux loss, then per sequence a stable sort of the
(token, choice) pairs by expert, each expert's first ``cap`` pairs kept
and the rest dropped.  All bulk data movement is batched gathers along
the sequence dim: dispatch into an (B, E, cap, D) buffer, the experts'
SwiGLU as batched products over E, and combine by one gather back to
token order and a gated sum over the k choices into one f32 (B, S, D)
accumulator.  The only scatter is a small integer slot -> token map of
(B, E*cap + 1), whose last column is the sentinel that dropped pairs land
on.  DeepSeek-style shared experts run as a dense FFN beside them.

Every shape is fixed by (B, S, E, k, cap): nothing in ``apply_moe`` reads
a tensor's values on the host (no boolean-mask indexing, ``nonzero`` or
``.item()``), so a layer on the card enqueues without waiting for it.

``apply_moe_windows`` is the layer in a prefill in token windows: the
router's logits window by window, the capacity rule over the whole
sequence (the same pairs kept and dropped as ``apply_moe``'s), then the
experts window by window over that window's kept pairs only, in buffers
sized by their count, which it reads on the host once a window.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import apply_ffn, dtype_of, ffn_defs, silu
from .params import ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    assert m is not None
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    dt = dtype_of(cfg)
    p = {
        "router": ParamDef((d, e), ("embed", None), torch.float32),
        "w_gate": ParamDef((e, d, f), ("experts", "expert_embed", "expert_ffn"), dt, fan_in_dims=(1,)),
        "w_up": ParamDef((e, d, f), ("experts", "expert_embed", "expert_ffn"), dt, fan_in_dims=(1,)),
        "w_down": ParamDef((e, f, d), ("experts", "expert_ffn", "expert_embed"), dt, fan_in_dims=(1,)),
    }
    if m.n_shared_experts:
        p["shared"] = ffn_defs(cfg, d_ff=m.n_shared_experts * m.d_expert)
    return p


def capacity_per_seq(cfg: ModelConfig, seq_len: int) -> int:
    m = cfg.moe
    c = int(seq_len * m.experts_per_token * m.capacity_factor / m.n_experts)
    return max(4, -(-c // 4) * 4)


def route(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> ``route_logits`` of its f32 router logits."""
    return route_logits(cfg, x.float() @ p["router"])


def route_logits(cfg: ModelConfig, logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's f32 logits (B,S,E) -> (probs (B,S,E) f32, gate (B,S,k)
    f32, idx (B,S,k) int64): their softmax, each token's top-k experts in
    descending order of probability and their gates renormalised to sum 1."""
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.experts_per_token, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, idx


def _by_expert(flat_e: torch.Tensor, e: int, cap: int):
    """Each sequence's pairs (B,N) stably sorted by expert: (order, their
    experts, each pair's rank within its expert in token order, keep = rank
    < cap), all in the sorted order."""
    n = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = flat_e.gather(1, order)
    counts = (flat_e[..., None] == torch.arange(e, device=flat_e.device)).sum(dim=1)  # (B,E)
    offsets = torch.cumsum(counts, dim=-1) - counts  # exclusive prefix per row
    pos = torch.arange(n, device=flat_e.device) - offsets.gather(1, e_sorted)
    return order, e_sorted, pos, pos < cap


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    """An index (B, N) as a gather index over rows of width d, not copied."""
    return t[..., None].expand(*t.shape, d)


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (y (B,S,D) in x's dtype, aux_loss f32 scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    k, e = m.experts_per_token, m.n_experts
    n = s * k
    cap = capacity_per_seq(cfg, s)
    dev = x.device

    # -- routing (f32) -------------------------------------------------------
    probs, gate, idx = route(cfg, p, x)

    # -- load-balance aux (Switch): one-hot counts, no scatter ---------------
    experts = torch.arange(e, device=dev)
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = (idx[..., None] == experts).float().mean(dim=(0, 1, 2))
    aux = e * torch.sum(me * ce) * m.router_aux_weight

    # -- per-sequence stable sort + capacity ---------------------------------
    flat_e = idx.reshape(b, n)  # (B,N), token t's k choices at t*k .. t*k+k-1
    flat_tok = torch.arange(s, device=dev)[:, None].expand(s, k).reshape(1, n).expand(b, n)
    order, e_sorted, pos, keep = _by_expert(flat_e, e, cap)
    tok_sorted = flat_tok.gather(1, order)
    slot = torch.where(keep, e_sorted * cap + pos, e * cap)  # sentinel slot E*cap

    # small slot -> token map, the ONLY scatter; only the sentinel column
    # takes several writes, and it is cut off before use
    slot_to_tok = torch.full((b, e * cap + 1), s, dtype=torch.int64, device=dev)  # sentinel token S
    slot_to_tok.scatter_(1, slot, tok_sorted)
    token_for_slot = slot_to_tok[:, : e * cap]  # (B, E*cap)

    # -- dispatch: batched gather; the sentinel token S reads a zero row -----
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    buf = x_pad.gather(1, _rows(token_for_slot, d)).reshape(b, e, cap, d)

    # -- expert SwiGLU, batched over experts ---------------------------------
    h = silu(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["w_up"])
    y_buf = torch.einsum("becf,efd->becd", h, p["w_down"]).reshape(b, e * cap, d)
    del x_pad, buf, h  # without autograd they go here, before the combine's gathers

    # -- combine: one batched gather straight to token order; a dropped
    # pair reads slot 0 and takes gate 0 (the reference's zero row).  The k
    # gated outputs are summed into one f32 (B,S,D) accumulator, choice by
    # choice: the reference's f32 sum, without its two f32 (B,S,k,D)
    # temporaries (at DeepSeek-V3's 32k prompt, 7.5 GB each a row) ---------
    inv_order = torch.argsort(order, dim=-1)
    keep_tok = keep.gather(1, inv_order)  # (B,N), token order
    slot_tok = torch.where(keep, slot, 0).gather(1, inv_order)
    y_tok = y_buf.gather(1, _rows(slot_tok, d)).reshape(b, s, k, d)
    gate = torch.where(keep_tok.reshape(b, s, k), gate, 0)
    y = y_tok[:, :, 0].float() * gate[..., 0, None]
    for j in range(1, k):
        y.add_(y_tok[:, :, j].float() * gate[..., j, None])

    if m.n_shared_experts:
        y = y + apply_ffn(cfg, p["shared"], x).float()
    return y.to(x.dtype), aux


def apply_moe_windows(cfg: ModelConfig, p: dict, norm, x: torch.Tensor, windows: list) -> None:
    """The MoE layer of a prefill in token windows: adds to the residual
    stream x (B,S,D), in place, the layer's output on ``norm(x)`` (its
    pre-FFN norm), window by window over ``windows`` ([t0, t1) covering
    0..S).  Capacity is per sequence, so the rule runs over the whole
    prompt: the router's f32 logits taken window by window and joined
    (B,S,E), each pair's rank within its expert in token order, ``keep =
    rank < capacity_per_seq(S)``, as ``apply_moe`` keeps them.  Then each
    window's kept pairs are gathered in expert order into a buffer of
    their count, each expert's SwiGLU runs on its rows, and the gated
    outputs are summed as ``apply_moe`` sums them (f32, choice by choice;
    a dropped pair adds 0).  The counts are read on the host once a window;
    no aux loss (a prefill does not read it)."""
    m = cfg.moe
    b, s, d = x.shape
    k, e = m.experts_per_token, m.n_experts
    logits = torch.cat([norm(x[:, t0:t1]).float() @ p["router"] for t0, t1 in windows], dim=1)
    _, gate, idx = route_logits(cfg, logits)
    del logits
    order, _, _, keep = _by_expert(idx.reshape(b, s * k), e, capacity_per_seq(cfg, s))
    keep = keep.gather(1, torch.argsort(order, dim=-1)).reshape(b, s, k)  # token order
    gate = torch.where(keep, gate, 0)
    for t0, t1 in windows:
        h = norm(x[:, t0:t1])
        w = t1 - t0
        flat_e = torch.where(keep[:, t0:t1], idx[:, t0:t1], e).reshape(-1)  # (B*W*k,), dropped pairs to E
        by_e = torch.argsort(flat_e, stable=True)  # kept pairs in expert order, the dropped after them
        counts = torch.bincount(flat_e, minlength=e + 1)[:e].tolist()
        kept = by_e[:sum(counts)]
        rows = h.reshape(b * w, d)[kept // k]
        out = torch.empty_like(rows)
        at = 0
        for ei, c in enumerate(counts):
            if c:
                r = rows[at:at + c]
                out[at:at + c] = (silu(r @ p["w_gate"][ei]) * (r @ p["w_up"][ei])) @ p["w_down"][ei]
            at += c
        del rows
        y_pair = h.new_zeros(b * w * k, d).index_copy_(0, kept, out).reshape(b, w, k, d)
        del out
        g = gate[:, t0:t1]
        y = y_pair[:, :, 0].float() * g[..., 0, None]
        for j in range(1, k):
            y.add_(y_pair[:, :, j].float() * g[..., j, None])
        del y_pair
        if m.n_shared_experts:
            y = y + apply_ffn(cfg, p["shared"], h).float()
        x[:, t0:t1].add_(y.to(x.dtype))
