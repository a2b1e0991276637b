"""Block assembly: (mixer + FFN/MoE) layers, grouped into stacked segments.

``cfg.segments()`` splits the layer stack into repetitions of identical
super-blocks.  Parameters of a segment are stacked (leading "layers" dim),
as in the reference, and a segment is applied by a Python loop over that
dim, indexing views of the stacked weights and caches (the reference's
``lax.scan``).  Three mixers: GQA attention (``attn``) and DeepSeek's MLA
(``mla``), each with its prefill in the ``flash_attention`` kernel, and the
Mamba2 SSD block (``ssd``, prefill in the ``ssd_scan`` kernel); training
runs them in plain PyTorch under autograd, with each layer recomputed in
the backward pass when ``cfg.remat`` (the reference's ``jax.checkpoint`` of
the scan body).  The FFN of a layer is dense or Mixture-of-Experts
(``models/moe.py``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention, moe, ssm
from .layers import apply_ffn, apply_norm, ffn_defs, norm_defs
from .params import ParamDef, tree_map_defs

MIXER_DEFS = {"attn": attention.attn_defs, "mla": attention.mla_defs, "ssd": ssm.ssd_defs}
MIXER_TRAIN = {"attn": attention.attn_train, "mla": attention.mla_train, "ssd": ssm.ssd_block_train}
MIXER_PREFILL = {"attn": attention.attn_prefill, "mla": attention.mla_prefill, "ssd": ssm.ssd_block_prefill}
MIXER_DECODE = {"attn": attention.attn_decode, "mla": attention.mla_decode, "ssd": ssm.ssd_block_decode}


# ---------------------------------------------------------------------------
# per-layer defs / apply
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig, kind: str, is_moe: bool) -> dict:
    d: dict[str, Any] = {"norm1": norm_defs(cfg), "mixer": MIXER_DEFS[kind](cfg)}
    if is_moe or cfg.d_ff > 0:
        d["norm2"] = norm_defs(cfg)
        d["ffn"] = moe.moe_defs(cfg) if is_moe else ffn_defs(cfg)
    return d


def _ffn_residual(cfg: ModelConfig, is_moe: bool, p: dict, x):
    """x + the layer's FFN (dense or MoE) of its norm; returns (x, the
    MoE's aux loss, or None for a dense FFN or none)."""
    aux = None
    if "ffn" in p:
        h = apply_norm(cfg, p["norm2"], x)
        if is_moe:
            y, aux = moe.apply_moe(cfg, p["ffn"], h)
        else:
            y = apply_ffn(cfg, p["ffn"], h)
        x = x + y.to(x.dtype)
    return x, aux


def block_apply_train(cfg: ModelConfig, kind: str, is_moe: bool, p: dict, x, positions, segment_ids):
    """Returns (x, the MoE's aux loss or None)."""
    h = apply_norm(cfg, p["norm1"], x)
    x = x + MIXER_TRAIN[kind](cfg, p["mixer"], h, positions, segment_ids).to(x.dtype)
    return _ffn_residual(cfg, is_moe, p, x)


def block_apply_prefill(cfg: ModelConfig, kind: str, is_moe: bool, p: dict, x, positions, cache: dict,
                        windows: list | None = None):
    """The layer over the prompt x (B,S,D), window by window over
    ``windows`` ([t0, t1) covering 0..S; None: the whole prompt as one),
    each per-token op adding into x in place: the mixer (each window
    continues from the cache the ones before it wrote), then the FFN.  A
    MoE FFN over more than one window routes over the whole prompt
    (``moe.apply_moe_windows``)."""
    windows = windows or [(0, x.shape[1])]
    for t0, t1 in windows:
        h = apply_norm(cfg, p["norm1"], x[:, t0:t1])
        x[:, t0:t1].add_(MIXER_PREFILL[kind](cfg, p["mixer"], h, positions, cache, t0).to(x.dtype))
    if "ffn" not in p:
        return x
    if is_moe and len(windows) > 1:
        moe.apply_moe_windows(cfg, p["ffn"], lambda t: apply_norm(cfg, p["norm2"], t), x, windows)
        return x
    for t0, t1 in windows:
        h = apply_norm(cfg, p["norm2"], x[:, t0:t1])
        y = moe.apply_moe(cfg, p["ffn"], h)[0] if is_moe else apply_ffn(cfg, p["ffn"], h)
        x[:, t0:t1].add_(y.to(x.dtype))
    return x


def block_apply_decode(cfg: ModelConfig, kind: str, is_moe: bool, p: dict, x, cache: dict, pos: int):
    h = apply_norm(cfg, p["norm1"], x)
    x = x + MIXER_DECODE[kind](cfg, p["mixer"], h, cache, pos).to(x.dtype)
    return _ffn_residual(cfg, is_moe, p, x)[0]


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


def stack_defs(tree: Any, n: int) -> Any:
    """Prepend a stacked "layers" dim of size n to every ParamDef."""
    return tree_map_defs(
        lambda d: ParamDef(
            (n, *d.shape),
            ("layers", *d.axes),
            d.dtype,
            d.init,
            tuple(i + 1 for i in d.fan_in_dims) if d.fan_in_dims else (),
        ),
        tree,
    )


def segment_defs(cfg: ModelConfig) -> list[dict]:
    segs = []
    for plan, n_repeat in cfg.segments():
        blocks = [block_defs(cfg, kind, is_moe) for kind, is_moe in plan]
        segs.append({"blocks": [stack_defs(b, n_repeat) for b in blocks]})
    return segs


def _layer(tree: Any, i: int) -> Any:
    """Layer i of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def segment_train(cfg: ModelConfig, segment, seg_params: dict, x, positions, segment_ids):
    """The training apply of one ``(super_block_plan, n_repeat)`` segment;
    returns (x, the sum of its MoE layers' aux losses).  With ``cfg.remat``
    each repeat of the super-block keeps only its input for the backward
    pass and runs again there (``remat_policy`` picks what the reference's
    XLA keeps inside a layer; here nothing is kept)."""
    plan, n_repeat = segment

    def inner(x, layer):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (kind, is_moe) in enumerate(plan):
            x, a = block_apply_train(
                cfg, kind, is_moe, _layer(seg_params["blocks"][i], layer), x, positions, segment_ids
            )
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(n_repeat):
        if cfg.remat:
            x, a = checkpoint(inner, x, layer, use_reentrant=False)
        else:
            x, a = inner(x, layer)
        aux = aux + a
    return x, aux


def segment_prefill(cfg: ModelConfig, segment, seg_params: dict, seg_cache: dict, x, positions,
                    windows: list | None = None):
    """``segment`` is one ``(super_block_plan, n_repeat)`` of ``cfg.segments()``;
    layer by layer, each over ``windows`` (``block_apply_prefill``)."""
    plan, n_repeat = segment
    for layer in range(n_repeat):
        for i, (kind, is_moe) in enumerate(plan):
            x = block_apply_prefill(
                cfg, kind, is_moe, _layer(seg_params["blocks"][i], layer), x, positions,
                _layer(seg_cache["blocks"][i], layer), windows,
            )
    return x


def segment_decode(cfg: ModelConfig, segment, seg_params: dict, seg_cache: dict, x, pos: int):
    plan, n_repeat = segment
    for layer in range(n_repeat):
        for i, (kind, is_moe) in enumerate(plan):
            x = block_apply_decode(
                cfg, kind, is_moe, _layer(seg_params["blocks"][i], layer), x,
                _layer(seg_cache["blocks"][i], layer), pos,
            )
    return x
