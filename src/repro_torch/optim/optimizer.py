"""Optimizers: AdamW (f32 or bf16 moments), SGD-momentum, Adafactor.

Plain functions on trees of tensors that repeat the reference's arithmetic
(``repro.optim.optimizer``) op for op in f32, not ``torch.optim``.  The
state tree has the reference's nesting and dtypes: ``{"step": int32 0-d,
"m": ..., "v": ...}`` for AdamW (moments in bf16 for ``adamw_bf16``),
``{"step", "m"}`` for SGD-momentum, and ``{"step", "f"}`` for Adafactor,
whose leaves hold the factored second moment (``vr``/``vc``) of a matrix or
the full one (``v``) of a vector.  ``apply_update`` writes the new
parameters and state into the given tensors in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adamw_bf16 | sgdm | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to 10%, in f32 (a 0-d tensor)."""
    step = step.float()
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _moment_dtype(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.kind == "adamw_bf16" else torch.float32


def _zeros(p: torch.Tensor, shape=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=dtype, device=p.device)


def _factored(p: torch.Tensor) -> dict:
    if p.dim() >= 2:
        return {"vr": _zeros(p, p.shape[:-1]), "vc": _zeros(p, (*p.shape[:-2], p.shape[-1]))}
    return {"v": _zeros(p)}


def init_opt_state(cfg: OptConfig, params: Any) -> dict:
    """Zeroed state for ``params``, on their device."""
    leaves = tree_leaves(params)
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
    if cfg.kind in ("adamw", "adamw_bf16"):
        mdt = _moment_dtype(cfg)
        return {
            "step": step,
            "m": tree_map(lambda p: _zeros(p, dtype=mdt), params),
            "v": tree_map(lambda p: _zeros(p, dtype=mdt), params),
        }
    if cfg.kind == "sgdm":
        return {"step": step, "m": tree_map(_zeros, params)}
    if cfg.kind == "adafactor":
        return {"step": step, "f": tree_map(_factored, params)}
    raise ValueError(cfg.kind)


def abstract_opt_state(cfg: OptConfig, abstract_params: Any) -> dict:
    """``init_opt_state``'s tree on the meta device: the state's shapes and
    dtypes for a parameter tree (such as ``Model.abstract_params()``), no
    storage."""
    return init_opt_state(cfg, tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
                                        abstract_params))


def global_norm(tree: Any) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def apply_update(cfg: OptConfig, params: Any, grads: Any, state: dict) -> tuple[Any, dict, dict]:
    """One step: gradients clipped to ``clip_norm`` by their global norm,
    then the ``kind``'s update.  Each parameter takes its f32 update and is
    cast back to its dtype, in place.  Returns (params, state, {"grad_norm",
    "lr"}), the first two the objects given, updated."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0) if cfg.clip_norm else 1.0
    metrics = {"grad_norm": gnorm, "lr": lr}

    if cfg.kind in ("adamw", "adamw_bf16"):
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def adamw(p, g, m, v):
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * g * g
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m32.to(m.dtype))
            v.copy_(v32.to(v.dtype))

        tree_map(adamw, params, grads, state["m"], state["v"])
    elif cfg.kind == "sgdm":
        def sgdm(p, g, m):
            g = g.float() * scale + cfg.weight_decay * p.float()
            m32 = 0.9 * m + g
            p.copy_((p.float() - lr * m32).to(p.dtype))
            m.copy_(m32)

        tree_map(sgdm, params, grads, state["m"])
    elif cfg.kind == "adafactor":
        d = 1e-30

        def adafactor(p, g, f):  # f: this parameter's {"vr", "vc"} or {"v"}
            g = g.float() * scale
            g2 = g * g + d
            if p.dim() >= 2:
                vr = 0.999 * f["vr"] + 0.001 * g2.mean(dim=-1)
                vc = 0.999 * f["vc"] + 0.001 * g2.mean(dim=-2)
                denom = (
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None], min=d)
                )
                upd = g / (torch.sqrt(denom) + cfg.eps)
                f["vr"].copy_(vr)
                f["vc"].copy_(vc)
            else:
                v = 0.999 * f["v"] + 0.001 * g2
                upd = g / (torch.sqrt(v) + cfg.eps)
                f["v"].copy_(v)
            p.copy_((p.float() - lr * (upd + cfg.weight_decay * p.float())).to(p.dtype))

        tree_map(adafactor, params, grads, state["f"])
    else:
        raise ValueError(cfg.kind)
    state["step"].copy_(step)
    return params, state, metrics

