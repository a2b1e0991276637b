"""Serving step builders: prefill and decode steps bound to a device.

The counterpart of the reference's ``launch/steps.py`` for one card: a step
moves its integer inputs to the device and runs the model under
``torch.inference_mode()``.  Train steps and the sharded steps of a
distributed launcher come with later slices (ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import Model
from ..device import resolve_device


@dataclasses.dataclass
class StepBundle:
    """One (arch × shape) step: the model and the callable that runs it."""

    model: Model
    shape: ShapeConfig
    fn: Callable


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, device=None) -> StepBundle:
    """``fn(params, batch, seq_cap=None)`` → (logits, cache of capacity seq_cap);
    ``batch`` holds ``tokens`` and, optionally, ``positions``."""
    dev = resolve_device(device, "build_prefill_step")
    model = Model(cfg)

    @torch.inference_mode()
    def prefill(params, batch, seq_cap=None):
        inputs = {name: torch.as_tensor(batch[name]).to(dev) for name in ("tokens", "positions") if name in batch}
        return model.prefill(params, inputs, seq_cap)

    return StepBundle(model, shape, prefill)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, device=None) -> StepBundle:
    """``fn(params, cache, tokens (B, 1), pos)`` → (logits, the cache, written in place)."""
    dev = resolve_device(device, "build_decode_step")
    model = Model(cfg)

    @torch.inference_mode()
    def decode(params, caches, tokens, pos: int):
        return model.decode_step(params, caches, torch.as_tensor(tokens).to(dev), int(pos))

    return StepBundle(model, shape, decode)
