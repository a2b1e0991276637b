"""Step builders: train, prefill and decode steps bound to a device.

The counterpart of the reference's ``launch/steps.py`` for one card: a step
moves its integer inputs to the device and runs the model, the serving
steps under ``torch.inference_mode()``; ``build_step`` picks the builder
for a shape's kind.  The reference's sharded steps and their sharding
helpers wait for its missing ``repro.dist`` (ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..models.model import Model
from ..optim import OptConfig, apply_update
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass
class StepBundle:
    """One (arch × shape) step: the model and the callable that runs it."""

    model: Model
    shape: ShapeConfig
    fn: Callable
    opt_cfg: OptConfig | None = None


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    return OptConfig(kind=cfg.optimizer)


def build_train_step(
    cfg: ModelConfig, shape: ShapeConfig, *, grad_accum: int | None = None, device=None
) -> StepBundle:
    """``fn(params, opt_state, batch)`` → (params, opt_state, metrics): one
    optimizer step on ``batch`` (``tokens``, ``labels`` and optionally
    ``positions`` and ``segment_ids``, (B, S) integers; ``tokens`` and
    ``labels`` (B, S, n_codebooks) for a multi-codebook config; and
    ``vis_embed`` (B, vis_prefix_len, d_model) for a vision-prefix config;
    every entry moved to the device here), with the parameters and the state updated in place and the
    metrics as 0-d tensors on the device, nothing waited for.

    With ``grad_accum`` (default ``cfg.grad_accum[shape.name]``, else 1)
    above 1 the batch is cut into that many microbatches of consecutive
    rows; their gradients are summed in the parameters' dtypes, starting
    from zeros, and divided by the count, and the metrics are the last
    microbatch's, as in the reference.  The step marks the parameters as
    requiring grad."""
    dev = resolve_device(device, "build_train_step")
    model = Model(cfg)
    opt_cfg = opt_config_for(cfg)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum.get(shape.name, 1)

    def grads_of(leaves, params, batch):
        loss, metrics = model.train_loss(params, batch)
        # an unused parameter gets a zero gradient, as from jax.grad
        return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True), metrics

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        if accum > 1:
            rows, rest = divmod(next(iter(batch.values())).shape[0], accum)
            if rest:
                raise ValueError(f"a batch of {rows * accum + rest} rows does not split into {accum} microbatches")
            grads = [torch.zeros_like(p) for p in leaves]
            for i in range(accum):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                micro, metrics = grads_of(leaves, params, mb)
                for g, m in zip(grads, micro):
                    g.add_(m)
                del micro
            for g in grads:
                g.div_(accum)
        else:
            grads, metrics = grads_of(leaves, params, batch)
        grad_of = {id(p): g for p, g in zip(leaves, grads)}
        grads = tree_map(lambda p: grad_of[id(p)], params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, opt_metrics = apply_update(opt_cfg, params, grads, opt_state)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return StepBundle(model, shape, train_step, opt_cfg)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, device=None) -> StepBundle:
    """``fn(params, batch, seq_cap=None, window=None)`` → (logits, cache of
    capacity seq_cap), in token windows past ``window`` (``Model.prefill``);
    ``batch`` holds ``tokens`` (B, S), or (B, S, n_codebooks) for a
    multi-codebook config, optionally ``positions`` (B, S), and for a
    vision-prefix config ``vis_embed`` (B, vis_prefix_len, d_model); each
    is moved to the device here."""
    dev = resolve_device(device, "build_prefill_step")
    model = Model(cfg)

    @torch.inference_mode()
    def prefill(params, batch, seq_cap=None, window=None):
        inputs = {name: torch.as_tensor(batch[name]).to(dev) for name in ("tokens", "positions", "vis_embed")
                  if name in batch}
        return model.prefill(params, inputs, seq_cap, window)

    return StepBundle(model, shape, prefill)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, device=None) -> StepBundle:
    """``fn(params, cache, tokens, pos)`` → (logits, the cache, written in
    place); tokens (B, 1), or (B, 1, n_codebooks) for a multi-codebook
    config, whose logits are (B, n_codebooks, padded_vocab)."""
    dev = resolve_device(device, "build_decode_step")
    model = Model(cfg)

    @torch.inference_mode()
    def decode(params, caches, tokens, pos: int):
        return model.decode_step(params, caches, torch.as_tensor(tokens).to(dev), int(pos))

    return StepBundle(model, shape, decode)


def build_step(cfg: ModelConfig, shape: ShapeConfig, device=None, **kw) -> StepBundle:
    """The step builder for ``shape.kind``: train (``kw`` goes to
    ``build_train_step``), prefill or decode."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, device=device, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, device, **kw)
    return build_decode_step(cfg, shape, device)
