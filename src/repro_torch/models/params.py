"""Parameter declaration: shapes, logical axes and initializers.

Model code declares its parameters as trees (dicts and lists) of
``ParamDef``; ``init_params`` materializes one on a device.  The logical
axis names ("embed", "heads", "ffn", "vocab", ...) are kept for the
sharding rules a distributed launcher will map them through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..device import resolve_device

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim (None = never sharded)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | embed_normal
    fan_in_dims: tuple[int, ...] = ()  # dims forming fan-in for scaled init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_map_defs(fn: Callable[[ParamDef], Any], tree: Pytree) -> Pytree:
    """Apply ``fn`` to every ``ParamDef`` of a tree of dicts and lists."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_defs(fn, v) for v in tree)
    raise TypeError(f"unexpected node {type(tree).__name__} in a parameter tree")


def _leaves(tree: Pytree) -> list[ParamDef]:
    out: list[ParamDef] = []
    tree_map_defs(out.append, tree)
    return out


def param_count(tree: Pytree) -> int:
    return sum(math.prod(d.shape) for d in _leaves(tree))


def init_params(tree: Pytree, seed: int, device: torch.device | str | None = None) -> Pytree:
    """Materialize a ``ParamDef`` tree on ``device`` (``None`` = the card).

    The scales are the reference's: N(0, 1) for ``embed_normal``, else
    N(0, 1 / fan_in), fan-in over ``fan_in_dims`` or the second-to-last
    dim.  Draws come from one ``torch.Generator`` on ``device`` seeded with
    ``seed``, in the tree's order; they are not JAX's random stream."""
    dev = resolve_device(device, "init_params")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def one(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=dev)
        fan_in = (
            math.prod(d.shape[dim] for dim in d.fan_in_dims)
            if d.fan_in_dims
            else (d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
        )
        scale = 1.0 if d.init == "embed_normal" else 1.0 / math.sqrt(max(1, fan_in))
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
        return (x * scale).to(d.dtype)

    return tree_map_defs(one, tree)
