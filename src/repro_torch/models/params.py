"""Parameter declaration: shapes, logical axes and initializers.

Model code declares its parameters as trees (dicts and lists) of
``ParamDef``; ``init_params`` materializes one on a device, and
``abstract_params`` gives its shapes and dtypes on the meta device, for
planning a model too large for the host.  ``param_pspecs`` and
``shard_info`` map the logical axis names ("embed", "heads", "ffn",
"vocab", ...) through a rules dict to mesh-axis names, and count the bytes
each device of a mesh would hold; they need no mesh.
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


# ---------------------------------------------------------------------------
# planning: shapes and sharding specs without allocation or a mesh
# ---------------------------------------------------------------------------


def abstract_params(tree: Pytree) -> Pytree:
    """The tree as tensors on ``torch.device("meta")``: each leaf's shape and
    dtype, no storage (the counterpart of the reference's
    ``jax.ShapeDtypeStruct`` tree), so a full-size model is planned on any
    host."""
    return tree_map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), tree)


def logical_specs(tree: Pytree) -> Pytree:
    """Tree of logical-axis tuples (same structure as params)."""
    return tree_map_defs(lambda d: d.axes, tree)


def resolve_pspec(axes: tuple[str | None, ...], rules: dict[str, Any]) -> tuple:
    """Map logical axes to mesh axes: the entries of the reference's
    ``PartitionSpec`` as a plain tuple, each ``None``, a mesh-axis name or a
    tuple of names.  A rule value may be a mesh-axis name, a tuple of names,
    or None.  A mesh axis may be used at most once per param; later dims
    lose (stay replicated) if an axis is already taken.  Trailing ``None``s
    are dropped."""
    used: set[str] = set()
    out: list[Any] = []
    for ax in axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is None:
            out.append(None)
            continue
        axs = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        free = tuple(a for a in axs if a not in used)
        if not free:
            out.append(None)
            continue
        used.update(free)
        out.append(free if len(free) > 1 else free[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_pspecs(tree: Pytree, rules: dict[str, Any]) -> Pytree:
    return tree_map_defs(lambda d: resolve_pspec(d.axes, rules), tree)


def shard_info(tree: Pytree, rules: dict[str, Any], mesh_shape: dict[str, int]) -> dict:
    """Bytes-per-device accounting for capacity planning: each leaf's bytes,
    and its share on one device of a mesh of ``mesh_shape`` (axis name →
    size) under ``rules``, rounded down as the reference rounds."""
    total = 0
    per_device = 0
    for d in _leaves(tree):
        bytes_ = math.prod(d.shape) * d.dtype.itemsize
        div = 1
        for entry in resolve_pspec(d.axes, rules):
            if entry is None:
                continue
            for ax in entry if isinstance(entry, tuple) else (entry,):
                div *= mesh_shape.get(ax, 1)
        total += bytes_
        per_device += bytes_ // div
    return {"total_bytes": total, "per_device_bytes": per_device}
