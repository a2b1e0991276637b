"""Carry a reference tree of arrays across to the port, and back.

The reference keeps its parameters and optimizer state as trees of JAX
arrays; a caller turns one into numpy arrays (``jax.tree.map(np.asarray,
params)``) and hands it here.  The port's trees have the same nesting,
``{"embed", "segments": [{"blocks": [...]}], "final_norm", "head"}`` with
the stacked leading layers dim (``embed.tok`` (n_codebooks, padded_vocab,
d_model); ``vis_proj`` and ``mtp`` beside them where the config has
them), and ``{"step", "m", "v"}`` (or ``"m"``, or
``"f"``) around it for the optimizer, so ``Model`` and ``optim`` run on
them unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_map


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # numpy has no bf16: cross as its 16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree: Any, device: torch.device | str | None = None) -> Any:
    """The port's tree from the reference's, as numpy arrays, on ``device``
    (``None`` = the card).  0-d leaves, such as the optimizer's int32
    ``step``, cross as 0-d tensors."""
    dev = resolve_device(device, "params_from_reference")

    def one(a):
        if not isinstance(a, (np.ndarray, np.generic)):
            raise TypeError(f"unexpected leaf {type(a).__name__}; pass numpy arrays")
        return _tensor(a, dev)

    return tree_map(one, tree)


def tree_to_numpy(tree: Any) -> Any:
    """A port tree as numpy copies on the host; bf16 leaves widen to float32,
    which holds every bf16 value exactly."""

    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)
