"""Carry a reference parameter tree across to the port.

The reference keeps its parameters as a tree of JAX arrays; a caller turns
it into numpy arrays (``jax.tree.map(np.asarray, params)``) and hands it
here.  The port's tree has the same nesting, ``{"embed", "segments":
[{"blocks": [...]}], "final_norm", "head"}``, stacked leading layers dim
included, so ``Model`` runs on it unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # numpy has no bf16: cross as its 16 bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree: Any, device: torch.device | str = "cpu") -> Any:
    """The port's parameter tree from the reference's, as numpy arrays."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return _tensor(tree, device)
    raise TypeError(f"unexpected leaf {type(tree).__name__}; pass numpy arrays")
