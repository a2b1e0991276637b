"""The port's default device: the card, unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None, what: str) -> torch.device:
    """``None`` means ``torch.device("cuda")``; raise when the card is asked
    for and torch sees none, rather than pick the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: {dev} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev
