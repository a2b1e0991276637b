"""Public entry points for the kernels, dispatched on the tensor's device.

The counterpart of ``repro.kernels.ops``: where the JAX package chose
between the Pallas kernel, its interpret mode and the jnp reference with a
``use_pallas`` flag, here the device of the input decides.  A CPU tensor
runs the plain PyTorch version; a CUDA tensor launches the hand-written
kernel or raises.  There is no flag, no interpret mode and no fallback.
"""

from __future__ import annotations

from .dequant_normalize import dequant_normalize, dequant_normalize_augment
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan

__all__ = ["dequant_normalize", "dequant_normalize_augment", "flash_attention", "ssd_scan"]
