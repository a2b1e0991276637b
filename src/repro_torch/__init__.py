"""repro_torch — the SPDL data loader on PyTorch and CUDA.

The PyTorch port of the JAX package ``repro``, module for module
(``repro/data/transfer.py`` ↔ ``repro_torch/data/transfer.py``).  It holds
the image loader's path to the card: the pipeline engine (``core``), the
on-disk dataset, sampler and slab arena (``data``), the host→device
transfer, and the hand-written CUDA kernels that decode uint8 batches on
the card (``kernels``).  Entry points run on ``torch.device("cuda")``
unless the caller passes ``device="cpu"``.
"""
