"""repro_torch — the SPDL data loader on PyTorch and CUDA.

The PyTorch port of the JAX package ``repro``, module for module
(``repro/data/transfer.py`` ↔ ``repro_torch/data/transfer.py``).  It holds
the pipeline engine with its health monitor, metrics exporter, fault
injection and autotuner (``core``); the on-disk dataset, sampler, slab
arena and the sharded record store (``data``, ``data.shards``); the image
and LM loaders and the host→device transfer; the LM serving and training
stack (``models``, ``runtime``, ``launch``, ``optim``, ``ckpt``); and the
hand-written CUDA kernels that decode uint8 batches, run prefill attention
and the SSD scan on the card (``kernels``).  Entry points run on
``torch.device("cuda")`` unless the caller passes ``device="cpu"``.
"""
