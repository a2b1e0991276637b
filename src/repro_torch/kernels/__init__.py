"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the ``ops`` entry points that dispatch on the tensor's device."""
