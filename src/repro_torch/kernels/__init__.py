"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``plain``), and the device-dispatched wrappers (``ops``)."""
