"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref``), the ctypes build/loader (``build``) and the dispatching
wrappers with launch counters (``ops``)."""
