"""Attention kernels of the port: hand-written CUDA for Hopper, their plain
PyTorch versions, the build, and the device dispatchers (``ops``)."""
