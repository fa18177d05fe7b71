"""Kernels of the port: hand-written CUDA for Hopper (attention and
ChaCha20), their plain PyTorch versions, the build, the custom ops
(``library``) and the dispatchers (``ops``)."""
