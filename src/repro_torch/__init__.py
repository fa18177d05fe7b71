"""PyTorch/CUDA port of ``repro``: serving a decoder-only LM through the
specialization engine, with hand-written Hopper kernels for prefill and
decode attention.

The module layout mirrors the JAX package so each counterpart is found
under the same name. The port imports ``torch`` and never ``jax`` nor
anything of ``repro``; the framework-free modules it needs (configs,
scheduler, calibration loader) are its own copies.
"""
