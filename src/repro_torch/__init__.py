"""PyTorch/CUDA port of ``repro``: serving a decoder-only LM through the
specialization engine, with hand-written Hopper kernels for prefill and
decode attention.

The module layout mirrors the JAX package so each counterpart is found
under the same name. The port imports ``torch`` and never ``jax`` nor
anything of ``repro``; the framework-free modules it needs (configs,
scheduler, calibration loader) are its own copies.
"""


def resolve_device(name: str):
    """The ``torch.device`` an entry point's ``--device`` names. CUDA must
    be present when asked for: the port never carries on on the CPU in
    place of the GPU it defaults to."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available. The port runs "
            "on the GPU; pass --device cpu to run on the CPU.")
    return dev
