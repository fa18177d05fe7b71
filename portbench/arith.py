"""The yardstick's arithmetic: the chip's peaks and the least time of the
two hand-written attention kernels for the shapes of one call.

Peaks are a frozen copy of ``repro_torch/analysis/regions.py``'s
``MachineModel`` (NVIDIA H100 SXM data sheet, dense rates without
sparsity, at its 700 W limit). A kernel's operations and bytes count what
its inputs need: each input byte read once and each output byte written
once, and for causal attention only the query-key pairs at or below the
diagonal (the kernel skips the tiles above it).
"""
from __future__ import annotations

BF16_FLOPS_PER_S = 989e12      # tensor cores, bf16 in, fp32 accumulate
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time of work on the chip's peaks: the larger of its
    operations at the bf16 rate and its bytes at the HBM rate."""
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def flash_attention_cost(B: int, H: int, KVH: int, Sq: int, Skv: int,
                         D: int, Dv: int, causal: bool,
                         elt: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one ``flash_attention`` call: QK^T and PV over
    the pairs the mask keeps (Sq (Sq + 1) / 2 a head where causal, which
    needs Sq == Skv), q, k, v read and o written once, ``elt`` bytes an
    element."""
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Skv
    flops = 2.0 * B * H * pairs * (D + Dv)
    nbytes = elt * (B * H * Sq * D + B * KVH * Skv * (D + Dv)
                    + B * H * Sq * Dv)
    return flops, float(nbytes)


def flash_decode_cost(B: int, H: int, KVH: int, L: int, D: int,
                      elt: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one ``flash_decode`` call over ``L`` valid cache
    positions a row: q.K and p.V for every head, the valid K and V read
    once, q read and o written once, the lengths (int32) read."""
    flops = 4.0 * B * H * L * D
    nbytes = elt * (2 * B * H * D + 2 * B * KVH * L * D) + 4 * B
    return flops, float(nbytes)
