"""Mean host time of one call into the ``flash_decode`` op (the span
``kernels.flash_decode``: dispatch, validation, allocation and launch),
microseconds."""
from portbench import spans


def read(run):
    return spans.mean_us(run, "kernels.flash_decode")
