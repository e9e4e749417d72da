"""``kernel_roofline.predict``: the hand-written kernels' share of their
roofline in predict, in %."""

from benchmark.yardstick import readers


def read(traced):
    return readers.kernel_roofline(traced)
