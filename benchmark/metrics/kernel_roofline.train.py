"""``kernel_roofline.train``: the hand-written kernels' share of their
roofline in the step, in %."""

from benchmark.yardstick import readers


def read(traced):
    return readers.kernel_roofline(traced)
