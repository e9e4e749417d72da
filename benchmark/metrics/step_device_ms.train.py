"""``step_device_ms.train``: device milliseconds a step: the union of the
card's kernel, copy and set intervals over the traced steps."""

from benchmark.yardstick import readers


def read(traced):
    return readers.device_ms_per_unit(traced)
