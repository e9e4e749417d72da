"""``bn_fold_ms.train``: host milliseconds a step inside the spans around
Cap2DetModel.prepare as Cap2DetModel.loss calls it (the BN fold of both
stages)."""

from benchmark import harness
from benchmark.yardstick import readers


def read(traced):
    return readers.host_ms_per_unit(traced, harness.SPAN_PREPARE)
