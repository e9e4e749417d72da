"""``backbone_device_ms.predict``: device milliseconds an image of the
kernels launched inside Cap2DetModel.predictions (backbone, ROI pool, heads)
over the four scales."""

from benchmark import harness
from benchmark.yardstick import readers


def read(traced):
    return readers.launched_ms_per_unit(traced, harness.SPAN_PREDICTIONS)
