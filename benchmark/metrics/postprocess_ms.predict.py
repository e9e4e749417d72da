"""``postprocess_ms.predict``: host milliseconds an image inside
Cap2DetModel.postprocess (softmax, NMS and merge of every iteration)."""

from benchmark import harness
from benchmark.yardstick import readers


def read(traced):
    return readers.host_ms_per_unit(traced, harness.SPAN_POSTPROCESS)
