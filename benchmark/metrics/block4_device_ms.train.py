"""``block4_device_ms.train``: device milliseconds a step of the kernels
launched inside the program's ``cap2det/model/resnet/block4`` spans
(ResNet-101's block4's forward in the second stage: 3 units over
every ROI map), matched to them through the
launch's correlation id as ``backbone_device_ms.predict`` matches its
own. The backward's kernels, which autograd's thread launches, are not
in it. No other span's name starts with this one, so the match is by the
exact name. None where the program has no such span or it launched
nothing."""

from benchmark.yardstick import readers

SPAN = "cap2det/model/resnet/block4"


def read(traced):
    return readers.launched_ms_per_unit(traced, SPAN)
