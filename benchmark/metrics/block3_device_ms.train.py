"""``block3_device_ms.train``: device milliseconds a step of the kernels
launched inside the program's ``cap2det/model/resnet/block3`` spans
(ResNet-101's block3's forward in the first stage: 23 units at
stride 16 over the full canvas), matched to them through the
launch's correlation id as ``backbone_device_ms.predict`` matches its
own. The backward's kernels, which autograd's thread launches, are not
in it. No other span's name starts with this one, so the match is by the
exact name. None where the program has no such span or it launched
nothing."""

from benchmark.yardstick import readers

SPAN = "cap2det/model/resnet/block3"


def read(traced):
    return readers.launched_ms_per_unit(traced, SPAN)
