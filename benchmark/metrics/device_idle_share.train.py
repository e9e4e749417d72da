"""``device_idle_share.train``: the card's idle share of a step, in %: 1 -
traced device ms a step / untraced window ms a step."""

from benchmark.yardstick import readers


def read(traced):
    return readers.idle_share(traced)
