"""``mfu.predict``: the whole predict's share of the card's dense bfloat16
peak, in %, from the reference's FLOP count of each image's four scales."""

from benchmark.yardstick import readers


def read(traced):
    return readers.mfu(traced)
