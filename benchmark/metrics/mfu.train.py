"""``mfu.train``: the whole step's share of the card's dense bfloat16 peak,
in %, from the reference's FLOP count of each step's bucket."""

from benchmark.yardstick import readers


def read(traced):
    return readers.mfu(traced)
