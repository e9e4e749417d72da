"""``device_idle_share.predict``: the card's idle share of an image, in %: 1
- traced device ms an image / untraced window ms an image."""

from benchmark.yardstick import readers


def read(traced):
    return readers.idle_share(traced)
