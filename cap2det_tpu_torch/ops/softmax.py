"""A float32 softmax with the same bits on the card and on the CPU.

``torch.softmax`` computes exp with each device's own routine (the card's
``expf`` and the CPU's vectorised one differ in the last bit for about a
third of the values) and sums in each device's order. The postprocess
ranks detections by these scores, so a CUDA model and a CPU model given
the same scores would return different detection scores. Here every step
is an IEEE-rounded basic operation (+, -, *, /, max, round, a float64 to
float32 conversion) or exact integer arithmetic, in a fixed order, in
float64, so both devices compute the same float64 values and round them
to the same float32 result, within an ulp of the exact softmax.
"""

from __future__ import annotations

import torch

# exp(x) = 2^k * exp(r), x = k ln2 + r, |r| <= ln2 / 2 (fdlibm's split of
# ln2: k * _LN2_HI is exact for the k used here).
_INV_LN2 = 1.44269504088896338700e+00
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
# Taylor coefficients 1/n!, n = 13 .. 0: the remainder at |r| = ln2/2 is
# below 1e-17 of exp(r).
_TAYLOR = [1.0]
for _n in range(1, 14):
    _TAYLOR.append(_TAYLOR[-1] / _n)
_TAYLOR.reverse()
# Below this, exp(x) / sum (sum >= 1) rounds to float32 zero.
_MIN_EXPONENT = -110.0


def exp_nonpositive(x):
    """exp of a float64 tensor with values in [-110, 0], by basic
    operations only."""
    k = torch.round(x * _INV_LN2)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(r, _TAYLOR[0])
    for c in _TAYLOR[1:]:
        p = p * r + c
    two_k = ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    return p * two_k


def softmax(logits, dim=-1):
    """float32 softmax of `logits` along `dim`: the same bits on every
    device."""
    x = logits.to(torch.float64).movedim(dim, -1)
    x = (x - x.max(dim=-1, keepdim=True).values).clamp_min(_MIN_EXPONENT)
    e = exp_nonpositive(x)
    total = e[..., 0]
    for c in range(1, e.shape[-1]):  # one order on every device
        total = total + e[..., c]
    return (e / total[..., None]).to(torch.float32).movedim(-1, dim)
