"""Masked reductions over padded axes (port of ``cap2det_tpu/ops/masked.py``).

Masked softmax subtracts a large constant from masked slots rather than
substituting -inf, as the reference does, so fully-masked rows stay
finite.
"""

from __future__ import annotations

import torch

BIG_NUMBER = 1e10


def sequence_mask(lengths, maxlen, dtype=torch.float32):
    """[..., maxlen] mask with 1 where index < length."""
    rng = torch.arange(maxlen, device=lengths.device)
    return (rng < lengths[..., None]).to(dtype)


def masked_sum(data, mask, dim=1, keepdim=True):
    return torch.sum(data * mask, dim=dim, keepdim=keepdim)


def masked_softmax(data, mask, dim=-1):
    """Softmax over the masked slots (masked slots get ~0 probability)."""
    return torch.softmax(data - BIG_NUMBER * (1.0 - mask), dim=dim)
