"""Masked reductions over padded axes (port of ``cap2det_tpu/ops/masked.py``).

The semantics are the reference's: the masked max/min/argmax/argmin
shift by the row's extremum and multiply by the mask rather than
substituting -inf, and masked softmax subtracts a large constant from
masked slots, so fully-masked rows stay finite. ``torch.argmax`` and
``jnp.argmax`` both return the first maximal index.
"""

from __future__ import annotations

import torch

BIG_NUMBER = 1e10
SMALL_NUMBER = 1e-10


def sequence_mask(lengths, maxlen, dtype=torch.float32):
    """[..., maxlen] mask with 1 where index < length."""
    rng = torch.arange(maxlen, device=lengths.device)
    return (rng < lengths[..., None]).to(dtype)


def _keep(out, dim, keepdim):
    return out if keepdim else out.squeeze(dim)


def masked_maximum(data, mask, dim=1, keepdim=True):
    """Max over the masked slots; a fully-masked row gives the row minimum."""
    axis_min = data.amin(dim=dim, keepdim=True)
    out = ((data - axis_min) * mask).amax(dim=dim, keepdim=True) + axis_min
    return _keep(out, dim, keepdim)


def masked_minimum(data, mask, dim=1, keepdim=True):
    """Min over the masked slots; a fully-masked row gives the row maximum."""
    axis_max = data.amax(dim=dim, keepdim=True)
    out = ((data - axis_max) * mask).amin(dim=dim, keepdim=True) + axis_max
    return _keep(out, dim, keepdim)


def masked_sum(data, mask, dim=1, keepdim=True):
    return torch.sum(data * mask, dim=dim, keepdim=keepdim)


def masked_avg(data, mask, dim=1, keepdim=True):
    """Mean over the masked slots; the count is floored at SMALL_NUMBER."""
    sums = torch.sum(data * mask, dim=dim, keepdim=True)
    counts = torch.sum(mask, dim=dim, keepdim=True).clamp_min(SMALL_NUMBER)
    return _keep(sums / counts, dim, keepdim)


def masked_sum_nd(data, mask, dim=1, keepdim=True):
    """masked_sum with a mask of one fewer trailing dim than data."""
    return torch.sum(data * mask[..., None], dim=dim, keepdim=keepdim)


def masked_avg_nd(data, mask, dim=1, keepdim=True):
    sums = torch.sum(data * mask[..., None], dim=dim, keepdim=True)
    counts = torch.sum(mask, dim=dim, keepdim=True)[..., None].clamp_min(
        SMALL_NUMBER)
    return _keep(sums / counts, dim, keepdim)


def masked_softmax(data, mask, dim=-1):
    """Softmax over the masked slots (masked slots get ~0 probability)."""
    return torch.softmax(data - BIG_NUMBER * (1.0 - mask), dim=dim)


def masked_argmax(data, mask, dim=1):
    axis_min = data.amin(dim=dim, keepdim=True)
    return torch.argmax((data - axis_min) * mask, dim=dim)


def masked_argmin(data, mask, dim=1):
    axis_max = data.amax(dim=dim, keepdim=True)
    return torch.argmin((data - axis_max) * mask, dim=dim)
