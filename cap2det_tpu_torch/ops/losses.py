"""Loss primitives with tf.nn's numerics (port of
``cap2det_tpu/ops/losses.py``)."""

from __future__ import annotations

import torch

from cap2det_tpu_torch.train.optimizers import flatten_params


def sigmoid_cross_entropy(labels, logits):
    """tf.nn.sigmoid_cross_entropy_with_logits, in its stable form."""
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_cross_entropy(labels, logits, dim=-1):
    """tf.nn.softmax_cross_entropy_with_logits (labels are distributions)."""
    return -torch.sum(labels * torch.log_softmax(logits, dim=dim), dim=dim)


def l2_regularization(params, scale, predicate=None):
    """slim-style L2: scale * 0.5 * sum(w^2) over the leaves whose path
    ends in 'weights' (or that `predicate(path)` selects), in the order of
    ``flatten_params``."""
    total = 0.0
    for path, leaf in flatten_params(params):
        if predicate is not None:
            if not predicate(path):
                continue
        elif not path.endswith("weights"):
            continue
        total = total + torch.sum(torch.square(leaf))
    return scale * 0.5 * total
