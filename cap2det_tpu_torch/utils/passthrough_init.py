"""Synthesized 'passthrough' backbone weights (the port's copy of
``cap2det_tpu/utils/passthrough_init.py``, numpy, in the JAX layout).

No pretrained ImageNet checkpoint is in the repository, so quality
experiments substitute a deterministic backbone that PRESERVES
spatially-local color information end to end: every conv is a center-tap
channel-cycling identity-ish kernel and every BatchNorm is neutral (mean
0, var 1, beta 0). The tree is in the
JAX layout, so it goes to the port through ``checkpoint.save_params`` and
the trainer's ``pretrained_checkpoint`` (``frcnn.load_pretrained``), the
path a converted ImageNet checkpoint would take (reference
models/utils.py:181-186).
"""

from __future__ import annotations

import numpy as np


def _passthrough_conv(shape):
    w = np.zeros(shape, np.float32)
    kh, kw, cin, cout = shape
    for o in range(cout):
        w[kh // 2, kw // 2, o % cin, o] = 1.0
    return w


def _passthrough_depthwise(shape):
    w = np.zeros(shape, np.float32)
    kh, kw, _, _ = shape
    w[kh // 2, kw // 2, :, :] = 1.0
    return w


def make_passthrough(tree):
    """Spatially-local backbone weights: center-tap channel-cycling convs,
    neutral BatchNorm (see module docstring)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        a = np.asarray(v) if not isinstance(v, dict) else None
        if k == "weights":
            out[k] = _passthrough_conv(a.shape)
        elif k == "depthwise_weights":
            out[k] = _passthrough_depthwise(a.shape)
        elif k == "pointwise_weights":
            out[k] = _passthrough_conv(a.shape)
        elif k == "BatchNorm":
            out[k] = {
                "beta": np.zeros_like(np.asarray(v["beta"])),
                "moving_mean": np.zeros_like(np.asarray(v["moving_mean"])),
                "moving_variance": np.ones_like(
                    np.asarray(v["moving_variance"])
                ),
            }
        else:
            out[k] = make_passthrough(v)
    return out
