"""ResNet-101 v1 backbone with the Faster-RCNN split: the TF Object
Detection API's ``faster_rcnn_resnet101`` feature extractor
(``faster_rcnn_resnet_v1_feature_extractor.py`` over TF-slim
``nets/resnet_v1.py`` and ``resnet_utils.py``; He et al.,
arXiv:1512.03385), which Cap2Det builds through the OD API's factory. The
JAX package has no counterpart.

The first stage runs the root and block1-block3 at output stride 16
(1024 channels) over the full image; the second stage runs block4 (2048
channels) over the cropped ROI maps. The params tree has TF-slim's names
(``resnet_v1_101/block3/unit_7/bottleneck_v1/conv2/weights``,
``.../BatchNorm/gamma``) with PyTorch-layout leaves (``params.py``).

Public functions take and return NHWC, as ``inception_v2`` does; inside,
a contiguous NHWC tensor is viewed as a ``channels_last`` NCHW tensor (no
copy) for cuDNN. Activations stay in the prepared weights' dtype. What
the port reproduces, and how:

- ``conv2d_same``: explicit symmetric padding of (k-1)//2 and the rest,
  then VALID; every kernel here is odd (1, 3, 7), so both sides are equal
  and the convolution takes it as its own padding. It is not TF SAME,
  which pads less before on an even input at stride 2.
- ``pool1``: a 3x3/2 TF SAME max-pool (``pool_grad.pool_dense``).
- Bottleneck v1: conv1 1x1 + ReLU, conv2 3x3 with the unit's stride +
  ReLU, conv3 1x1; the shortcut a subsample (``x[:, :, ::s, ::s]``, a 1x1
  max-pool) where the depth is the input's, else a 1x1 convolution with
  the stride; ReLU(shortcut + residual). A block's stride sits on its
  last unit; output stride 16 turns block3's into 1, so its last
  shortcut is the identity.
- Frozen BatchNorm with epsilon 1e-5 and a scale ``gamma`` on every
  convolution (the OD API's ``resnet_arg_scope``), folded into the
  convolutions with the rest of both stages in one ``kernels/bn_fold``
  call with ``BN_EPSILON`` (``frcnn.prepare``): one launch on the card,
  differentiable in ``weights``, ``beta`` and ``gamma`` (one more launch
  in the backward).
- ``second_stage(remat=True)`` recomputes each unit of block4 in the
  backward, keeping only its input.
- At TF's initial values (gamma ones, ``init_*_params_numpy``) with
  frozen statistics the activations grow through block3's 23 units
  until the loss overflows in the second step; training starts from a
  converted checkpoint (``frcnn.load_pretrained``), whose statistics
  keep them in range.

Each block runs inside a ``cap2det/model/resnet/<block>`` span, within
the stage's span.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from cap2det_tpu_torch.kernels import pool_grad
from cap2det_tpu_torch.params import truncated_normal
from cap2det_tpu_torch.utils.spans import span

NET = "resnet_v1_101"
BN_EPSILON = 1e-5
MEANS = (123.68, 116.779, 103.939)

# (block, units, depth, bottleneck depth, stride of its last unit at
# output stride 16).
FIRST_BLOCKS = (("block1", 3, 256, 64, 2), ("block2", 4, 512, 128, 2),
                ("block3", 23, 1024, 256, 1))
SECOND_BLOCKS = (("block4", 3, 2048, 512, 1),)
STRIDES = {name: stride for name, _, _, _, stride in
           FIRST_BLOCKS + SECOND_BLOCKS}
FIRST_STAGE_DEPTH = 1024  # block3's output channels
SECOND_STAGE_DEPTH = 2048  # block4's
FEATURE_DIM = SECOND_STAGE_DEPTH  # the pooled proposal features' width


# ---------------------------------------------------------------------------
# Parameters in the JAX layout, made with numpy from a seed
# ---------------------------------------------------------------------------


def _conv_numpy(rng, k, cin, cout):
    """A k x k convolution's He-scaled HWIO weights and its BatchNorm at
    TF's initial values (gamma ones)."""
    return {
        "weights": truncated_normal(rng, (k, k, cin, cout),
                                    (2.0 / (k * k * cin)) ** 0.5),
        "BatchNorm": {
            "beta": np.zeros((cout,), np.float32),
            "gamma": np.ones((cout,), np.float32),
            "moving_mean": np.zeros((cout,), np.float32),
            "moving_variance": np.ones((cout,), np.float32),
        },
    }


def _blocks_numpy(rng, blocks, cin):
    out = {}
    for name, units, depth, bottleneck, _ in blocks:
        block = {}
        for u in range(1, units + 1):
            unit = {}
            if depth != cin:
                unit["shortcut"] = _conv_numpy(rng, 1, cin, depth)
            unit["conv1"] = _conv_numpy(rng, 1, cin, bottleneck)
            unit["conv2"] = _conv_numpy(rng, 3, bottleneck, bottleneck)
            unit["conv3"] = _conv_numpy(rng, 1, bottleneck, depth)
            block["unit_%d" % u] = {"bottleneck_v1": unit}
            cin = depth
        out[name] = block
    return out, cin


def init_first_stage_params_numpy(rng, blocks=FIRST_BLOCKS):
    """JAX-layout numpy tree of the root and `blocks` (resnet_v1_101's
    block1-block3 by default; a test passes shallower rows)."""
    p, _ = _blocks_numpy(rng, blocks, 64)
    return {NET: {"conv1": _conv_numpy(rng, 7, 3, 64), **p}}


def init_second_stage_params_numpy(rng, blocks=SECOND_BLOCKS,
                                   cin=FIRST_STAGE_DEPTH):
    """JAX-layout numpy tree of block4 (or `blocks`) over `cin` channels."""
    p, _ = _blocks_numpy(rng, blocks, cin)
    return {NET: p}


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def preprocess(images):
    """RGB pixels minus the channel means (the OD API's ResNet
    preprocess)."""
    return images - torch.tensor(MEANS, dtype=images.dtype,
                                 device=images.device)


def _conv(conv, x, stride=1, relu=True):
    """A prepared convolution of an NCHW (channels_last) activation with
    ``conv2d_same``'s padding, symmetric for the odd kernels here; ReLU'd
    unless `relu` is False."""
    w = conv["weight"]
    out = F.conv2d(x.to(w.dtype), w, conv["bias"], stride=stride,
                   padding=(w.shape[-1] - 1) // 2)
    return torch.relu_(out) if relu else out


def _unit(p, x, stride):
    """One bottleneck v1 unit."""
    if "shortcut" in p:
        shortcut = _conv(p["shortcut"], x, stride, relu=False)
    else:
        shortcut = x[:, :, ::stride, ::stride]
    residual = _conv(p["conv1"], x)
    residual = _conv(p["conv2"], residual, stride)
    residual = _conv(p["conv3"], residual, relu=False)
    return torch.relu_(shortcut + residual)


def _block(p, name, x, remat=False):
    """The units of block `name` that the tree holds, in order, the last
    with the block's stride; with `remat`, each under one non-reentrant
    ``torch.utils.checkpoint``."""
    with span("cap2det/model/resnet/" + name):
        units = sorted(p[name], key=lambda unit: int(unit.split("_")[1]))
        for u in units:
            stride = STRIDES[name] if u == units[-1] else 1
            if remat:
                # No unit draws random numbers: the recompute needs no
                # saved RNG state.
                x = torch_checkpoint.checkpoint(
                    _unit, p[name][u]["bottleneck_v1"], x, stride,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x = _unit(p[name][u]["bottleneck_v1"], x, stride)
        return x


def first_stage(prepared, images):
    """Preprocessed image [B, H, W, 3] -> block3 features
    [B, H/16, W/16, 1024] (NHWC, contiguous) in the dtype of the weights
    that ``frcnn.prepare`` made."""
    with span("cap2det/model/first_stage"):
        p = prepared[NET]
        x = images.contiguous().permute(0, 3, 1, 2)
        x = _conv(p["conv1"], x, 2)
        x = pool_grad.pool_dense(x, "pool_max", 3, 2)
        for name, _, _, _, _ in FIRST_BLOCKS:
            x = _block(p, name, x)
        return x.permute(0, 2, 3, 1).contiguous()


def second_stage(prepared, rois, remat=False):
    """ROI features [N, S, S, 1024] -> block4 features [N, S, S, 2048]
    (NHWC, contiguous) in the dtype of the weights that
    ``frcnn.prepare`` made. With `remat`, while autograd records, each
    unit is recomputed in the backward (the same values and gradients);
    under ``torch.no_grad`` the path is the plain one."""
    with span("cap2det/model/second_stage"):
        x = rois.contiguous().permute(0, 3, 1, 2)
        remat = remat and torch.is_grad_enabled()
        for name, _, _, _, _ in SECOND_BLOCKS:
            x = _block(prepared[NET], name, x, remat)
        return x.permute(0, 2, 3, 1).contiguous()
