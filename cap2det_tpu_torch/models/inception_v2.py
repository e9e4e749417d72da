"""InceptionV2 (BN-Inception) backbone with the Faster-RCNN two-stage split
(port of ``cap2det_tpu/models/inception_v2.py``, inference).

The first stage runs the stem and Mixed_3b..Mixed_4e (stride 16, 576
channels) over the full image; the second stage runs Mixed_5a..Mixed_5c
(1024 channels) over the cropped ROI features. The params tree has the
TF-slim nesting of the JAX package with PyTorch-layout leaves
(``params.py``).

Public functions take and return NHWC, as the JAX package does. Inside, a
contiguous NHWC tensor is viewed as a ``channels_last`` NCHW tensor (no
copy) for cuDNN. What the port reproduces, and how:

- TF SAME padding, asymmetric for stride 2 on even extents: explicit
  ``F.pad`` (zeros for convs, -inf for max-pools) where the two sides
  differ.
- Frozen BN folded into the conv (eps 1e-3), then bias and ReLU. The
  fold, the cast to the compute dtype and the separable 7x7 stem's
  composition into one dense conv (cin = 3) happen once, in ``prepare``.
- Avg-pool divides by the count of in-bounds taps.
- Second-stage pools go through the SAME pool kernel
  (``kernels/pool_grad.pool_fwd``) at every N; the first stage's large-map
  pools stay plain torch.

The TPU layout choices of the JAX package (merged 1x1 branches, lane
padding to 128, the space-to-depth stem) are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cap2det_tpu_torch.kernels import pool_grad
from cap2det_tpu_torch.params import truncated_normal

BN_EPSILON = 0.001

# Inception block specs: per branch a list of (name, kernel, cout, stride);
# pool branches are ('pool_avg'|'pool_max', kernel, None, stride).
_BLOCKS_FIRST = {
    "Mixed_3b": [
        [("Conv2d_0a_1x1", 1, 64, 1)],
        [("Conv2d_0a_1x1", 1, 64, 1), ("Conv2d_0b_3x3", 3, 64, 1)],
        [("Conv2d_0a_1x1", 1, 64, 1), ("Conv2d_0b_3x3", 3, 96, 1),
         ("Conv2d_0c_3x3", 3, 96, 1)],
        [("pool_avg", 3, None, 1), ("Conv2d_0b_1x1", 1, 32, 1)],
    ],
    "Mixed_3c": [
        [("Conv2d_0a_1x1", 1, 64, 1)],
        [("Conv2d_0a_1x1", 1, 64, 1), ("Conv2d_0b_3x3", 3, 96, 1)],
        [("Conv2d_0a_1x1", 1, 64, 1), ("Conv2d_0b_3x3", 3, 96, 1),
         ("Conv2d_0c_3x3", 3, 96, 1)],
        [("pool_avg", 3, None, 1), ("Conv2d_0b_1x1", 1, 64, 1)],
    ],
    "Mixed_4a": [
        [("Conv2d_0a_1x1", 1, 128, 1), ("Conv2d_1a_3x3", 3, 160, 2)],
        [("Conv2d_0a_1x1", 1, 64, 1), ("Conv2d_0b_3x3", 3, 96, 1),
         ("Conv2d_1a_3x3", 3, 96, 2)],
        [("pool_max", 3, None, 2)],
    ],
    "Mixed_4b": [
        [("Conv2d_0a_1x1", 1, 224, 1)],
        [("Conv2d_0a_1x1", 1, 64, 1), ("Conv2d_0b_3x3", 3, 96, 1)],
        [("Conv2d_0a_1x1", 1, 96, 1), ("Conv2d_0b_3x3", 3, 128, 1),
         ("Conv2d_0c_3x3", 3, 128, 1)],
        [("pool_avg", 3, None, 1), ("Conv2d_0b_1x1", 1, 128, 1)],
    ],
    "Mixed_4c": [
        [("Conv2d_0a_1x1", 1, 192, 1)],
        [("Conv2d_0a_1x1", 1, 96, 1), ("Conv2d_0b_3x3", 3, 128, 1)],
        [("Conv2d_0a_1x1", 1, 96, 1), ("Conv2d_0b_3x3", 3, 128, 1),
         ("Conv2d_0c_3x3", 3, 128, 1)],
        [("pool_avg", 3, None, 1), ("Conv2d_0b_1x1", 1, 128, 1)],
    ],
    "Mixed_4d": [
        [("Conv2d_0a_1x1", 1, 160, 1)],
        [("Conv2d_0a_1x1", 1, 128, 1), ("Conv2d_0b_3x3", 3, 160, 1)],
        [("Conv2d_0a_1x1", 1, 128, 1), ("Conv2d_0b_3x3", 3, 160, 1),
         ("Conv2d_0c_3x3", 3, 160, 1)],
        [("pool_avg", 3, None, 1), ("Conv2d_0b_1x1", 1, 96, 1)],
    ],
    "Mixed_4e": [
        [("Conv2d_0a_1x1", 1, 96, 1)],
        [("Conv2d_0a_1x1", 1, 128, 1), ("Conv2d_0b_3x3", 3, 192, 1)],
        [("Conv2d_0a_1x1", 1, 160, 1), ("Conv2d_0b_3x3", 3, 192, 1),
         ("Conv2d_0c_3x3", 3, 192, 1)],
        [("pool_avg", 3, None, 1), ("Conv2d_0b_1x1", 1, 96, 1)],
    ],
}

_BLOCKS_SECOND = {
    "Mixed_5a": [
        [("Conv2d_0a_1x1", 1, 128, 1), ("Conv2d_1a_3x3", 3, 192, 2)],
        [("Conv2d_0a_1x1", 1, 192, 1), ("Conv2d_0b_3x3", 3, 256, 1),
         ("Conv2d_1a_3x3", 3, 256, 2)],
        [("pool_max", 3, None, 2)],
    ],
    "Mixed_5b": [
        [("Conv2d_0a_1x1", 1, 352, 1)],
        [("Conv2d_0a_1x1", 1, 192, 1), ("Conv2d_0b_3x3", 3, 320, 1)],
        [("Conv2d_0a_1x1", 1, 160, 1), ("Conv2d_0b_3x3", 3, 224, 1),
         ("Conv2d_0c_3x3", 3, 224, 1)],
        [("pool_avg", 3, None, 1), ("Conv2d_0b_1x1", 1, 128, 1)],
    ],
    "Mixed_5c": [
        [("Conv2d_0a_1x1", 1, 352, 1)],
        [("Conv2d_0a_1x1", 1, 192, 1), ("Conv2d_0b_3x3", 3, 320, 1)],
        [("Conv2d_0a_1x1", 1, 192, 1), ("Conv2d_0b_3x3", 3, 224, 1),
         ("Conv2d_0c_3x3", 3, 224, 1)],
        [("pool_max", 3, None, 1), ("Conv2d_0b_1x1", 1, 128, 1)],
    ],
}

FIRST_BLOCKS = ["Mixed_3b", "Mixed_3c", "Mixed_4a", "Mixed_4b", "Mixed_4c",
                "Mixed_4d", "Mixed_4e"]
SECOND_BLOCKS = ["Mixed_5a", "Mixed_5b", "Mixed_5c"]
FIRST_STAGE_DEPTH = 576  # Mixed_4e output channels
SECOND_STAGE_DEPTH = 1024  # Mixed_5c output channels


# ---------------------------------------------------------------------------
# Parameters in the JAX layout, made with numpy from a seed
# ---------------------------------------------------------------------------


def _bn_numpy(cout):
    return {
        "beta": np.zeros((cout,), np.float32),
        "moving_mean": np.zeros((cout,), np.float32),
        "moving_variance": np.ones((cout,), np.float32),
    }


def _he_normal(rng, shape, fan_in):
    return truncated_normal(rng, shape, (2.0 / fan_in) ** 0.5)


def _block_params_numpy(rng, spec, cin):
    out = {}
    total = 0
    for b, branch in enumerate(spec):
        branch_params = {}
        c = cin
        for name, k, cout, _ in branch:
            if name.startswith("pool_"):
                continue
            branch_params[name] = {
                "weights": _he_normal(rng, (k, k, c, cout), k * k * c),
                "BatchNorm": _bn_numpy(cout),
            }
            c = cout
        out["Branch_%d" % b] = branch_params
        total += c
    return out, total


def init_first_stage_params_numpy(rng):
    """JAX-layout numpy tree of the stem + Mixed_3b..Mixed_4e, with the
    names and shapes of the JAX ``init_first_stage_params``.

    Conv weights are truncated normals of stddev sqrt(2 / fan_in) per
    layer, which keeps activations near unit scale through the full depth.
    """
    p = {
        "Conv2d_1a_7x7": {
            "depthwise_weights": _he_normal(rng, (7, 7, 3, 8), 7 * 7),
            "pointwise_weights": _he_normal(rng, (1, 1, 24, 64), 24),
            "BatchNorm": _bn_numpy(64),
        }
    }
    for name, k, cin, cout in [("Conv2d_2b_1x1", 1, 64, 64),
                               ("Conv2d_2c_3x3", 3, 64, 192)]:
        p[name] = {
            "weights": _he_normal(rng, (k, k, cin, cout), k * k * cin),
            "BatchNorm": _bn_numpy(cout),
        }
    cin = 192
    for name in FIRST_BLOCKS:
        p[name], cin = _block_params_numpy(rng, _BLOCKS_FIRST[name], cin)
    return {"InceptionV2": p}


def init_second_stage_params_numpy(rng):
    """JAX-layout numpy tree of Mixed_5a..Mixed_5c."""
    p = {}
    cin = FIRST_STAGE_DEPTH
    for name in SECOND_BLOCKS:
        p[name], cin = _block_params_numpy(rng, _BLOCKS_SECOND[name], cin)
    return {"InceptionV2": p}


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def preprocess(images):
    """Maps [0,255] pixels to [-1,1] (faster_rcnn inception preprocess)."""
    return (2.0 / 255.0) * images - 1.0


def _fold_bn(w, bn, compute_dtype):
    """Frozen-statistics BN folded into an OIHW conv: {weight, bias} with
    conv(x, weight) + bias == BN(conv(x, w)), cast to compute_dtype, the
    weight in channels_last."""
    inv = torch.rsqrt(bn["moving_variance"] + BN_EPSILON)
    w = (w * inv[:, None, None, None]).to(compute_dtype)
    return {
        "weight": w.contiguous(memory_format=torch.channels_last),
        "bias": (bn["beta"] - bn["moving_mean"] * inv).to(compute_dtype),
    }


def _compose_separable(params):
    """The separable stem conv as one dense OIHW conv (exact since the
    pointwise conv is 1x1): W[o,c,u,v] = sum_m dw[c,m,u,v] pw[o,c*mult+m]."""
    dw = params["depthwise_weights"]  # [cin, mult, kh, kw]
    pw = params["pointwise_weights"]  # [cout, cin*mult, 1, 1]
    cin, mult = dw.shape[:2]
    if cin > 8:
        raise ValueError("only the composed stem form (cin <= 8) is ported")
    return torch.einsum("cmuv,ocm->ocuv", dw, pw.reshape(-1, cin, mult))


def prepare(params, compute_dtype=torch.bfloat16):
    """A stage's params tree -> the tree ``first_stage``/``second_stage``
    read, made once per set of params: every conv's frozen BN folded into
    its weights and bias in compute_dtype (the separable stem composed into
    one dense conv first), so a forward pass launches no weight
    arithmetic."""
    out = {}
    for key, value in params.items():
        if "depthwise_weights" in value:
            out[key] = _fold_bn(_compose_separable(value),
                                value["BatchNorm"], compute_dtype)
        elif "weights" in value:
            out[key] = _fold_bn(value["weights"], value["BatchNorm"],
                                compute_dtype)
        else:
            out[key] = prepare(value, compute_dtype)
    return out


def _conv_relu(conv, x, stride):
    """ReLU(SAME conv + bias) of an NCHW (channels_last) activation, in the
    prepared weights' dtype."""
    w = conv["weight"]
    k = w.shape[-1]
    _, pt, pb = pool_grad.same_pads(x.shape[2], k, stride)
    _, pl, pr = pool_grad.same_pads(x.shape[3], k, stride)
    padding = (pt, pl)
    if pt != pb or pl != pr:
        x = F.pad(x, (pl, pr, pt, pb))
        padding = 0
    out = F.conv2d(x.to(w.dtype), w, conv["bias"], stride=stride,
                   padding=padding)
    return torch.relu_(out)


def pool_dense(x, kind, kernel, stride):
    """SAME pool of a large NCHW map (the first stage): the explicit
    -inf-padded max-pool, or the in-bounds-count avg-pool. Every avg pool
    of the network is 3x3/s1, whose SAME padding is symmetric."""
    _, pt, pb = pool_grad.same_pads(x.shape[2], kernel, stride)
    _, pl, pr = pool_grad.same_pads(x.shape[3], kernel, stride)
    if kind == "pool_max":
        x = F.pad(x, (pl, pr, pt, pb), value=-float("inf"))
        return F.max_pool2d(x, kernel, stride)
    if pt != pb or pl != pr:
        raise ValueError("asymmetric SAME avg-pool padding (kernel %d, "
                         "stride %d) is not supported" % (kernel, stride))
    return F.avg_pool2d(x, kernel, stride, padding=(pt, pl),
                        count_include_pad=False)


def pool_roi(x, kind, kernel, stride):
    """SAME pool of the second stage's small ROI maps through the pool
    kernel (NHWC memory, so the permutes are views)."""
    nhwc = pool_grad.pool_fwd(x.permute(0, 2, 3, 1).contiguous(), kind,
                              kernel, stride)
    return nhwc.permute(0, 3, 1, 2)


def _block(params, spec, x, pool_fn):
    outputs = []
    for b, branch in enumerate(spec):
        bp = params["Branch_%d" % b]
        h = x
        for name, k, _, stride in branch:
            if name.startswith("pool_"):
                h = pool_fn(h, name, k, stride)
            else:
                h = _conv_relu(bp[name], h, stride)
        outputs.append(h)
    return torch.cat(outputs, dim=1)


def _to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def first_stage(prepared, images):
    """Preprocessed image [B, H, W, 3] -> Mixed_4e features
    [B, H/16, W/16, 576] (NHWC, contiguous) in the dtype of the weights
    that ``prepare`` made."""
    p = prepared["InceptionV2"]
    x = _to_nchw(images.contiguous())
    x = _conv_relu(p["Conv2d_1a_7x7"], x, 2)
    x = pool_dense(x, "pool_max", 3, 2)
    x = _conv_relu(p["Conv2d_2b_1x1"], x, 1)
    x = _conv_relu(p["Conv2d_2c_3x3"], x, 1)
    x = pool_dense(x, "pool_max", 3, 2)
    for name in FIRST_BLOCKS:
        x = _block(p[name], _BLOCKS_FIRST[name], x, pool_dense)
    return _to_nhwc(x)


def second_stage(prepared, rois):
    """ROI features [N, S, S, 576] -> Mixed_5c features [N, S', S', 1024]
    (NHWC, contiguous) in the dtype of the weights that ``prepare`` made."""
    p = prepared["InceptionV2"]
    x = _to_nchw(rois.contiguous())
    for name in SECOND_BLOCKS:
        x = _block(p[name], _BLOCKS_SECOND[name], x, pool_roi)
    return _to_nhwc(x)
