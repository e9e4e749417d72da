"""Plain InceptionV2 with the Faster-RCNN split: the reference's backbone
of the configurations whose ``feature_extractor`` is
``faster_rcnn_inception_v2``, found by ``cap2det.backbone``.

The first stage is the stem and Mixed_3b-Mixed_4e (stride 16, 576
channels); the second stage is Mixed_5a-Mixed_5c over the ROI maps
(1024 channels). The separable stem is composed into one dense
convolution before its BatchNorm is folded; the first stage's SAME pools
are dense ``F.max_pool2d``/``F.avg_pool2d`` calls, the second stage's are
shifted slices whose max-pool backward routes each window's gradient to
its first maximal tap.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cap2det as common

FEATURE_DIM = 1024
FIRST_STAGE_DEPTH = 576
NET = "InceptionV2"

# Inception blocks: per branch a list of (name, kernel, cout, stride); a
# pool is ("pool_avg" | "pool_max", kernel, None, stride).
BLOCKS_FIRST = {
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
BLOCKS_SECOND = {
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


# ---------------------------------------------------------------------------
# The weights
# ---------------------------------------------------------------------------


def _block_spec(prefix, spec, cin):
    leaves, empty, total = [], [], 0
    for b, branch in enumerate(spec):
        c = cin
        convs = [layer for layer in branch if not layer[0].startswith("pool")]
        if not convs:
            empty.append(prefix + ("Branch_%d" % b,))
        for name, k, cout, _ in convs:
            path = prefix + ("Branch_%d" % b, name)
            leaves += common.conv_leaves(path, cout, c, k)
            c = cout
        total += c
    return leaves, empty, total


def param_spec():
    """Both stages' leaves and empty pool-only branches, as
    ``cap2det.param_spec`` lists them: the stem's, then each block's."""
    first = (common.FIRST_SCOPE, NET)
    leaves = [
        (first + ("Conv2d_1a_7x7", "depthwise_weights"), (3, 8, 7, 7),
         (2.0 / 49) ** 0.5),
        (first + ("Conv2d_1a_7x7", "pointwise_weights"), (64, 24, 1, 1),
         (2.0 / 24) ** 0.5),
    ] + common.bn_leaves(first + ("Conv2d_1a_7x7",), 64)
    for name, k, cin, cout in [("Conv2d_2b_1x1", 1, 64, 64),
                               ("Conv2d_2c_3x3", 3, 64, 192)]:
        leaves += common.conv_leaves(first + (name,), cout, cin, k)
    empty = []
    cin = 192
    for scope, blocks in ((common.FIRST_SCOPE, BLOCKS_FIRST),
                          (common.SECOND_SCOPE, BLOCKS_SECOND)):
        for name, spec in blocks.items():
            block, holes, cin = _block_spec((scope, NET, name), spec, cin)
            leaves += block
            empty += holes
    return leaves, empty


def dense_weights(node):
    """The separable stem composed into one dense kernel; None for a node
    that is no separable convolution."""
    if "depthwise_weights" not in node:
        return None
    dw = node["depthwise_weights"]  # [cin, mult, kh, kw]
    pw = node["pointwise_weights"]  # [cout, cin*mult, 1, 1]
    cin, mult = dw.shape[:2]
    return torch.einsum("cmuv,ocm->ocuv", dw, pw.reshape(-1, cin, mult))


def preprocess(images):
    """uint8 pixels to [-1, 1]."""
    return (2.0 / 255.0) * images.float() - 1.0


# ---------------------------------------------------------------------------
# SAME pools: dense in the first stage, shifted slices in the second
# ---------------------------------------------------------------------------


def _pool_dense(x, kind, kernel, stride):
    _, pt, pb = common.same_pads(x.shape[2], kernel, stride)
    _, pl, pr = common.same_pads(x.shape[3], kernel, stride)
    if kind == "pool_max":
        x = F.pad(x, (pl, pr, pt, pb), value=-float("inf"))
        return F.max_pool2d(x, kernel, stride)
    return F.avg_pool2d(x, kernel, stride, padding=(pt, pl),
                        count_include_pad=False)


def _geometry(h, w, kernel, stride):
    out_h, pad_t, pad_b = common.same_pads(h, kernel, stride)
    out_w, pad_l, pad_r = common.same_pads(w, kernel, stride)
    return out_h, out_w, (0, 0, pad_l, pad_r, pad_t, pad_b)


def _taps(kernel, stride, out_h, out_w):
    return [(slice(None), slice(i, i + (out_h - 1) * stride + 1, stride),
             slice(j, j + (out_w - 1) * stride + 1, stride))
            for i in range(kernel) for j in range(kernel)]


def _counts(h, w, kernel, stride, device):
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    ones = F.pad(torch.ones((1, h, w, 1), device=device), pads)
    return sum(ones[t] for t in _taps(kernel, stride, out_h, out_w))


def pool_same(x, kind, kernel, stride):
    """SAME pool of NHWC x: -inf (max) or zero (avg) padding, shifted
    strided slices; the average divides by the in-bounds taps."""
    _, h, w, _ = x.shape
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    taps = _taps(kernel, stride, out_h, out_w)
    if kind == "pool_max":
        xp = F.pad(x, pads, value=-float("inf"))
        acc = xp[taps[0]]
        for t in taps[1:]:
            acc = torch.maximum(acc, xp[t])
        return acc
    xp = F.pad(x.float(), pads)
    acc = sum(xp[t] for t in taps)
    return (acc / _counts(h, w, kernel, stride, x.device)).to(x.dtype)


def maxpool_grad(x, g, kernel, stride):
    """Each window's gradient to its first maximal tap (row-major),
    summed tap by tap in float32."""
    _, h, w, _ = x.shape
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    taps = _taps(kernel, stride, out_h, out_w)
    xp = F.pad(x.float(), pads, value=-float("inf"))
    views = [xp[t] for t in taps]
    best = views[0]
    for v in views[1:]:
        best = torch.maximum(best, v)
    gf = g.float()
    taken = torch.zeros(best.shape, dtype=torch.bool, device=x.device)
    acc = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    for t, view in zip(taps, views):
        hit = (view >= best) & ~taken
        taken |= hit
        acc[t] += gf * hit
    _, _, pad_l, _, pad_t, _ = pads
    return acc[:, pad_t:pad_t + h, pad_l:pad_l + w].to(x.dtype)


def avgpool_grad(x_shape, dtype, g, kernel, stride):
    n, h, w, c = x_shape
    out_h, out_w, pads = _geometry(h, w, kernel, stride)
    gt = g.float() / _counts(h, w, kernel, stride, g.device)
    _, _, pad_l, pad_r, pad_t, pad_b = pads
    acc = torch.zeros((n, h + pad_t + pad_b, w + pad_l + pad_r, c),
                      dtype=torch.float32, device=g.device)
    for t in _taps(kernel, stride, out_h, out_w):
        acc[t] += gt
    return acc[:, pad_t:pad_t + h, pad_l:pad_l + w].to(dtype)


class _PoolSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind, kernel, stride):
        ctx.conf = (kind, kernel, stride)
        ctx.x_shape, ctx.x_dtype = tuple(x.shape), x.dtype
        if kind == "pool_max":
            ctx.save_for_backward(x)
        return pool_same(x, kind, kernel, stride)

    @staticmethod
    def backward(ctx, g):
        kind, kernel, stride = ctx.conf
        g = g.contiguous()
        if kind == "pool_max":
            (x,) = ctx.saved_tensors
            return maxpool_grad(x, g, kernel, stride), None, None, None
        return (avgpool_grad(ctx.x_shape, ctx.x_dtype, g, kernel, stride),
                None, None, None)


def _pool_roi(x, kind, kernel, stride):
    nhwc = _PoolSame.apply(x.permute(0, 2, 3, 1).contiguous(), kind, kernel,
                           stride)
    return nhwc.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------


def _block(params, spec, x, pool_fn):
    outputs = []
    for b, branch in enumerate(spec):
        bp = params["Branch_%d" % b]
        h = x
        for name, k, _, stride in branch:
            if name.startswith("pool_"):
                h = pool_fn(h, name, k, stride)
            else:
                h = common.conv_relu(bp[name], h, stride)
        outputs.append(h)
    return torch.cat(outputs, dim=1)


def first_stage(folded, images):
    """Preprocessed [B, H, W, 3] -> Mixed_4e [B, H/16, W/16, 576] NHWC."""
    p = folded[NET]
    x = images.contiguous().permute(0, 3, 1, 2)
    x = common.conv_relu(p["Conv2d_1a_7x7"], x, 2)
    x = _pool_dense(x, "pool_max", 3, 2)
    x = common.conv_relu(p["Conv2d_2b_1x1"], x, 1)
    x = common.conv_relu(p["Conv2d_2c_3x3"], x, 1)
    x = _pool_dense(x, "pool_max", 3, 2)
    for name, spec in BLOCKS_FIRST.items():
        x = _block(p[name], spec, x, _pool_dense)
    return x.permute(0, 2, 3, 1).contiguous()


def second_stage(folded, rois):
    """ROI maps [N, S, S, 576] -> Mixed_5c [N, S', S', 1024] NHWC."""
    p = folded[NET]
    x = rois.contiguous().permute(0, 3, 1, 2)
    for name, spec in BLOCKS_SECOND.items():
        x = _block(p[name], spec, x, _pool_roi)
    return x.permute(0, 2, 3, 1).contiguous()
