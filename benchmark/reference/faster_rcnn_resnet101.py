"""Plain ResNet-101 v1 with the Faster-RCNN split: the reference's backbone
of the configurations whose ``feature_extractor`` is
``faster_rcnn_resnet101``, found by ``cap2det.backbone``.

Written from TF-slim ``nets/resnet_v1.py`` and ``resnet_utils.py``, the
TF Object Detection API's ``faster_rcnn_resnet_v1_feature_extractor.py``
and He et al., arXiv:1512.03385:

* preprocess: RGB minus the means [123.68, 116.779, 103.939];
* root: ``conv1`` 7x7/2 x64 by ``conv2d_same`` (explicit symmetric
  padding of (k-1)//2 before and the rest after, then VALID; not TF SAME,
  which pads less before on even inputs), then ``pool1``, a 3x3/2 TF SAME
  max-pool;
* bottleneck v1: ``conv1`` 1x1 to the bottleneck depth, ReLU; ``conv2``
  3x3 with the unit's stride by ``conv2d_same``, ReLU; ``conv3`` 1x1 to
  the depth, no activation; the shortcut a subsample (``x[:, ::s, ::s]``)
  where the depth equals the input's, else a 1x1 convolution with the
  stride and no activation; out ReLU(shortcut + residual). A block's
  stride sits on its last unit;
* first stage (``resnet_v1_101``, output stride 16): block1 (3 units,
  depth 256, bottleneck 64, stride 2), block2 (4, 512, 128, 2), block3
  (23, 1024, 256): the output stride turns block3's last stride into 1,
  so its last shortcut is the identity; 1024 channels;
* second stage: block4, 3 units of depth 2048 and bottleneck 512 at
  stride 1, over the ROI maps; Cap2Det's spatial mean follows, so the
  features are 2048 wide;
* frozen BatchNorm with epsilon 1e-5 and a scale ``gamma`` on every
  convolution (the OD API's ``resnet_arg_scope``).

Activations are NCHW views of channels-last memory inside a stage, NHWC
at its ends. Convolutions run in the folded weights' dtype.

**The BN fold and its limit.** ``cap2det.fold_bn``, which every backbone
shares, folds ``rsqrt(moving_variance + 1e-3)`` (InceptionV2's epsilon)
and no scale. ``dense_weights`` hands it, for each convolution, a kernel
whose product with that factor rounds to ResNet's folded weight
``gamma * rsqrt(v + 1e-5) * weights`` in bfloat16, the configuration's
convolution dtype: ``fold_bn`` then gives that weight bit for bit. Its
gradient is worked out from the one ``fold_bn`` passes back (a bfloat16
gradient times a factor under 1, so exactly recoverable): the weights'
is that gradient times ``gamma * rsqrt(v + 1e-5)``, gamma's the sum of
the gradient times the weights over each output channel (``channel_sum``,
in a fixed order) times ``rsqrt(v + 1e-5)``. The folded bias is
``beta - moving_mean * rsqrt(v + 1e-3)``, which equals ResNet's
``beta - moving_mean * gamma * rsqrt(v + 1e-5)`` only because the seeded
``moving_mean`` is zero. The moving statistics are frozen (no step
changes them), so it stays zero in every state the checks reach; a
nonzero ``moving_mean``, or a fold in another dtype, would need the
shared fold itself to take the scale and the epsilon.

Why the fold rounds as the program does: a plain float32 kernel
``weights * gamma * sqrt((v + 1e-3) / (v + 1e-5))`` through autograd, a
sound reordering, leaves a few hundred bfloat16 weights one step off,
and on an H100 at the cell's size reads 3e-5-4e-5 on the loss gaps but
0.9e-3-1.1e-3 on the gradient and change gaps, and up to 4.9e-3 after
the window: as far as the bfloat16-heads control reads (8.4e-4-1.6e-3),
so no limit on those gaps admits the one and refuses the other.

``gamma`` is drawn from the seed, a normal truncated at two deviations,
so a program that leaves gamma out of its fold fails the first check:
deviation ``GAMMA_STD_ROOT`` for the root (the pixels' spread undone),
``GAMMA_STD_CONV3`` for each unit's ``conv3`` (the last of its residual
branch, which keeps 33 stacked units near unit scale at frozen
statistics) and 1 elsewhere. ``beta``, ``moving_mean`` and
``moving_variance`` are ``cap2det.bn_leaves``' zeros, zeros and ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cap2det as common

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FEATURE_DIM = 2048
FIRST_STAGE_DEPTH = 1024
NET = "resnet_v1_101"
MEANS = (123.68, 116.779, 103.939)
EPSILON = 1e-5
GAMMA_STD = 1.0
GAMMA_STD_ROOT = 0.02
GAMMA_STD_CONV3 = 0.2
LANES = 32  # channel_sum's interleaved partial sums

# (block, units, depth, bottleneck depth, stride of the last unit), the
# stride after the output stride of 16.
FIRST_BLOCKS = (("block1", 3, 256, 64, 2), ("block2", 4, 512, 128, 2),
                ("block3", 23, 1024, 256, 1))
SECOND_BLOCKS = (("block4", 3, 2048, 512, 1),)
STRIDES = {name: stride for name, _, _, _, stride in
           FIRST_BLOCKS + SECOND_BLOCKS}


# ---------------------------------------------------------------------------
# The weights
# ---------------------------------------------------------------------------


def _conv_leaves(prefix, cout, cin, k, gamma_std=GAMMA_STD):
    """A k x k convolution's He-scaled weights and its BatchNorm with a
    seeded scale."""
    return ([(prefix + ("weights",), (cout, cin, k, k),
              (2.0 / (k * k * cin)) ** 0.5),
             (prefix + ("BatchNorm", "gamma"), (cout,), gamma_std)]
            + common.bn_leaves(prefix, cout))


def _block_leaves(prefix, blocks, cin, units=None):
    leaves = []
    for b, (name, n, depth, bottleneck, _) in enumerate(blocks):
        for u in range(1, (n if units is None else units[b]) + 1):
            unit = prefix + (name, "unit_%d" % u, "bottleneck_v1")
            if depth != cin:
                leaves += _conv_leaves(unit + ("shortcut",), depth, cin, 1)
            leaves += _conv_leaves(unit + ("conv1",), bottleneck, cin, 1)
            leaves += _conv_leaves(unit + ("conv2",), bottleneck, bottleneck,
                                   3)
            leaves += _conv_leaves(unit + ("conv3",), depth, bottleneck, 1,
                                   GAMMA_STD_CONV3)
            cin = depth
    return leaves, cin


def param_spec(units=None):
    """Both stages' leaves, as ``cap2det.param_spec`` lists them: the
    root's, then each unit's (shortcut, conv1, conv2, conv3), and no empty
    branches. `units`: the units of block1-block4, where a test runs a
    shallower network through the same code (the published counts by
    default)."""
    first = (common.FIRST_SCOPE, NET)
    leaves = _conv_leaves(first + ("conv1",), 64, 3, 7, GAMMA_STD_ROOT)
    block, cin = _block_leaves(first, FIRST_BLOCKS, 64,
                               units and units[:len(FIRST_BLOCKS)])
    leaves += block
    block, _ = _block_leaves((common.SECOND_SCOPE, NET), SECOND_BLOCKS, cin,
                             units and units[len(FIRST_BLOCKS):])
    return leaves + block, []


def channel_sum(g, w):
    """Per output channel, the float32 sum of ``g * w`` over its filter in
    (tap, input channel) order: LANES interleaved partial sums, element j
    into sum j mod LANES in turn, then halves added pairwise (sum l plus
    sum l xor 16, then xor 8, 4, 2, 1). Written out so that any
    implementation that keeps this order gives the same bits."""
    o = g.shape[0]
    prod = (g.float().permute(0, 2, 3, 1) * w.permute(0, 2, 3, 1)).reshape(
        o, -1)
    n = prod.shape[1]
    prod = F.pad(prod, (0, -(-n // LANES) * LANES - n)).reshape(o, -1, LANES)
    acc = torch.zeros((o, LANES), dtype=torch.float32, device=g.device)
    for k in range(prod.shape[1]):
        acc = acc + prod[:, k]
    lane = torch.arange(LANES, device=g.device)
    half = LANES // 2
    while half:
        acc = acc + acc[:, lane ^ half]
        half //= 2
    return acc[:, 0]


class _ScaledKernel(torch.autograd.Function):
    """(weights, gamma, moving_variance) -> the kernel ``cap2det.fold_bn``
    turns into ResNet's folded weight (see the module's docstring)."""

    @staticmethod
    def forward(ctx, w, gamma, var):
        inv = torch.rsqrt(var + EPSILON)
        scale = gamma * inv
        folded = (w * scale[:, None, None, None]).to(torch.bfloat16).float()
        shared = torch.rsqrt(var + common.BN_EPSILON)[:, None, None, None]
        ctx.save_for_backward(w, inv, scale, shared)
        return folded / shared

    @staticmethod
    def backward(ctx, grad):
        w, inv, scale, shared = ctx.saved_tensors
        g = (grad / shared).to(torch.bfloat16).float()
        dw = g * scale[:, None, None, None] if ctx.needs_input_grad[0] else None
        dgamma = channel_sum(g, w) * inv if ctx.needs_input_grad[1] else None
        return dw, dgamma, None


def dense_weights(node):
    """A convolution's kernel with its scale and ResNet's epsilon put in,
    for ``cap2det.fold_bn`` (see the module's docstring); None for a node
    that is no convolution."""
    bn = node.get("BatchNorm")
    if "weights" not in node or not isinstance(bn, dict) or "gamma" not in bn:
        return None
    return _ScaledKernel.apply(node["weights"], bn["gamma"],
                               bn["moving_variance"])


def preprocess(images):
    """RGB pixels minus the channel means."""
    return images.float() - torch.tensor(MEANS, device=images.device)


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------


def _conv(conv, x, stride=1, relu=True):
    """A folded convolution of NCHW x with ``conv2d_same``'s padding: the
    k - 1 padded rows split (k-1)//2 before, the rest after."""
    w = conv["weight"]
    k = w.shape[-1]
    before = (k - 1) // 2
    after = k - 1 - before
    padding = before
    if before != after:
        x = F.pad(x, (before, after, before, after))
        padding = 0
    out = F.conv2d(x.to(w.dtype), w, conv["bias"], stride=stride,
                   padding=padding)
    return torch.relu_(out) if relu else out


def _unit(p, x, stride):
    if "shortcut" in p:
        shortcut = _conv(p["shortcut"], x, stride, relu=False)
    else:
        shortcut = x[:, :, ::stride, ::stride]
    residual = _conv(p["conv1"], x)
    residual = _conv(p["conv2"], residual, stride)
    residual = _conv(p["conv3"], residual, relu=False)
    return torch.relu_(shortcut + residual)


def _units(p):
    return sorted(p, key=lambda name: int(name.split("_")[1]))


def _blocks(p, blocks, x):
    for name, _, _, _, _ in blocks:
        units = _units(p[name])
        for u in units:
            stride = STRIDES[name] if u == units[-1] else 1
            x = _unit(p[name][u]["bottleneck_v1"], x, stride)
    return x


def first_stage(folded, images):
    """Preprocessed [B, H, W, 3] -> block3 [B, H/16, W/16, 1024] NHWC."""
    p = folded[NET]
    x = images.contiguous().permute(0, 3, 1, 2)
    x = _conv(p["conv1"], x, 2)
    _, pt, pb = common.same_pads(x.shape[2], 3, 2)
    _, pl, pr = common.same_pads(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=-float("inf")), 3, 2)
    x = _blocks(p, FIRST_BLOCKS, x)
    return x.permute(0, 2, 3, 1).contiguous()


def second_stage(folded, rois):
    """ROI maps [N, S, S, 1024] -> block4 [N, S, S, 2048] NHWC."""
    x = rois.contiguous().permute(0, 3, 1, 2)
    x = _blocks(folded[NET], SECOND_BLOCKS, x)
    return x.permute(0, 2, 3, 1).contiguous()
