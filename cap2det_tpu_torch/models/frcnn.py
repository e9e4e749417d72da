"""Fast-RCNN proposal feature extraction (port of
``cap2det_tpu/models/frcnn.py``).

preprocess -> first-stage backbone (full image, stride 16) ->
[training: optional feature-map dropout] -> fused ROI crop_and_resize +
max-pool (``kernels/roi_pool``) -> second-stage backbone over B*P ROIs
-> float32 spatial mean -> [training: dropout] -> [B, P, FEATURE_DIM].

The backbone is the module that ``feature_extractor.type`` names
(``BACKBONES``): ``faster_rcnn_inception_v2`` (``inception_v2``, 1024
features, the JAX package's only one) or ``faster_rcnn_resnet101``
(``resnet_v1``, 2048). Each gives ``NET`` (its params tree's root, by
which ``prepare`` and ``load_pretrained`` find it in a tree),
``BN_EPSILON``, ``FEATURE_DIM``, ``init_first_stage_params_numpy``,
``init_second_stage_params_numpy``, ``preprocess``, ``first_stage`` and
``second_stage``.
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.kernels import bn_fold, roi_pool
from cap2det_tpu_torch.models import inception_v2, resnet_v1

FIRST_SCOPE = "first_stage_feature_extraction"
SECOND_SCOPE = "second_stage_feature_extraction"
BACKBONES = {"faster_rcnn_inception_v2": inception_v2,
             "faster_rcnn_resnet101": resnet_v1}
NETS = {net.NET: net for net in BACKBONES.values()}  # by the tree's root
FIRST_LAYERS = ["Conv2d_1a_7x7", "Conv2d_2b_1x1", "Conv2d_2c_3x3",
                *inception_v2.FIRST_BLOCKS]
# Each backbone's first- and second-stage layers in a converted
# classification checkpoint, by name.
PRETRAINED_LAYERS = {
    inception_v2.NET: (FIRST_LAYERS, inception_v2.SECOND_BLOCKS),
    resnet_v1.NET: (["conv1"] + [b[0] for b in resnet_v1.FIRST_BLOCKS],
                    [b[0] for b in resnet_v1.SECOND_BLOCKS]),
}


def backbone(options: schema.FRCNN):
    """The backbone module that ``options.feature_extractor.type`` names;
    raises on any other type."""
    fe_type = options.feature_extractor.type if options.feature_extractor else ""
    if fe_type not in BACKBONES:
        raise ValueError("unsupported feature extractor %r (one of %s)"
                         % (fe_type, ", ".join(sorted(BACKBONES))))
    return BACKBONES[fe_type]


def init_params_numpy(seed_or_rng, options: schema.FRCNN):
    """JAX-layout numpy tree of both stages of the options' backbone."""
    net = backbone(options)
    rng = np.random.default_rng(seed_or_rng)
    return {
        FIRST_SCOPE: net.init_first_stage_params_numpy(rng),
        SECOND_SCOPE: net.init_second_stage_params_numpy(rng),
    }


def prepare(params, compute_dtype=torch.bfloat16):
    """Both stages' params -> the trees their stages read: every
    convolution's frozen BN folded with the backbone's epsilon into its
    weights and bias in compute_dtype, the weights channels-last, both
    stages in one ``bn_fold.fold_trees`` call (one launch on the card)."""
    scopes = (FIRST_SCOPE, SECOND_SCOPE)
    net = NETS[next(iter(params[FIRST_SCOPE]))]
    return dict(zip(scopes, bn_fold.fold_trees(
        [params[scope] for scope in scopes], compute_dtype, net.BN_EPSILON)))


def dropout(x, keep_prob, generator):
    """Inverted dropout: where(keep, x / keep_prob, 0), keep drawn with
    probability keep_prob from `generator` (on x's device)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep_prob
    # A tensor divisor: CUDA turns division by a Python scalar into a
    # reciprocal multiply, up to one ulp off the IEEE quotient.
    divisor = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / divisor, torch.zeros_like(x))


def extract_features(prepared, images, proposals, options: schema.FRCNN,
                     is_training=False, generator=None,
                     second_stage_chunk=None, second_stage_remat=False):
    """Returns [B, P, FEATURE_DIM] float32 pooled proposal features (1024
    for InceptionV2, 2048 for ResNet-101).

    Args:
      prepared: {first/second_stage_feature_extraction: the backbone's
        params made by ``prepare``}; the convs run in their weights'
        dtype.
      images: [B, H, W, 3] raw pixel values in [0, 255] (any real dtype).
      proposals: [B, P, 4] float32 canvas-normalized boxes.
      is_training: apply dropout (on the feature map when
        ``dropout_on_feature_map``; on the pooled features when
        ``dropout_keep_prob < 1``), drawn from `generator`.
      second_stage_chunk: optional number of ROIs per pass through the
        second stage; None runs all B*P at once. When it would engage it
        must divide B*P, as in the JAX package.
      second_stage_remat: recompute each Mixed_5 block, or each unit of
        block4, in the backward (the backbone's ``second_stage(remat=
        True)``), in every chunk.
    """
    net = backbone(options)
    batch, num_proposals = proposals.shape[:2]
    keep_prob = options.dropout_keep_prob
    preprocessed = net.preprocess(images.float())
    features = net.first_stage(prepared[FIRST_SCOPE], preprocessed)
    if is_training and options.dropout_on_feature_map:
        features = dropout(features, keep_prob, generator)
    rois = roi_pool.roi_crop_maxpool(
        features,
        proposals.float().contiguous(),
        options.initial_crop_size,
        options.maxpool_kernel_size,
        options.maxpool_stride,
    )  # [B, P, S', S', C]
    s = rois.shape[2]
    rois = rois.reshape(batch * num_proposals, s, s, rois.shape[-1])
    n = rois.shape[0]
    if second_stage_chunk and n > second_stage_chunk:
        if n % second_stage_chunk:
            raise ValueError(
                "second_stage_chunk=%d does not divide batch*num_proposals=%d"
                % (second_stage_chunk, n)
            )
        box_features = torch.cat([
            net.second_stage(prepared[SECOND_SCOPE],
                             rois[i:i + second_stage_chunk],
                             remat=second_stage_remat)
            for i in range(0, n, second_stage_chunk)
        ])
    else:
        box_features = net.second_stage(
            prepared[SECOND_SCOPE], rois, remat=second_stage_remat)
    pooled = box_features.float().mean(dim=(1, 2))  # [B*P, FEATURE_DIM]
    if is_training and keep_prob < 1.0:
        pooled = dropout(pooled, keep_prob, generator)
    return pooled.reshape(batch, num_proposals, -1)


def _overlay(dst, src):
    """`dst` with `src`'s leaves put in, key by key: a key `src` lacks
    keeps `dst`'s value."""
    if not isinstance(src, dict):
        return src
    out = dict(dst) if isinstance(dst, dict) else {}
    for key, value in src.items():
        out[key] = _overlay(out.get(key), value)
    return out


def load_pretrained(params, converted_checkpoint):
    """Overlays converted ImageNet classification weights onto both
    stages by layer name. ``converted_checkpoint`` is an {NET: {...}} tree
    of port tensors (``params.from_jax_numpy`` of the converter's tree),
    the root of the params' backbone: for InceptionV2 the stem +
    Mixed_3*/4* go to the first stage, Mixed_5* to the second; for
    ResNet-101 ``conv1`` and block1-block3 to the first, block4 to the
    second.

    Each layer is merged leaf by leaf, not replaced whole: a converted
    checkpoint holds no entry for a pool branch's empty block
    (``Mixed_4a/Branch_2``), which the forward pass looks up, so that
    block is kept from ``params``. (The JAX package's overlay replaces the
    layer and loses it.)"""
    root = next(iter(params[FIRST_SCOPE]))
    src = converted_checkpoint[root]
    first, second = PRETRAINED_LAYERS[root]
    out = {k: dict(v) for k, v in params.items()}
    for scope, names in ((FIRST_SCOPE, first), (SECOND_SCOPE, second)):
        dst = dict(out[scope][root])
        for name in names:
            if name in src:
                dst[name] = _overlay(dst.get(name), src[name])
        out[scope] = {root: dst}
    return out
