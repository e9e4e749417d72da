"""Fast-RCNN proposal feature extraction (port of
``cap2det_tpu/models/frcnn.py``).

preprocess -> first-stage InceptionV2 (full image, stride 16) ->
[training: optional feature-map dropout] -> fused ROI crop_and_resize +
max-pool (``kernels/roi_pool``) -> second-stage InceptionV2 over B*P ROIs
-> float32 spatial mean -> [training: dropout] -> [B, P, 1024].
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.kernels import roi_pool
from cap2det_tpu_torch.models import inception_v2

FIRST_SCOPE = "first_stage_feature_extraction"
SECOND_SCOPE = "second_stage_feature_extraction"
FIRST_LAYERS = ["Conv2d_1a_7x7", "Conv2d_2b_1x1", "Conv2d_2c_3x3",
                *inception_v2.FIRST_BLOCKS]


def _check_extractor(options: schema.FRCNN):
    fe_type = options.feature_extractor.type if options.feature_extractor else ""
    if fe_type != "faster_rcnn_inception_v2":
        raise ValueError(
            "unsupported feature extractor %r (faster_rcnn_inception_v2 only)"
            % fe_type
        )


def init_params_numpy(seed_or_rng, options: schema.FRCNN):
    """JAX-layout numpy tree of both stages (see inception_v2)."""
    _check_extractor(options)
    rng = np.random.default_rng(seed_or_rng)
    return {
        FIRST_SCOPE: inception_v2.init_first_stage_params_numpy(rng),
        SECOND_SCOPE: inception_v2.init_second_stage_params_numpy(rng),
    }


def prepare(params, compute_dtype=torch.bfloat16):
    """Both stages' params as ``inception_v2.prepare`` makes them."""
    return {scope: inception_v2.prepare(params[scope], compute_dtype)
            for scope in (FIRST_SCOPE, SECOND_SCOPE)}


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
                     second_stage_chunk=None):
    """Returns [B, P, 1024] float32 pooled proposal features.

    Args:
      prepared: {first/second_stage_feature_extraction: inception params
        made by ``prepare``}; the convs run in their weights' dtype.
      images: [B, H, W, 3] raw pixel values in [0, 255] (any real dtype).
      proposals: [B, P, 4] float32 canvas-normalized boxes.
      is_training: apply dropout (on the feature map when
        ``dropout_on_feature_map``; on the pooled features when
        ``dropout_keep_prob < 1``), drawn from `generator`.
      second_stage_chunk: optional number of ROIs per pass through the
        second stage; None runs all B*P at once. When it would engage it
        must divide B*P, as in the JAX package.
    """
    batch, num_proposals = proposals.shape[:2]
    keep_prob = options.dropout_keep_prob
    preprocessed = inception_v2.preprocess(images.float())
    features = inception_v2.first_stage(prepared[FIRST_SCOPE], preprocessed)
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
            inception_v2.second_stage(prepared[SECOND_SCOPE],
                                      rois[i:i + second_stage_chunk])
            for i in range(0, n, second_stage_chunk)
        ])
    else:
        box_features = inception_v2.second_stage(prepared[SECOND_SCOPE], rois)
    pooled = box_features.float().mean(dim=(1, 2))  # [B*P, 1024]
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
    """Overlays converted ImageNet InceptionV2 weights onto both stages by
    layer name: the stem + Mixed_3*/4* go to the first stage, Mixed_5* to
    the second. ``converted_checkpoint`` is an {'InceptionV2': {...}} tree
    of port tensors (``params.from_jax_numpy`` of the converter's tree).

    Each layer is merged leaf by leaf, not replaced whole: a converted
    checkpoint holds no entry for a pool branch's empty block
    (``Mixed_4a/Branch_2``), which the forward pass looks up, so that
    block is kept from ``params``. (The JAX package's overlay replaces the
    layer and loses it.)"""
    src = converted_checkpoint["InceptionV2"]
    out = {k: dict(v) for k, v in params.items()}
    for scope, names in ((FIRST_SCOPE, FIRST_LAYERS),
                         (SECOND_SCOPE, inception_v2.SECOND_BLOCKS)):
        dst = dict(out[scope]["InceptionV2"])
        for name in names:
            if name in src:
                dst[name] = _overlay(dst.get(name), src[name])
        out[scope] = {"InceptionV2": dst}
    return out
