"""Small ops of the PyTorch port against the JAX package: masked
reductions, box geometry and batched class-wise NMS."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.ops import boxes as jax_boxes
from cap2det_tpu.ops import masked as jax_masked
from cap2det_tpu.ops import nms as jax_nms
from cap2det_tpu_torch.ops import boxes, masked, nms

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_boxes(rng, shape, empty=0):
    y0 = rng.uniform(0, 0.7, shape)
    x0 = rng.uniform(0, 0.7, shape)
    b = np.stack([y0, x0, y0 + rng.uniform(0.05, 0.4, shape),
                  x0 + rng.uniform(0.05, 0.4, shape)], -1).astype(np.float32)
    if empty:
        b.reshape(-1, 4)[:empty] = 0.0  # zero (padding) boxes
    return b


def test_sequence_mask():
    lengths = np.array([0, 3, 5], np.int32)
    want = np.asarray(jax_masked.sequence_mask(jnp.asarray(lengths), 5))
    got = masked.sequence_mask(_t(lengths), 5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [1, -1])
def test_masked_softmax_and_sum(dim):
    rng = np.random.RandomState(0)
    data = rng.randn(3, 6, 4).astype(np.float32)
    mask = (rng.rand(3, 6, 4) > 0.4).astype(np.float32)
    mask[1] = 0.0  # an all-masked row stays finite
    want = np.asarray(jax_masked.masked_softmax(data, mask, axis=dim))
    got = masked.masked_softmax(_t(data), _t(mask), dim=dim).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = np.asarray(
        jax_masked.masked_sum(data, mask, axis=dim, keepdims=False))
    got = masked.masked_sum(_t(data), _t(mask), dim=dim, keepdim=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_box_geometry():
    rng = np.random.RandomState(1)
    b1 = _random_boxes(rng, (2, 7), empty=2)
    b2 = _random_boxes(rng, (2, 5), empty=1)
    np.testing.assert_allclose(boxes.area(_t(b1)).numpy(),
                               np.asarray(jax_boxes.area(b1)), rtol=1e-6)
    np.testing.assert_array_equal(
        boxes.intersect(_t(b1[:, :5]), _t(b2)).numpy(),
        np.asarray(jax_boxes.intersect(b1[:, :5], b2)))
    got = boxes.pairwise_iou(_t(b1), _t(b2)).numpy()
    want = np.asarray(jax_boxes.pairwise_iou(b1, b2))
    assert got.shape == (2, 7, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _nms_case(kind, rng):
    num_b, num_p, num_c = 2, 12, 3
    b = _random_boxes(rng, (num_b, num_p))
    # Cluster some boxes so suppression happens.
    b[:, 6:] = b[:, :6] + rng.uniform(-0.02, 0.02, (num_b, 6, 4))
    s = rng.uniform(0, 1, (num_b, num_p, num_c)).astype(np.float32)
    kw = dict(score_thresh=0.1, iou_thresh=0.5, max_size_per_class=4,
              max_total_size=10)
    if kind == "ties":
        s = np.round(s * 4) / 4  # many equal scores
    elif kind == "masked_rows":
        s[0] = 0.0  # image 0 has no candidate at all
        s[1, :, 1] = 0.0  # a class with no candidate
    elif kind == "total_gt_pc":
        kw.update(max_total_size=2 * num_p * num_c + 5)
    elif kind == "threshold_equal":
        s[:, :4] = 0.1  # exactly at the threshold: not candidates (strict >)
    return b.astype(np.float32), s, kw


@pytest.mark.parametrize(
    "kind", ["random", "ties", "masked_rows", "total_gt_pc",
             "threshold_equal"])
def test_batch_multiclass_nms_matches_jax(kind):
    rng = np.random.RandomState(hash(kind) % 1000)
    b, s, kw = _nms_case(kind, rng)
    want = [np.asarray(x) for x in jax_nms.batch_multiclass_nms(b, s, **kw)]
    got = [x.numpy() for x in nms.batch_multiclass_nms(_t(b), _t(s), **kw)]
    names = ["num_detections", "boxes", "scores", "classes"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].dtype == np.int32


def test_post_processor_factory():
    from cap2det_tpu_torch.config import schema

    opts = schema.PostProcess.from_dict(
        {"score_thresh": 0.2, "iou_thresh": 0.3, "max_size_per_class": 2,
         "max_total_size": 5})
    rng = np.random.RandomState(2)
    b, s, _ = _nms_case("random", rng)
    got = nms.build_post_processor(opts)(_t(b), _t(s))
    want = jax_nms.batch_multiclass_nms(
        b, s, score_thresh=0.2, iou_thresh=0.3, max_size_per_class=2,
        max_total_size=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
