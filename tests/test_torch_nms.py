"""The port's batched class-wise NMS against the JAX package's at the
shipped shapes: voc07_inc2's [1, 2000, 20] with padded rows, coco17's eval
[1, 500, 80] and a batch of two, under both shipped threshold pairs, bit
for bit on the mask and on all four outputs. On the CPU the port runs
the kernel's plain version (``kernels/nms.plain_nms_mask``); the kernel
itself is held against it on the card (``tests/test_torch_gpu.py``). Also
the wrapper's argument checks, which run before its device branch, and
its walk statistics."""

import ctypes
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from cap2det_tpu.ops import nms as jax_nms
from cap2det_tpu_torch import kernels
from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.kernels import nms as nms_kernel
from cap2det_tpu_torch.ops import nms

torch.set_num_threads(1)

# The shipped post-processors (configs/*.pbtxt): MIDN and OICR.
MIDN = dict(score_thresh=1e-5, iou_thresh=0.4, max_size_per_class=100,
            max_total_size=300)
OICR = dict(MIDN, iou_thresh=0.3)
# (name, valid proposals per image, P, C): voc07_inc2 with 1500 valid of
# 2000, coco17's eval shape, two images with different valid counts.
SHAPES = [("voc07", [1500], 2000, 20), ("coco17", [500], 500, 80),
          ("batch2", [600, 1000], 1000, 20)]


def _case(seed, valid, num_p, num_c):
    """Seeded boxes clustered around a few objects (so suppression
    happens at both thresholds) and per-class scores without ties, spread
    log-uniformly over [1e-7, 1] so that some fall under score_thresh;
    padded rows have zero boxes and zero scores."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((len(valid), num_p, 4), np.float32)
    scores = np.zeros((len(valid), num_p, num_c), np.float32)
    for b, n in enumerate(valid):
        centers = rng.uniform(0.2, 0.8, (12, 2))
        pick = rng.integers(0, len(centers), n)
        size = rng.uniform(0.05, 0.5, (n, 2))
        c = centers[pick] + rng.normal(0, 0.05, (n, 2))
        boxes[b, :n] = np.clip(np.concatenate([c - size / 2, c + size / 2],
                                              -1), 0, 1)
        rank = np.argsort(rng.random((n, num_c)), axis=0)
        scores[b, :n] = 10.0 ** (-7.0 + 7.0 * (rank + 1) / (n + 1))
    return boxes, scores


def _jax_mask(boxes, scores, kw):
    return np.asarray(jax.vmap(lambda b, s: jax_nms._per_image_nms(
        b, s, kw["iou_thresh"], kw["score_thresh"],
        kw["max_size_per_class"]))(boxes, scores))


@pytest.mark.parametrize("name,valid,num_p,num_c", SHAPES,
                         ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("kw", [MIDN, OICR], ids=["midn", "oicr"])
def test_nms_equals_jax_at_the_shipped_shapes(name, valid, num_p, num_c,
                                              kw):
    boxes, scores = _case(len(name) + num_c, valid, num_p, num_c)
    boxes_t, scores_t = torch.from_numpy(boxes), torch.from_numpy(scores)
    mask = nms_kernel.nms_mask(boxes_t, scores_t, kw["score_thresh"],
                               kw["iou_thresh"], kw["max_size_per_class"])
    np.testing.assert_array_equal(mask.numpy(), _jax_mask(boxes, scores, kw))
    # batch_multiclass_nms is nms_mask, then merge_detections.
    want = [np.asarray(x)
            for x in jax_nms.batch_multiclass_nms(boxes, scores, **kw)]
    got = [x.numpy() for x in nms.merge_detections(
        boxes_t, scores_t, mask, kw["max_total_size"])]
    for key, g, w in zip(["num_detections", "boxes", "scores", "classes"],
                         got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    # Suppression happened, and some candidates fell under the threshold.
    candidates = (scores > kw["score_thresh"]).sum((1, 2))
    assert (0 < mask.sum((1, 2)).numpy()).all()
    assert (mask.sum((1, 2)).numpy() < candidates).all()
    assert (candidates < np.array(valid) * num_c).all()


def test_nms_equals_jax_where_the_cap_binds():
    kw = dict(OICR, max_size_per_class=8, max_total_size=100)
    boxes, scores = _case(3, [1500], 2000, 20)
    mask = nms_kernel.nms_mask(torch.from_numpy(boxes),
                               torch.from_numpy(scores), kw["score_thresh"],
                               kw["iou_thresh"], kw["max_size_per_class"])
    uncapped = nms_kernel.nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), kw["score_thresh"],
        kw["iou_thresh"], 2000)
    per_class = mask.sum(1).numpy()
    assert per_class.max() == 8 and (uncapped.sum(1).numpy() > 8).any()
    np.testing.assert_array_equal(mask.numpy(), _jax_mask(boxes, scores, kw))
    want = jax_nms.batch_multiclass_nms(boxes, scores, **kw)
    got = nms.batch_multiclass_nms(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_walk_stats_count_the_walk():
    """Hand-made ranks: class 0 keeps ranks 0 and 2 (rank 1 overlaps rank
    0) of 4 candidates and stops at the cap of 2; class 1 keeps its 2
    candidates, the second at the cap."""
    boxes = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 0.9], [2, 2, 3, 3],
                           [4, 4, 5, 5], [6, 6, 7, 7]]], dtype=torch.float32)
    scores = torch.tensor([[[0.9, 0.0], [0.8, 0.0], [0.7, 0.6], [0.6, 0.5],
                            [0.0, 0.0]]])
    keep = nms_kernel.nms_mask(boxes, scores, 0.1, 0.5, 2)
    assert keep[0, :, 0].tolist() == [True, False, True, False, False]
    assert keep[0, :, 1].tolist() == [False, False, True, True, False]
    stats = nms_kernel.walk_stats(scores, keep, 0.1, 2)
    assert stats["ranks"].tolist() == [[3, 2]]
    # Class 0: rank 0 walks ranks 1-2; class 1: rank 0 walks rank 1.
    assert stats["barriers"].tolist() == [[1, 1]]
    assert stats["iou_pairs"] == 3
    assert nms_kernel.nms_bytes(1, 5, 2) == 5 * (16 + 26)
    assert nms_kernel.nms_flops(1, 5, 2, 3) == 10 + 3 * nms_kernel.IOU_FLOPS


@pytest.mark.parametrize("boxes,scores,error", [
    (torch.zeros(1, 5, 4, dtype=torch.float64), torch.zeros(1, 5, 2),
     TypeError),
    (torch.zeros(1, 5, 4), torch.zeros(1, 5, 2, dtype=torch.bfloat16),
     TypeError),
    (torch.zeros(5, 4), torch.zeros(5, 2), ValueError),
    (torch.zeros(1, 5, 3), torch.zeros(1, 5, 2), ValueError),
    (torch.zeros(1, 6, 4), torch.zeros(1, 5, 2), ValueError),
    (torch.zeros(1, 5, 4, device="meta"), torch.zeros(1, 5, 2), ValueError),
    (torch.zeros(1, nms_kernel.MAX_PROPOSALS + 1, 4),
     torch.zeros(1, nms_kernel.MAX_PROPOSALS + 1, 1), ValueError),
], ids=["f64_boxes", "bf16_scores", "rank", "box_width", "proposals",
        "devices", "beyond_shared_memory"])
def test_wrapper_refuses_what_the_kernel_does_not_take(boxes, scores, error):
    before = kernels.launch_counts()["nms"]
    with pytest.raises(error) as info:
        nms_kernel.nms_mask(boxes, scores, 1e-5, 0.3, 100)
    if scores.shape[1] > nms_kernel.MAX_PROPOSALS:
        assert str(nms_kernel.MAX_PROPOSALS) in str(info.value)
    assert kernels.launch_counts()["nms"] == before == nms_kernel.launches


def test_the_limits_and_argtypes_match_the_source():
    text = (pathlib.Path(build.CSRC) / "nms.cu").read_text()
    assert "kSmemLimit = %d * 1024" % (nms_kernel.SMEM_LIMIT // 1024) in text
    assert "kSmemReserve = %d" % nms_kernel.SMEM_RESERVE in text
    assert "kBytesPerRank = sizeof(float4) + 1" in text
    assert nms_kernel.BYTES_PER_RANK == 16 + 1
    assert nms_kernel.MAX_PROPOSALS * nms_kernel.BYTES_PER_RANK <= (
        nms_kernel.SMEM_LIMIT - nms_kernel.SMEM_RESERVE)
    match = re.search(r'extern "C" int cap2det_nms\(([^)]*)\)', text)
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int": ctypes.c_int, "float": ctypes.c_float}
    params = [re.sub(r"\s+", " ", p).strip().rsplit(" ", 1)[0]
              for p in match.group(1).split(",")]
    assert nms_kernel._ARGTYPES == [c_types[p] for p in params]


def test_a_cpu_call_counts_no_launch():
    boxes, scores = _case(5, [40], 48, 3)
    before = nms_kernel.launches
    nms.batch_multiclass_nms(torch.from_numpy(boxes),
                             torch.from_numpy(scores), **OICR)
    assert nms_kernel.launches == before


def test_the_order_is_contiguous_and_the_launcher_checks_it():
    """A sort keeps its input's transposed strides: the kernel reads the
    order's memory as [B, C, P], so the wrapper makes it contiguous and
    the launcher refuses any other layout before it reaches the card."""
    scores = torch.rand(2, 7, 3)
    order = nms_kernel.rank_order(scores)
    assert order.is_contiguous() and order.shape == (2, 3, 7)
    strided = torch.argsort(-scores.transpose(1, 2), dim=-1, stable=True)
    assert torch.equal(order, strided) and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        nms_kernel._launch(torch.zeros(2, 7, 4), scores, strided, 1e-5, 0.3,
                           100)
