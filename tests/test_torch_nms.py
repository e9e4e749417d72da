"""The port's batched class-wise NMS against the JAX package's at the
shipped shapes: voc07_inc2's [1, 2000, 20] with padded rows, coco17's eval
[1, 500, 80] and a batch of two, under both shipped threshold pairs, bit
for bit on the mask and on all four outputs. On the CPU the port runs
the kernels' plain version (``kernels/nms.plain_nms_mask``); the kernels
themselves are held against it on the card (``tests/test_torch_gpu.py``).
The kernels' two stages, written plainly (``plain_overlap_bits``, the
class-agnostic overlap bitmask, and ``plain_walk``, the warp's walk over
it), are held against JAX's ``pairwise_iou`` and ``_per_image_nms`` bit
for bit, also at P around a word of 32 bits. Also the wrapper's argument
checks, which run before its device branch, and its walk statistics."""

import ctypes
import functools
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from cap2det_tpu.ops import boxes as jax_boxes
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
KW = {"midn": MIDN, "oicr": OICR}
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


@functools.lru_cache(maxsize=None)
def _shipped_case(name, kw_name):
    """(boxes, scores, JAX's mask) of a SHAPES case under MIDN or OICR,
    made once for the tests that share it."""
    _, valid, num_p, num_c = next(s for s in SHAPES if s[0] == name)
    boxes, scores = _case(len(name) + num_c, valid, num_p, num_c)
    return boxes, scores, _jax_mask(boxes, scores, KW[kw_name])


@pytest.mark.parametrize("name,valid,num_p,num_c", SHAPES,
                         ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("kw_name", ["midn", "oicr"])
def test_nms_equals_jax_at_the_shipped_shapes(name, valid, num_p, num_c,
                                              kw_name):
    kw = KW[kw_name]
    boxes, scores, jax_mask = _shipped_case(name, kw_name)
    boxes_t, scores_t = torch.from_numpy(boxes), torch.from_numpy(scores)
    mask = nms_kernel.nms_mask(boxes_t, scores_t, kw["score_thresh"],
                               kw["iou_thresh"], kw["max_size_per_class"])
    np.testing.assert_array_equal(mask.numpy(), jax_mask)
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
    # Both classes stop at their second survivor, in the first group of
    # 32 ranks.
    assert stats["survivors"].tolist() == [[2, 2]]
    assert stats["groups"].tolist() == [[1, 1]]
    # Class 0: rank 0 walks ranks 1-2; class 1: rank 0 walks rank 1.
    assert stats["iou_pairs"] == 3
    # Without a cap both walk to their first non-candidate: rank 4 and
    # rank 2; a cap of 0 walks nothing.
    keep = nms_kernel.nms_mask(boxes, scores, 0.1, 0.5, 100)
    stats = nms_kernel.walk_stats(scores, keep, 0.1, 100)
    assert stats["ranks"].tolist() == [[4, 2]]
    assert stats["survivors"].tolist() == [[3, 2]]
    assert stats["groups"].tolist() == [[1, 1]]
    stats = nms_kernel.walk_stats(
        scores, torch.zeros_like(keep), 0.1, 0)
    assert stats["ranks"].tolist() == stats["groups"].tolist() == [[0, 0]]
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
    (torch.zeros(nms_kernel.MAX_IMAGES + 1, 1, 4),
     torch.zeros(nms_kernel.MAX_IMAGES + 1, 1, 1), ValueError),
], ids=["f64_boxes", "bf16_scores", "rank", "box_width", "proposals",
        "devices", "beyond_shared_memory", "beyond_the_grid"])
def test_wrapper_refuses_what_the_kernel_does_not_take(boxes, scores, error):
    before = kernels.launch_counts()["nms"]
    with pytest.raises(error) as info:
        nms_kernel.nms_mask(boxes, scores, 1e-5, 0.3, 100)
    if scores.shape[1] > nms_kernel.MAX_PROPOSALS:
        assert str(nms_kernel.MAX_PROPOSALS) in str(info.value)
    if scores.shape[0] > nms_kernel.MAX_IMAGES:
        assert str(nms_kernel.MAX_IMAGES) in str(info.value)
    assert kernels.launch_counts()["nms"] == before == nms_kernel.launches


def test_the_limits_and_argtypes_match_the_source():
    text = (pathlib.Path(build.CSRC) / "nms.cu").read_text()
    assert "kSmemLimit = %d * 1024" % (nms_kernel.SMEM_LIMIT // 1024) in text
    assert "kSmemReserve = %d" % nms_kernel.SMEM_RESERVE in text
    assert "kMinStages = %d;" % nms_kernel.MIN_STAGES in text
    assert "kMaxImages = %d" % nms_kernel.MAX_IMAGES in text
    assert re.search(
        r"kSmemWords =\s+\(int\)\(\(kSmemLimit - kSmemReserve\) / "
        r"sizeof\(unsigned\)\);", text)
    assert re.search(
        r"kMaxWords =\s+\(kSmemWords - kMinStages \* 32 \* 4\) / "
        r"\(1 \+ kMinStages \* 32\) / 4 \* 4;"
        r"\s+constexpr int kMaxProposals = 32 \* kMaxWords;", text)
    assert "return ((P + 31) / 32 + 3) / 4 * 4;" in text
    assert "return (row / 4) % 2 ? row : row + 4;" in text
    assert re.search(r"return \(kSmemWords - row\) / \(32 \* stage_stride"
                     r"\(row\)\) < kMaxStages", text)
    # The walk's words at P (a row of removed words, and MIN_STAGES groups
    # of staged rows at their stride) fit the limit up to MAX_PROPOSALS;
    # the limit is the most a row may hold when every staged row takes 4
    # words more.
    limit = (nms_kernel.SMEM_LIMIT - nms_kernel.SMEM_RESERVE) // 4
    rows = nms_kernel.MIN_STAGES * 32

    def walk_words(row):
        return row + rows * (row if (row // 4) % 2 else row + 4)

    assert nms_kernel.row_words(nms_kernel.MAX_PROPOSALS) == (
        nms_kernel.MAX_ROW_WORDS)
    assert max(walk_words(r) for r in range(4, nms_kernel.MAX_ROW_WORDS + 1,
                                            4)) <= limit
    most = nms_kernel.MAX_ROW_WORDS
    assert most + rows * (most + 4) <= limit < most + 4 + rows * (most + 8)
    # The old kernel's limit, 17 bytes a rank, still fits.
    assert nms_kernel.MAX_PROPOSALS >= 13613
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int": ctypes.c_int, "float": ctypes.c_float}
    for entry, argtypes in (("cap2det_nms", nms_kernel._ARGTYPES),
                            ("cap2det_nms_bits", nms_kernel._BITS_ARGTYPES),
                            ("cap2det_nms_walk", nms_kernel._WALK_ARGTYPES)):
        match = re.search(r'extern "C" int %s\(([^)]*)\)' % entry, text)
        params = [re.sub(r"\s+", " ", p).strip().rsplit(" ", 1)[0]
                  for p in match.group(1).split(",")]
        assert argtypes == [c_types[p] for p in params], entry


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


def _unpack(bits, num_p):
    """[B, P, P] bool from the packed [B, P, W] words; asserts that the
    bits past P are 0."""
    bits = bits.astype(np.int64) & 0xFFFFFFFF
    over = (bits[..., None] >> np.arange(32)) & 1
    over = over.reshape(*bits.shape[:2], -1).astype(bool)
    assert not over[..., num_p:].any()
    return over[..., :num_p]


# Proposal counts about a word of 32 bits, and past the serve shape.
WORD_EDGES = [("p31", [31], 31, 3), ("p32", [30], 32, 3),
              ("p33", [33], 33, 4), ("p2001", [1900], 2001, 20)]


BITS_SHAPES = [("p1", [1], 1, 1)] + WORD_EDGES + SHAPES


@pytest.mark.parametrize("name,valid,num_p,num_c", BITS_SHAPES,
                         ids=[s[0] for s in BITS_SHAPES])
@pytest.mark.parametrize("iou_thresh", [0.3, 0.4])
def test_overlap_bits_equal_jax(name, valid, num_p, num_c, iou_thresh):
    boxes, _ = _case(len(name) + num_p, valid, num_p, num_c)
    bits = nms_kernel.plain_overlap_bits(torch.from_numpy(boxes), iou_thresh)
    assert bits.dtype == torch.int32
    assert bits.shape == (len(valid), num_p, nms_kernel.row_words(num_p))
    want = np.asarray(jax_boxes.pairwise_iou(boxes, boxes)) > iou_thresh
    np.testing.assert_array_equal(_unpack(bits.numpy(), num_p), want)
    assert want.any() and (num_p == 1 or not want.all())


def _two_stage(boxes, scores, kw):
    boxes_t, scores_t = torch.from_numpy(boxes), torch.from_numpy(scores)
    bits = nms_kernel.plain_overlap_bits(boxes_t, kw["iou_thresh"])
    return nms_kernel.plain_walk(
        bits, nms_kernel.rank_order(scores_t), scores_t, kw["score_thresh"],
        kw["max_size_per_class"]).numpy()


@pytest.mark.parametrize("name,valid,num_p,num_c", SHAPES,
                         ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("kw_name", ["midn", "oicr"])
def test_the_two_stage_walk_equals_jax_at_the_shipped_shapes(
        name, valid, num_p, num_c, kw_name):
    boxes, scores, jax_mask = _shipped_case(name, kw_name)
    np.testing.assert_array_equal(_two_stage(boxes, scores, KW[kw_name]),
                                  jax_mask)


@pytest.mark.parametrize("name,valid,num_p,num_c", WORD_EDGES,
                         ids=[s[0] for s in WORD_EDGES])
@pytest.mark.parametrize("kw_name", ["midn", "oicr", "cap"])
def test_the_two_stage_walk_equals_jax_about_a_word(name, valid, num_p,
                                                    num_c, kw_name):
    """Boxes past a word's end (P = 31, 32, 33, 2001) and a cap that
    binds; the small cases also reach their last rank."""
    kw = dict(OICR, max_size_per_class=5) if kw_name == "cap" else (
        KW[kw_name])
    boxes, scores = _case(len(name) + num_p, valid, num_p, num_c)
    want = _jax_mask(boxes, scores, kw)
    np.testing.assert_array_equal(_two_stage(boxes, scores, kw), want)
    assert want.any()


def test_the_two_stage_walk_at_the_edges():
    """No candidate, a cap of 0 and 1, every score at the threshold, a
    NaN score and zero-area and NaN boxes, against the plain pass."""
    boxes, scores = _case(9, [40], 48, 3)
    boxes[0, 3] = [0.5, 0.5, 0.5, 0.5]
    boxes[0, 4, 1] = np.nan
    scores[0, 5, 0] = np.nan
    boxes_t = torch.from_numpy(boxes)
    for s, thresh, cap in ((scores * 0, 1e-5, 100), (scores, 1e-5, 0),
                           (scores, 1e-5, 1), (scores, 1e-5, 10 ** 12),
                           (np.full_like(scores, 0.25), 0.25, 100),
                           (np.full_like(scores, 0.25), 0.2, 100)):
        s_t = torch.from_numpy(s)
        bits = nms_kernel.plain_overlap_bits(boxes_t, 0.3)
        got = nms_kernel.plain_walk(bits, nms_kernel.rank_order(s_t), s_t,
                                    thresh, cap)
        want = nms_kernel.plain_nms_mask(boxes_t, s_t, thresh, 0.3, cap)
        assert got.dtype == torch.bool and got.shape == want.shape
        assert torch.equal(got, want), (thresh, cap)
