"""The port's VOC and COCO evaluators (``cap2det_tpu_torch/eval/{voc_eval,
coco_eval}.py``) against the JAX package's.

The seeded scenes are ``tests/test_eval_oracle.py``'s (score ties,
duplicate detections and ground truths, difficult flags, empty images,
all three COCO area ranges): every metric key and value must equal the
JAX evaluator's exactly, NaN where it gives NaN. The hand-computed cases
of ``tests/test_eval.py`` and ``tests/test_coco_eval.py`` run against the
port as one parametrised test.
"""

import math

import numpy as np
import pytest
import torch

from cap2det_tpu.eval import coco_eval as jax_coco_eval
from cap2det_tpu.eval import voc_eval as jax_voc_eval
from cap2det_tpu_torch.eval import coco_eval, evaluator, voc_eval
from tests.test_eval_oracle import _random_coco_scenes, _random_voc_scenes

torch.set_num_threads(1)


def _same_metrics(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w), key
        if isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), (key, g)
        else:
            assert g == w, (key, g, w)


def _fill(ev, gt_infos, det_infos):
    for img, (gt, det) in enumerate(zip(gt_infos, det_infos)):
        ev.add_single_ground_truth_image_info("img%d" % img, gt)
        ev.add_single_detected_image_info("img%d" % img, det)
    return ev.evaluate()


@pytest.mark.parametrize("trial", range(40))
def test_voc_eval_equals_jax(trial):
    rs = np.random.RandomState(1000 + trial)
    n_images = rs.randint(2, 7)
    n_classes = rs.randint(1, 4)
    thr = float(rs.choice([0.3, 0.5, 0.75]))
    _, gt_infos, det_infos = _random_voc_scenes(rs, n_images, n_classes)
    cats = [{"id": c, "name": "c%d" % c} for c in range(1, n_classes + 1)]
    got = _fill(voc_eval.PascalDetectionEvaluator(
        cats, matching_iou_threshold=thr), gt_infos, det_infos)
    want = _fill(jax_voc_eval.PascalDetectionEvaluator(
        cats, matching_iou_threshold=thr), gt_infos, det_infos)
    _same_metrics(got, want)


@pytest.mark.parametrize("trial", range(25))
def test_coco_eval_equals_jax(trial):
    rs = np.random.RandomState(2000 + trial)
    n_images = rs.randint(2, 5)
    n_classes = rs.randint(1, 4)
    _, gt_infos, det_infos = _random_coco_scenes(rs, n_images, n_classes)
    cats = [{"id": c, "name": "c%d" % c} for c in range(1, n_classes + 1)]
    got = _fill(coco_eval.CocoDetectionEvaluator(cats), gt_infos, det_infos)
    want = _fill(jax_coco_eval.CocoDetectionEvaluator(cats), gt_infos,
                 det_infos)
    _same_metrics(got, want)


# -- the hand-computed cases of tests/test_eval.py and test_coco_eval.py ----

VOC_CATS = [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]
COCO_CATS = [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}]


def _voc(gt, det, cats=VOC_CATS):
    ev = voc_eval.PascalDetectionEvaluator(cats)
    ev.add_single_ground_truth_image_info("img0", gt)
    ev.add_single_detected_image_info("img0", det)
    return ev.evaluate()


def _coco(gt_boxes, gt_classes, det_boxes, det_scores, det_classes):
    ev = coco_eval.CocoDetectionEvaluator(COCO_CATS)
    ev.add_single_ground_truth_image_info(
        "img0", {"groundtruth_boxes": gt_boxes,
                 "groundtruth_classes": gt_classes})
    ev.add_single_detected_image_info(
        "img0", {"detection_boxes": det_boxes, "detection_scores": det_scores,
                 "detection_classes": det_classes})
    return ev.evaluate()


def _voc_perfect():
    gt = np.array([[0, 0, 1, 1], [2, 2, 3, 3]], np.float32)
    res = _voc({"groundtruth_boxes": gt, "groundtruth_classes": [1, 2]},
               {"detection_boxes": gt, "detection_scores": [0.9, 0.8],
                "detection_classes": [1, 2]})
    assert res["PascalBoxes_Precision/mAP@0.5IOU"] == pytest.approx(1.0)
    assert res["PascalBoxes_PerformanceByCategory/AP@0.5IOU/a"] == (
        pytest.approx(1.0))
    assert res["PascalBoxes_Precision/meanCorLoc@0.5IOU"] == (
        pytest.approx(1.0))


def _voc_fp_before_tp():
    res = _voc({"groundtruth_boxes": [[0, 0, 1, 1]],
                "groundtruth_classes": [1]},
               {"detection_boxes": [[5, 5, 6, 6], [0, 0, 1, 1]],
                "detection_scores": [0.9, 0.8], "detection_classes": [1, 1]},
               cats=[{"id": 1, "name": "a"}])
    assert res["PascalBoxes_Precision/mAP@0.5IOU"] == pytest.approx(0.5)
    assert res["PascalBoxes_Precision/meanCorLoc@0.5IOU"] == (
        pytest.approx(0.0))


def _voc_duplicates_are_fp():
    res = _voc({"groundtruth_boxes": [[0, 0, 1, 1]],
                "groundtruth_classes": [1]},
               {"detection_boxes": [[0, 0, 1, 1], [0, 0, 1.01, 1.01]],
                "detection_scores": [0.9, 0.8], "detection_classes": [1, 1]},
               cats=[{"id": 1, "name": "a"}])
    assert res["PascalBoxes_Precision/mAP@0.5IOU"] == pytest.approx(1.0)


def _voc_difficult_ignored():
    res = _voc({"groundtruth_boxes": [[0, 0, 1, 1], [2, 2, 3, 3]],
                "groundtruth_classes": [1, 1],
                "groundtruth_difficult": [False, True]},
               {"detection_boxes": [[0, 0, 1, 1], [2, 2, 3, 3]],
                "detection_scores": [0.9, 0.8], "detection_classes": [1, 1]},
               cats=[{"id": 1, "name": "a"}])
    assert res["PascalBoxes_Precision/mAP@0.5IOU"] == pytest.approx(1.0)


def _voc_no_detections_is_ap_zero():
    res = _voc({"groundtruth_boxes": [[0, 0, 1, 1]],
                "groundtruth_classes": [1]},
               {"detection_boxes": np.zeros((0, 4)), "detection_scores": [],
                "detection_classes": []})
    assert res["PascalBoxes_PerformanceByCategory/AP@0.5IOU/a"] == 0.0
    assert math.isnan(res["PascalBoxes_PerformanceByCategory/AP@0.5IOU/b"])
    assert res["PascalBoxes_Precision/mAP@0.5IOU"] == 0.0


def _voc_average_precision():
    ap = voc_eval.compute_average_precision(np.array([1.0, 0.5, 2 / 3]),
                                            np.array([0.5, 0.5, 1.0]))
    assert ap == pytest.approx(0.5 * 1.0 + 0.5 * 2 / 3)


def _voc_coco_to_voc_remap():
    b, s, c = voc_eval.convert_coco_result_to_voc(
        np.array([[0, 0, 1, 1], [1, 1, 2, 2], [2, 2, 3, 3]]),
        np.array([0.9, 0.8, 0.7]), np.array([5, 99, 1]))
    assert len(b) == 2 and len(s) == 2
    np.testing.assert_array_equal(c, [1, 15])


def _coco_perfect():
    gt = [[0.0, 0.0, 100.0, 100.0]]
    res = _coco(gt, [1], gt, [0.9], [1])
    for key in ("Precision/mAP", "Precision/mAP@.50IOU",
                "Precision/mAP@.75IOU", "Recall/AR@1", "Recall/AR@100",
                "Precision/mAP (large)"):
        assert res["DetectionBoxes_" + key] == pytest.approx(1.0), key
    assert np.isnan(res["DetectionBoxes_Precision/mAP (small)"])
    assert np.isnan(res["DetectionBoxes_Precision/mAP (medium)"])


def _coco_graded_iou():
    res = _coco([[0.0, 0.0, 100.0, 100.0]], [1], [[0.0, 0.0, 100.0, 62.0]],
                [0.9], [1])
    assert res["DetectionBoxes_Precision/mAP"] == pytest.approx(0.3)
    assert res["DetectionBoxes_Precision/mAP@.50IOU"] == pytest.approx(1.0)
    assert res["DetectionBoxes_Precision/mAP@.75IOU"] == pytest.approx(0.0)
    assert res["DetectionBoxes_Recall/AR@100"] == pytest.approx(0.3)


def _coco_fp_above_tp():
    res = _coco([[0.0, 0.0, 100.0, 100.0]], [1],
                [[200.0, 200.0, 300.0, 300.0], [0.0, 0.0, 100.0, 100.0]],
                [0.9, 0.8], [1, 1])
    assert res["DetectionBoxes_Precision/mAP"] == pytest.approx(0.5)
    assert res["DetectionBoxes_Recall/AR@1"] == pytest.approx(0.0)
    assert res["DetectionBoxes_Recall/AR@100"] == pytest.approx(1.0)


def _coco_unmatched_gt_takes_the_match():
    gt = [[0.0, 0.0, 100.0, 100.0], [0.0, 0.0, 100.0, 100.0]]
    res = _coco(gt, [1, 1], gt, [0.9, 0.8], [1, 1])
    assert res["DetectionBoxes_Precision/mAP"] == pytest.approx(1.0)
    assert res["DetectionBoxes_Recall/AR@100"] == pytest.approx(1.0)


def _coco_area_splits():
    gt = [[0.0, 0.0, 20.0, 20.0], [300.0, 300.0, 500.0, 500.0]]
    res = _coco(gt, [1, 1], list(gt), [0.9, 0.8], [1, 1])
    assert res["DetectionBoxes_Precision/mAP (small)"] == pytest.approx(1.0)
    assert res["DetectionBoxes_Precision/mAP (large)"] == pytest.approx(1.0)
    assert np.isnan(res["DetectionBoxes_Precision/mAP (medium)"])
    res = _coco(gt, [1, 1], [gt[1]], [0.9], [1])
    assert res["DetectionBoxes_Precision/mAP (large)"] == pytest.approx(1.0)
    assert res["DetectionBoxes_Precision/mAP (small)"] == pytest.approx(0.0)
    assert res["DetectionBoxes_Precision/mAP"] == pytest.approx(
        np.mean(np.linspace(0, 1, 101) <= 0.5))


def _coco_class_averaging():
    gt = [[0.0, 0.0, 100.0, 100.0]]
    res = _coco(gt, [1], gt + [[0.0, 0.0, 50.0, 50.0]], [0.9, 0.8], [1, 2])
    assert res["DetectionBoxes_Precision/mAP"] == pytest.approx(1.0)


def _coco_ar_at_k():
    gt = [[0.0, 0.0, 100.0, 100.0], [200.0, 0.0, 300.0, 100.0]]
    res = _coco(gt, [1, 1], [[400.0, 400.0, 500.0, 500.0]] + gt,
                [0.9, 0.8, 0.7], [1, 1, 1])
    assert res["DetectionBoxes_Recall/AR@1"] == pytest.approx(0.0)
    assert res["DetectionBoxes_Recall/AR@10"] == pytest.approx(1.0)
    assert res["DetectionBoxes_Recall/AR@100"] == pytest.approx(1.0)


def _dispatch():
    class _Options:
        oicr_iterations = 2

    class _Extractor:
        classes = ["cat", "dog"]

    class _Model:
        options = _Options()
        label_extractor = _Extractor()

    evs, cats = evaluator.build_detection_evaluators(_Model(),
                                                     evaluator_kind="coco")
    assert len(evs) == 3 and cats[1] == {"id": 2, "name": "dog"}
    assert all(isinstance(e, coco_eval.CocoDetectionEvaluator) for e in evs)
    evs, _ = evaluator.build_detection_evaluators(_Model())
    assert all(isinstance(e, voc_eval.PascalDetectionEvaluator) for e in evs)
    _, cats = evaluator.build_detection_evaluators(_Model(),
                                                   eval_coco_on_voc=True)
    assert len(cats) == 20 and cats[0] == {"id": 1, "name": "aeroplane"}
    with pytest.raises(ValueError):
        evaluator.build_detection_evaluators(_Model(), evaluator_kind="nope")


def _vectorized_match_equals_reference_loop():
    def reference_match(iou, gt_ignore):
        nth = len(coco_eval.IOU_THRESHOLDS)
        nd, ng = iou.shape
        matched = np.zeros((nth, nd), bool)
        ignored = np.zeros((nth, nd), bool)
        if nd == 0 or ng == 0:
            return matched, ignored
        order = np.argsort(gt_ignore, kind="stable")
        iou = iou[:, order]
        gt_ignore = gt_ignore[order]
        for ti, thr in enumerate(coco_eval.IOU_THRESHOLDS):
            taken = np.zeros(ng, bool)
            for d in range(nd):
                best, best_iou = -1, min(thr, 1.0 - 1e-10)
                for g in range(ng):
                    if taken[g]:
                        continue
                    if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                        break
                    if iou[d, g] < best_iou:
                        continue
                    best, best_iou = g, iou[d, g]
                if best > -1:
                    taken[best] = True
                    matched[ti, d] = True
                    ignored[ti, d] = gt_ignore[best]
        return matched, ignored

    rng = np.random.RandomState(0)
    for trial in range(50):
        nd, ng = rng.randint(0, 8), rng.randint(0, 6)
        iou = rng.randint(0, 12, (nd, ng)) / 10.0
        gt_ignore = rng.rand(ng) < 0.4
        got = coco_eval._match_cached(iou.copy(), gt_ignore.copy())
        want = reference_match(iou, gt_ignore)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg="trial %d" % trial)


CASES = {f.__name__.lstrip("_"): f for f in (
    _voc_perfect, _voc_fp_before_tp, _voc_duplicates_are_fp,
    _voc_difficult_ignored, _voc_no_detections_is_ap_zero,
    _voc_average_precision, _voc_coco_to_voc_remap, _coco_perfect,
    _coco_graded_iou, _coco_fp_above_tp, _coco_unmatched_gt_takes_the_match,
    _coco_area_splits, _coco_class_averaging, _coco_ar_at_k, _dispatch,
    _vectorized_match_equals_reference_loop)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_computed_metrics(case):
    CASES[case]()
