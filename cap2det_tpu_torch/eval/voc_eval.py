"""VOC-protocol detection evaluation: per-class AP, mAP, CorLoc (the
port's copy of ``cap2det_tpu/eval/voc_eval.py``, numpy only).

Replaces the object_detection ``PascalDetectionEvaluator`` the reference
drives in train/predict.py:367-415. Same conventions:

  * greedy per-image matching: detections sorted by score descending,
    each matched to the highest-IoU unmatched ground truth of the same
    class at IoU >= threshold (TP) else FP; difficult ground truths are
    excluded from both the positive count and matching penalties,
  * AP with the monotonic precision envelope over all recall points
    (VOC 2010+ / object_detection ``compute_average_precision``),
  * CorLoc: fraction of images containing a class whose top-scoring
    detection for that class hits a ground truth of that class.

Metric key names mirror the od evaluator so downstream report tooling is
drop-in compatible.
"""

from __future__ import annotations

import numpy as np


def compute_average_precision(precision, recall):
    """All-point interpolated AP (od utils/metrics.py semantics).

    Empty precision/recall (a class WITH ground truth but zero
    detections) is AP = 0, not NaN: recall is 0 everywhere, and NaN
    would silently drop the class from mAP, inflating it. (Found by the
    brute-force oracle in tests/test_eval_oracle.py.)
    """
    if precision is None:
        return float("nan")
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    # Monotonically decreasing envelope.
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def _iou_matrix(boxes1, boxes2):
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)), np.float32)
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    ih = np.maximum(
        np.minimum(b1[..., 2], b2[..., 2]) - np.maximum(b1[..., 0], b2[..., 0]), 0
    )
    iw = np.maximum(
        np.minimum(b1[..., 3], b2[..., 3]) - np.maximum(b1[..., 1], b2[..., 1]), 0
    )
    inter = ih * iw
    a1 = np.maximum(b1[..., 2] - b1[..., 0], 0) * np.maximum(
        b1[..., 3] - b1[..., 1], 0
    )
    a2 = np.maximum(b2[..., 2] - b2[..., 0], 0) * np.maximum(
        b2[..., 3] - b2[..., 1], 0
    )
    union = a1 + a2 - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class PascalDetectionEvaluator:
    """Streaming per-class AP/CorLoc evaluator.

    Args:
      categories: list of {'id': int (1-based), 'name': str}.
    """

    def __init__(self, categories, matching_iou_threshold=0.5,
                 metric_prefix="PascalBoxes"):
        self._categories = list(categories)
        self._iou_threshold = matching_iou_threshold
        self._prefix = metric_prefix
        self._class_ids = [c["id"] for c in self._categories]
        self._gt = {}  # image_id -> {class_id: (boxes, difficult)}
        self._det = {}  # image_id -> {class_id: (boxes, scores)}

    def clear(self):
        self._gt.clear()
        self._det.clear()

    def add_single_ground_truth_image_info(self, image_id, info):
        boxes = np.asarray(info["groundtruth_boxes"], np.float64).reshape(-1, 4)
        classes = np.asarray(info["groundtruth_classes"], np.int64).reshape(-1)
        difficult = info.get("groundtruth_difficult")
        difficult = (
            np.zeros(len(boxes), bool)
            if difficult is None
            else np.asarray(difficult, bool).reshape(-1)
        )
        per_class = {}
        for cid in np.unique(classes):
            sel = classes == cid
            per_class[int(cid)] = (boxes[sel], difficult[sel])
        self._gt[image_id] = per_class

    def add_single_detected_image_info(self, image_id, info):
        boxes = np.asarray(info["detection_boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(info["detection_scores"], np.float64).reshape(-1)
        classes = np.asarray(info["detection_classes"], np.int64).reshape(-1)
        per_class = {}
        for cid in np.unique(classes):
            sel = classes == cid
            per_class[int(cid)] = (boxes[sel], scores[sel])
        self._det[image_id] = per_class

    def _evaluate_class(self, cid):
        scores_all, tp_all = [], []
        num_gt = 0
        images_with_class = 0
        corloc_hits = 0
        image_ids = set(self._gt) | set(self._det)
        for image_id in image_ids:
            gt_boxes, gt_difficult = self._gt.get(image_id, {}).get(
                cid, (np.zeros((0, 4)), np.zeros(0, bool))
            )
            det_boxes, det_scores = self._det.get(image_id, {}).get(
                cid, (np.zeros((0, 4)), np.zeros(0))
            )
            num_easy = int((~gt_difficult).sum())
            num_gt += num_easy
            order = np.argsort(-det_scores, kind="stable")
            det_boxes, det_scores = det_boxes[order], det_scores[order]
            iou = _iou_matrix(det_boxes, gt_boxes)
            matched = np.zeros(len(gt_boxes), bool)
            tp = np.zeros(len(det_boxes), bool)
            ignore = np.zeros(len(det_boxes), bool)
            for d in range(len(det_boxes)):
                if len(gt_boxes) == 0:
                    continue
                best = int(np.argmax(iou[d]))
                if iou[d, best] >= self._iou_threshold:
                    if gt_difficult[best]:
                        ignore[d] = True
                    elif not matched[best]:
                        matched[best] = True
                        tp[d] = True
            keep = ~ignore
            scores_all.append(det_scores[keep])
            tp_all.append(tp[keep])

            if num_easy > 0:
                images_with_class += 1
                if len(det_boxes) and iou.shape[1] and (
                    iou[0].max() >= self._iou_threshold
                    and not gt_difficult[int(np.argmax(iou[0]))]
                ):
                    corloc_hits += 1

        if num_gt == 0:
            return float("nan"), float("nan")
        scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
        tp = np.concatenate(tp_all) if tp_all else np.zeros(0, bool)
        order = np.argsort(-scores, kind="stable")
        tp = tp[order]
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(~tp)
        recall = tp_cum / num_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        ap = compute_average_precision(precision, recall)
        corloc = corloc_hits / images_with_class if images_with_class else float("nan")
        return ap, corloc

    def evaluate(self):
        """Returns {metric_name: value} (od-compatible key names)."""
        results = {}
        aps, corlocs = [], []
        thr = int(round(self._iou_threshold * 100)) / 100
        for cat in self._categories:
            ap, corloc = self._evaluate_class(cat["id"])
            results[
                "%s_PerformanceByCategory/AP@%sIOU/%s"
                % (self._prefix, thr, cat["name"])
            ] = ap
            results[
                "%s_PerformanceByCategory/CorLoc@%sIOU/%s"
                % (self._prefix, thr, cat["name"])
            ] = corloc
            if not np.isnan(ap):
                aps.append(ap)
            if not np.isnan(corloc):
                corlocs.append(corloc)
        results["%s_Precision/mAP@%sIOU" % (self._prefix, thr)] = (
            float(np.mean(aps)) if aps else float("nan")
        )
        results["%s_Precision/meanCorLoc@%sIOU" % (self._prefix, thr)] = (
            float(np.mean(corlocs)) if corlocs else float("nan")
        )
        return results


COCO_TO_VOC = {
    5: 1, 2: 2, 15: 3, 9: 4, 40: 5, 6: 6, 3: 7, 16: 8, 57: 9, 20: 10,
    61: 11, 17: 12, 18: 13, 4: 14, 1: 15, 59: 16, 19: 17, 58: 18, 7: 19,
    63: 20,
}


def convert_coco_result_to_voc(boxes, scores, classes):
    """Keeps COCO detections whose class maps into VOC-20 and remaps ids
    (reference train/predict.py:284-325)."""
    keep, remapped = [], []
    for i, cls in enumerate(classes):
        if int(cls) in COCO_TO_VOC:
            keep.append(i)
            remapped.append(COCO_TO_VOC[int(cls)])
    if not keep:
        return (
            np.zeros((0, 4)),
            np.zeros((0,)),
            np.zeros((0,), dtype=np.int64),
        )
    keep = np.asarray(keep)
    return (
        np.asarray(boxes)[keep],
        np.asarray(scores)[keep],
        np.asarray(remapped, np.int64),
    )
