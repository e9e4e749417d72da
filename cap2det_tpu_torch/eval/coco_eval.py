"""COCO-protocol detection evaluation: mAP@[.5:.95], area splits, AR@k
(the port's copy of ``cap2det_tpu/eval/coco_eval.py``, numpy only).

Replaces the object_detection ``CocoDetectionEvaluator`` the reference
selects with ``--evaluator coco`` (train/predict.py:565-576). Pure numpy,
pycocotools semantics:

  * 10 IoU thresholds .50:.05:.95, 101-point interpolated precision,
  * per-(image, class) greedy matching: detections by descending score,
    each takes the highest-IoU *unmatched* ground truth above the
    threshold (unlike the VOC matcher, which fails a detection whose
    argmax ground truth was already taken),
  * area-range splits (small <32^2, medium <96^2, large) where
    out-of-range ground truths are ignored and detections matched to
    them (or unmatched with out-of-range area) don't count as FPs,
  * AP averaged over classes with ground truth; AR@{1,10,100} averaged
    over IoU thresholds.

Same streaming ``add_single_*`` interface as voc_eval so
``evaluator.run_evaluation`` can dispatch on a flag. Boxes are [ymin,
xmin, ymax, xmax]; pass absolute pixel coordinates so the area splits are
meaningful (with normalized boxes everything lands in "small" — IoU
metrics are still correct since IoU is scale-invariant).
"""

from __future__ import annotations

import numpy as np

from cap2det_tpu_torch.eval.voc_eval import _iou_matrix

IOU_THRESHOLDS = np.arange(0.5, 0.951, 0.05)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}
MAX_DETS = (1, 10, 100)


def _box_areas(boxes):
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    return np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0
    )


def _match_cached(iou, gt_ignore):
    """Per-image, per-class greedy matching for every IoU threshold.

    `iou` is the precomputed [D, G] matrix in score-descending det order;
    gts are re-sorted non-ignored-first per pycocotools. Returns
    (det_matched [T, D], det_ignore [T, D]).
    """
    nth = len(IOU_THRESHOLDS)
    nd, ng = iou.shape
    matched = np.zeros((nth, nd), bool)
    ignored = np.zeros((nth, nd), bool)
    if nd == 0 or ng == 0:
        return matched, ignored

    gt_order = np.argsort(gt_ignore, kind="stable")
    iou = iou[:, gt_order]
    gt_ignore = gt_ignore[gt_order]

    # Greedy over detections is inherently sequential, but each step is
    # vectorized across ALL thresholds and gts at once (pycocotools'
    # triple loop runs T*D*G python iterations; this runs D iterations of
    # [T, G] numpy ops). Semantics preserved exactly:
    #   * a detection takes the highest-IoU untaken gt with IoU >= thr,
    #   * ties go to the LATEST gt in non-ignored-first order (the
    #     reference loop's `<` keeps updating on equal IoU),
    #   * ignored gts are only eligible when NO non-ignored gt qualifies
    #     (the sorted-order break).
    thrs = np.minimum(IOU_THRESHOLDS, 1.0 - 1e-10)[:, None]  # [T, 1]
    taken = np.zeros((nth, ng), bool)
    for d in range(nd):
        qualifies = ~taken & (iou[d][None, :] >= thrs)  # [T, G]
        cand_real = qualifies & ~gt_ignore[None, :]
        cand_ign = qualifies & gt_ignore[None, :]
        use_real = cand_real.any(axis=1)  # [T]
        cand = np.where(use_real[:, None], cand_real, cand_ign)
        any_cand = cand.any(axis=1)
        vals = np.where(cand, iou[d][None, :], -1.0)
        best = ng - 1 - np.argmax(vals[:, ::-1], axis=1)  # last argmax
        rows = np.nonzero(any_cand)[0]
        taken[rows, best[rows]] = True
        matched[:, d] = any_cand
        ignored[rows, d] = gt_ignore[best[rows]]
    return matched, ignored


class CocoDetectionEvaluator:
    """Streaming COCO-style evaluator (od-compatible metric key names)."""

    def __init__(self, categories, metric_prefix="DetectionBoxes"):
        self._categories = list(categories)
        self._prefix = metric_prefix
        self._gt = {}  # image_id -> {cid: boxes}
        self._det = {}  # image_id -> {cid: (boxes, scores)}

    def clear(self):
        self._gt.clear()
        self._det.clear()

    def add_single_ground_truth_image_info(self, image_id, info):
        boxes = np.asarray(info["groundtruth_boxes"], np.float64).reshape(-1, 4)
        classes = np.asarray(info["groundtruth_classes"], np.int64).reshape(-1)
        per_class = {}
        for cid in np.unique(classes):
            per_class[int(cid)] = boxes[classes == cid]
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

    def _class_cache(self, cid):
        """Per-(image, class) detections/gt with the IoU matrix computed
        ONCE — shared across all 4 area ranges and every maxDet (the
        score order never changes, and the top-k matching for AR@k is
        exactly the first-k columns of the maxDet-100 matching: greedy
        matches of earlier detections are unaffected by later ones)."""
        cache = []
        for image_id in sorted(set(self._gt) | set(self._det), key=str):
            gt_boxes = self._gt.get(image_id, {}).get(cid)
            det = self._det.get(image_id, {}).get(cid)
            if gt_boxes is None and det is None:
                continue
            gt_boxes = np.zeros((0, 4)) if gt_boxes is None else gt_boxes
            det_boxes, det_scores = det if det is not None else (
                np.zeros((0, 4)), np.zeros(0)
            )
            order = np.argsort(-det_scores, kind="stable")[:max(MAX_DETS)]
            det_boxes = det_boxes[order]
            cache.append({
                "gt_boxes": gt_boxes,
                "gt_area": _box_areas(gt_boxes),
                "scores": det_scores[order],
                "det_area": _box_areas(det_boxes),
                "iou": _iou_matrix(det_boxes, gt_boxes),
            })
        return cache

    @staticmethod
    def _accumulate_range(cache, area_range):
        """One matching pass over the class cache for an area range.

        Returns (per-image scores/matched/ignored lists, num_gt) or None
        if the range has no ground truth.
        """
        lo, hi = AREA_RANGES[area_range]
        scores_l, matched_l, ignored_l = [], [], []
        num_gt = 0
        for e in cache:
            gt_ignore = (e["gt_area"] < lo) | (e["gt_area"] > hi)
            num_gt += int((~gt_ignore).sum())
            matched, ignored = _match_cached(e["iou"], gt_ignore)
            out_of_range = (e["det_area"] < lo) | (e["det_area"] > hi)
            ignored = ignored | (~matched & out_of_range[None, :])
            scores_l.append(e["scores"])
            matched_l.append(matched)
            ignored_l.append(ignored)
        if num_gt == 0:
            return None
        return scores_l, matched_l, ignored_l, num_gt

    @staticmethod
    def _pr_curves(scores_l, matched_l, ignored_l, num_gt, max_det):
        """(precision [T, R], recall [T]) from per-image match results,
        truncated to the top-`max_det` detections per image."""
        nth = len(IOU_THRESHOLDS)
        scores = (
            np.concatenate([s[:max_det] for s in scores_l])
            if scores_l else np.zeros(0)
        )
        matched = (
            np.concatenate([m[:, :max_det] for m in matched_l], axis=1)
            if matched_l else np.zeros((nth, 0), bool)
        )
        ignored = (
            np.concatenate([i[:, :max_det] for i in ignored_l], axis=1)
            if ignored_l else np.zeros((nth, 0), bool)
        )
        order = np.argsort(-scores, kind="stable")
        matched = matched[:, order]
        ignored = ignored[:, order]

        precision = np.zeros((nth, len(RECALL_THRESHOLDS)))
        recall = np.zeros(nth)
        for ti in range(nth):
            keep = ~ignored[ti]
            tp = np.cumsum(matched[ti][keep])
            fp = np.cumsum(~matched[ti][keep])
            rc = tp / num_gt
            pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            recall[ti] = rc[-1] if len(rc) else 0.0
            # Monotone envelope then sample at the 101 recall points.
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
            precision[ti] = np.where(
                inds < len(pr), pr[np.minimum(inds, max(len(pr) - 1, 0))], 0.0
            ) if len(pr) else 0.0
        return precision, recall

    def evaluate(self):
        """Returns {metric_name: value} (od CocoDetectionEvaluator names)."""
        ap_acc = {rng: [] for rng in AREA_RANGES}
        ap50, ap75 = [], []
        ar_acc = {k: [] for k in MAX_DETS}
        ar_area = {rng: [] for rng in ("small", "medium", "large")}
        for cat in self._categories:
            cache = self._class_cache(cat["id"])
            for rng in AREA_RANGES:
                out = self._accumulate_range(cache, rng)
                if out is None:
                    continue
                scores_l, matched_l, ignored_l, num_gt = out
                precision, recall = self._pr_curves(
                    scores_l, matched_l, ignored_l, num_gt, 100
                )
                ap_acc[rng].append(precision.mean())
                if rng == "all":
                    ap50.append(precision[0].mean())
                    ap75.append(precision[5].mean())
                    ar_acc[100].append(recall.mean())
                    for k in (1, 10):
                        _, rk = self._pr_curves(
                            scores_l, matched_l, ignored_l, num_gt, k
                        )
                        ar_acc[k].append(rk.mean())
                else:
                    ar_area[rng].append(recall.mean())

        def mean(vals):
            return float(np.mean(vals)) if vals else float("nan")

        p = self._prefix
        return {
            "%s_Precision/mAP" % p: mean(ap_acc["all"]),
            "%s_Precision/mAP@.50IOU" % p: mean(ap50),
            "%s_Precision/mAP@.75IOU" % p: mean(ap75),
            "%s_Precision/mAP (small)" % p: mean(ap_acc["small"]),
            "%s_Precision/mAP (medium)" % p: mean(ap_acc["medium"]),
            "%s_Precision/mAP (large)" % p: mean(ap_acc["large"]),
            "%s_Recall/AR@1" % p: mean(ar_acc[1]),
            "%s_Recall/AR@10" % p: mean(ar_acc[10]),
            "%s_Recall/AR@100" % p: mean(ar_acc[100]),
            "%s_Recall/AR@100 (small)" % p: mean(ar_area["small"]),
            "%s_Recall/AR@100 (medium)" % p: mean(ar_area["medium"]),
            "%s_Recall/AR@100 (large)" % p: mean(ar_area["large"]),
        }
