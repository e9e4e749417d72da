"""Batched class-wise non-max suppression (port of ``cap2det_tpu/ops/nms.py``).

Class-agnostic proposal boxes scored per class, greedy per-class
suppression, per-class cap, global top-``max_total_size`` merge, and
1-based returned class ids. The semantics are the JAX op's:

- boxes are visited per class in stable descending score order;
- a box is a candidate only if its score is strictly above the threshold;
- the per-class cap is applied after suppression;
- the global top-k breaks ties by the lower flat (box, class) index, as
  ``lax.top_k`` does, through a stable sort.

The greedy pass is ``kernels/nms.nms_mask``: on the card one launch of
``csrc/nms.cu`` per call for every image and class, as JAX runs it as one
``lax.fori_loop`` inside its compiled postprocess; on the CPU
``_per_image_nms`` below, the kernel's plain version and oracle.
"""

from __future__ import annotations

import torch

from cap2det_tpu_torch.kernels import nms as nms_kernel
from cap2det_tpu_torch.ops import boxes as box_ops
from cap2det_tpu_torch.utils.spans import span


def _per_image_nms(boxes, scores, iou_thresh, score_thresh, max_per_class):
    """Greedy NMS for one image: boxes [P, 4], scores [P, C] -> [P, C]
    bool mask of surviving (box, class) pairs."""
    num_p, _ = scores.shape
    iou = box_ops.pairwise_iou(boxes, boxes)  # [P, P]
    order = torch.argsort(-scores.T, dim=-1, stable=True)  # [C, P]
    # In each class's score order: candidates, and which later box each
    # box would suppress (strictly later ranks only).
    keep = torch.gather(scores.T > score_thresh, 1, order)  # [C, P]
    overlap = iou[order[:, :, None], order[:, None, :]] > iou_thresh
    overlap &= torch.ones(
        num_p, num_p, dtype=torch.bool, device=boxes.device
    ).triu_(1)
    for i in range(num_p):
        keep &= ~(overlap[:, i, :] & keep[:, i:i + 1])
    keep &= torch.cumsum(keep, dim=1) <= max_per_class
    out = torch.zeros_like(keep)
    out.scatter_(1, order, keep)
    return out.T


def batch_multiclass_nms(
    boxes,
    scores,
    score_thresh=1e-6,
    iou_thresh=0.5,
    max_size_per_class=100,
    max_total_size=300,
):
    """Batched class-wise NMS.

    Args:
      boxes: [B, P, 4] normalized class-agnostic boxes.
      scores: [B, P, C] per-class scores (no background column).

    Returns:
      num_detections: [B] int32.
      detection_boxes: [B, max_total_size, 4].
      detection_scores: [B, max_total_size].
      detection_classes: [B, max_total_size] float, **1-based** class ids.
    """
    with span("cap2det/postprocess/nms"):
        selected = nms_kernel.nms_mask(boxes, scores, score_thresh,
                                       iou_thresh,
                                       max_size_per_class)  # [B, P, C]
        return merge_detections(boxes, scores, selected, max_total_size)


def merge_detections(boxes, scores, selected, max_total_size):
    """The global top-``max_total_size`` of the selected (box, class)
    pairs of each image, as ``batch_multiclass_nms`` returns them."""
    num_b, num_p, num_c = scores.shape
    neg_inf = torch.tensor(-float("inf"), dtype=scores.dtype,
                           device=scores.device)
    flat_scores = torch.where(selected, scores, neg_inf).reshape(num_b, -1)
    k = min(max_total_size, num_p * num_c)
    sorted_scores, sorted_idx = torch.sort(
        flat_scores, dim=-1, descending=True, stable=True
    )
    top_scores, top_idx = sorted_scores[:, :k], sorted_idx[:, :k]

    box_idx = top_idx // num_c
    class_idx = top_idx % num_c
    det_boxes = torch.gather(boxes, 1, box_idx[..., None].expand(-1, -1, 4))
    valid = torch.isfinite(top_scores)
    det_scores = torch.where(valid, top_scores, 0.0)
    det_classes = torch.where(valid, class_idx.to(scores.dtype) + 1.0, 0.0)
    det_boxes = torch.where(valid[..., None], det_boxes, 0.0)
    num_detections = valid.sum(dim=-1).to(torch.int32)

    pad = max_total_size - k
    if pad:
        det_boxes = torch.nn.functional.pad(det_boxes, (0, 0, 0, pad))
        det_scores = torch.nn.functional.pad(det_scores, (0, pad))
        det_classes = torch.nn.functional.pad(det_classes, (0, pad))
    return num_detections, det_boxes, det_scores, det_classes


def build_post_processor(options):
    """Factory from a PostProcess config: fn(boxes [B,P,4], scores [B,P,C])
    -> (num_detections, boxes, scores, classes_1based)."""

    def post_process(boxes, scores):
        return batch_multiclass_nms(
            boxes,
            scores,
            score_thresh=options.score_thresh,
            iou_thresh=options.iou_thresh,
            max_size_per_class=options.max_size_per_class,
            max_total_size=options.max_total_size,
        )

    return post_process
