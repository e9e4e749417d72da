"""Box geometry in normalized [ymin, xmin, ymax, xmax] coordinates
(port of ``cap2det_tpu/ops/boxes.py``). All functions broadcast over
leading batch dims."""

from __future__ import annotations

import torch


def area(box):
    ymin, xmin, ymax, xmax = box.unbind(-1)
    return (xmax - xmin).clamp_min(0.0) * (ymax - ymin).clamp_min(0.0)


def intersect(box1, box2):
    ymin1, xmin1, ymax1, xmax1 = box1.unbind(-1)
    ymin2, xmin2, ymax2, xmax2 = box2.unbind(-1)
    return torch.stack(
        [
            torch.maximum(ymin1, ymin2),
            torch.maximum(xmin1, xmin2),
            torch.minimum(ymax1, ymax2),
            torch.minimum(xmax1, xmax2),
        ],
        dim=-1,
    )


def pairwise_iou(boxes1, boxes2):
    """IoU matrix between two box sets.

    Args:
      boxes1: [..., N, 4]
      boxes2: [..., M, 4]

    Returns:
      [..., N, M] IoU with a safe denominator (fully-empty pairs give 0).
    """
    ymin1, xmin1, ymax1, xmax1 = boxes1[..., :, None, :].unbind(-1)
    ymin2, xmin2, ymax2, xmax2 = boxes2[..., None, :, :].unbind(-1)
    ih = (torch.minimum(ymax1, ymax2) - torch.maximum(ymin1, ymin2)).clamp_min(0.0)
    iw = (torch.minimum(xmax1, xmax2) - torch.maximum(xmin1, xmin2)).clamp_min(0.0)
    inter = ih * iw
    a1 = (ymax1 - ymin1).clamp_min(0.0) * (xmax1 - xmin1).clamp_min(0.0)
    a2 = (ymax2 - ymin2).clamp_min(0.0) * (xmax2 - xmin2).clamp_min(0.0)
    union = a1 + a2 - inter
    return torch.where(
        union > 0, inter / union.clamp_min(1e-12), torch.zeros_like(union)
    )
