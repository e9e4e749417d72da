"""HTML evaluation gallery: ground truth vs detections, captions, labels
(port of ``cap2det_tpu/eval/html_report.py``, without cv2).

Reimplements the reference visualization report (train/predict.py:131-281
with drawing helpers from core/plotlib.py): each row shows the image with
ground-truth boxes, per-iteration detections, the captions, and the
extracted pseudo labels; detections that match a ground truth are
highlighted.

Boxes are drawn with numpy at the JAX package's integer corners and
thickness (``utils/visualize.py``), labels with Pillow's default font,
the 400-pixel downscale with ``pipeline.resize_bilinear_u8`` (cv2's
INTER_LINEAR bit for bit) and the JPEGs with Pillow at cv2's default
quality. The table, its rows and escaping are the JAX package's; the
label pixels are Pillow's, not cv2's Hershey font.
"""

from __future__ import annotations

import html as html_lib

import numpy as np
import torch

from cap2det_tpu_torch.data import pipeline as pipeline_lib
from cap2det_tpu_torch.fields import DetectionFields
from cap2det_tpu_torch.ops import boxes as box_ops
from cap2det_tpu_torch.utils import visualize

_GT_COLOR = (46, 204, 64)
_DET_COLOR = (255, 65, 54)
_HIT_COLOR = (255, 220, 0)
_JPEG_QUALITY = 95  # cv2.imencode's default


def _draw_boxes(image, boxes, labels, color):
    return visualize.draw_rectangles(image, boxes, labels, color=color,
                                     thickness=2)


class HTMLReport:
    def __init__(self, class_names, max_examples=50, score_threshold=0.05):
        self._class_names = list(class_names)
        self._max = max_examples
        self._thr = score_threshold
        self._rows = []

    def _name(self, class_id_1based):
        idx = int(class_id_1based) - 1
        if 0 <= idx < len(self._class_names):
            return self._class_names[idx]
        return str(class_id_1based)

    def add_example(self, example, result, iteration):
        if len(self._rows) >= self._max:
            return
        image = pipeline_lib.decode_jpeg(example["image_encoded"])
        scale = 400.0 / max(image.shape[:2])
        if scale < 1.0:
            image = pipeline_lib.resize_bilinear_u8(
                torch.from_numpy(image), int(image.shape[0] * scale),
                int(image.shape[1] * scale)).numpy()

        suffix = "_at_%d" % iteration
        n = int(result[DetectionFields.num_detections + suffix])
        det_boxes = np.asarray(result[DetectionFields.detection_boxes + suffix][:n])
        det_scores = np.asarray(result[DetectionFields.detection_scores + suffix][:n])
        det_classes = np.asarray(
            result[DetectionFields.detection_classes + suffix][:n]
        )
        keep = det_scores >= self._thr
        det_boxes, det_scores, det_classes = (
            det_boxes[keep], det_scores[keep], det_classes[keep],
        )

        gt_boxes = np.asarray(example["object_boxes"], np.float32).reshape(-1, 4)
        gt_labels = example["object_texts"]

        gt_ids = np.array(
            [self._class_names.index(t) + 1 if t in self._class_names else -1
             for t in gt_labels]
        )
        _, precision_mask = box_ops.evaluate_precision_and_recall(
            len(gt_boxes), gt_boxes, gt_ids, len(det_boxes), det_boxes,
            det_classes.astype(np.int64),
        )

        gt_img = _draw_boxes(image, gt_boxes, gt_labels, _GT_COLOR)
        det_img = image.copy()
        for i in range(len(det_boxes)):
            color = _HIT_COLOR if precision_mask[i] else _DET_COLOR
            det_img = _draw_boxes(
                det_img,
                det_boxes[i : i + 1],
                ["%s:%.2f" % (self._name(det_classes[i]), det_scores[i])],
                color,
            )

        captions = " / ".join(" ".join(c) for c in example.get("captions", []))
        self._rows.append(
            "<tr><td>%s</td>"
            '<td><img src="data:image/jpeg;base64,%s"></td>'
            '<td><img src="data:image/jpeg;base64,%s"></td>'
            "<td>%s</td></tr>"
            % (
                html_lib.escape(str(example["image_id"])),
                visualize.to_base64_jpeg(gt_img, _JPEG_QUALITY),
                visualize.to_base64_jpeg(det_img, _JPEG_QUALITY),
                html_lib.escape(captions),
            )
        )

    def write(self, path):
        with open(path, "w") as fid:
            fid.write(
                "<html><body><table border=1>"
                "<tr><th>image_id</th><th>groundtruth</th>"
                "<th>detections</th><th>captions</th></tr>"
            )
            fid.writelines(self._rows)
            fid.write("</table></body></html>")
