"""Prediction and detection key constants.

The port's own copy of the serving part of ``cap2det_tpu/fields.py``. The
string keys mirror the reference (core/standard_fields.py:35-132), so the
port's prediction and detection dicts stay name-compatible with the JAX
package's. The reader-side keys arrive with the data slice.
"""


class DetectionFields:
    """Keys of the prediction/detection dict."""

    num_proposals = "num_proposals"
    proposal_boxes = "proposal_boxes"
    proposal_scores = "proposal_scores"

    class_labels = "class_labels"

    num_detections = "num_detections"
    detection_boxes = "detection_boxes"
    detection_scores = "detection_scores"
    detection_classes = "detection_classes"


class Cap2DetPredictions:
    midn_class_logits = "midn_class_logits"
    midn_proba_r_given_c = "midn_proba_r_given_c"
    oicr_proposal_scores = "oicr_proposal_scores"
