"""Input, prediction and detection key constants.

The port's own copy of the parts of ``cap2det_tpu/fields.py`` that serving
and the training step use. The string keys mirror the reference
(core/standard_fields.py:35-132), so the port's dicts stay name-compatible
with the JAX package's. The caption and object keys arrive with the data
slice.
"""


class InputFields:
    """Keys of a host training batch that the training step reads."""

    image = "image"
    proposals = "proposals"
    num_proposals = "number_of_proposals"
    # Image-level multi-hot labels, extracted on the host.
    pseudo_labels = "pseudo_labels"


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
