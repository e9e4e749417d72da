"""Record, input, prediction and detection key constants.

The port's own copy of ``cap2det_tpu/fields.py``. The string keys mirror
the reference (core/standard_fields.py:35-132), so TFRecord data written
for the TF implementation feeds the port unchanged and the port's dicts
stay name-compatible with the JAX package's.
"""


class TFExampleFields:
    """Feature keys inside the serialized tf.Example records."""

    image_id = "image/source_id"
    image_encoded = "image/encoded"

    caption_string = "image/caption/string"
    caption_offset = "image/caption/offset"
    caption_length = "image/caption/length"

    number_of_proposals = "image/proposal/num_proposals"
    proposal_box = "image/proposal/bbox"
    proposal_box_ymin = "image/proposal/bbox/ymin"
    proposal_box_xmin = "image/proposal/bbox/xmin"
    proposal_box_ymax = "image/proposal/bbox/ymax"
    proposal_box_xmax = "image/proposal/bbox/xmax"

    object_box = "image/object/bbox"
    object_text = "image/object/class/text"
    object_label = "image/object/class/label"

    object_box_ymin = "image/object/bbox/ymin"
    object_box_xmin = "image/object/bbox/xmin"
    object_box_ymax = "image/object/bbox/ymax"
    object_box_xmax = "image/object/bbox/xmax"


class InputFields:
    """Keys of the per-batch input dict the input pipeline makes."""

    image = "image"
    image_id = "image_id"
    image_shape = "image_shape"

    num_captions = "num_captions"
    caption_strings = "caption_strings"
    caption_lengths = "caption_lengths"

    # Host-side token ids of the concatenated captions (the input
    # pipeline looks the strings up; no strings reach the device).
    concat_caption_token_ids = "concat_caption_token_ids"

    num_objects = "number_of_objects"
    object_boxes = "object_boxes"
    object_texts = "object_texts"

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
