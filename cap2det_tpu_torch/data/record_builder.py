"""Shared TFRecord example assembly (the port's copy of
``cap2det_tpu/data/record_builder.py``).

Produces examples in the exact reference schema (TFExampleFields keys,
token-buffer caption framing, normalized [ymin,xmin,ymax,xmax] boxes) so
records are interchangeable with the TF implementation's data
(dataset-tools/create_*_tf_record.py).
"""

from __future__ import annotations

import numpy as np

from cap2det_tpu_torch.data import tf_example, tfrecord
from cap2det_tpu_torch.fields import TFExampleFields
from cap2det_tpu_torch.text.tokenize import pack_captions


def build_example(
    image_id,
    image_encoded=None,
    captions=(),
    object_boxes=None,
    object_texts=(),
    object_labels=(),
    proposal_boxes=None,
):
    """Builds the serialized tf.Example bytes.

    Args:
      image_id: str.
      image_encoded: encoded image bytes (PNG, JPEG) or None (text-only
        records).
      captions: list of pre-tokenized captions (token lists).
      object_boxes: [N, 4] normalized ymin,xmin,ymax,xmax.
      object_texts: N class-name strings.
      object_labels: N int labels (1-based).
      proposal_boxes: [P, 4] normalized boxes.
    """
    tokens, offsets, lengths = pack_captions(captions)
    object_boxes = (
        np.zeros((0, 4), np.float32)
        if object_boxes is None
        else np.asarray(object_boxes, np.float32).reshape(-1, 4)
    )
    proposal_boxes = (
        np.zeros((0, 4), np.float32)
        if proposal_boxes is None
        else np.asarray(proposal_boxes, np.float32).reshape(-1, 4)
    )

    feats = {
        TFExampleFields.image_id: ("bytes", [str(image_id).encode()]),
        TFExampleFields.caption_string: (
            "bytes",
            [t.encode() for t in tokens],
        ),
        TFExampleFields.caption_offset: ("int64", offsets),
        TFExampleFields.caption_length: ("int64", lengths),
        TFExampleFields.object_box_ymin: ("float", object_boxes[:, 0]),
        TFExampleFields.object_box_xmin: ("float", object_boxes[:, 1]),
        TFExampleFields.object_box_ymax: ("float", object_boxes[:, 2]),
        TFExampleFields.object_box_xmax: ("float", object_boxes[:, 3]),
        TFExampleFields.object_text: (
            "bytes",
            [t.encode() for t in object_texts],
        ),
        TFExampleFields.object_label: ("int64", list(object_labels)),
        TFExampleFields.proposal_box_ymin: ("float", proposal_boxes[:, 0]),
        TFExampleFields.proposal_box_xmin: ("float", proposal_boxes[:, 1]),
        TFExampleFields.proposal_box_ymax: ("float", proposal_boxes[:, 2]),
        TFExampleFields.proposal_box_xmax: ("float", proposal_boxes[:, 3]),
    }
    if image_encoded is not None:
        feats[TFExampleFields.image_encoded] = ("bytes", [image_encoded])
    return tf_example.encode_example(feats)


class ShardedWriter:
    """Round-robin sharded TFRecord writer (reference shards COCO train
    into 100 files etc., create_coco_tf_record.py:353-376)."""

    def __init__(self, path_template, num_shards):
        self._writers = [
            tfrecord.TFRecordWriter(
                path_template + "-%05d-of-%05d" % (i, num_shards)
            )
            for i in range(num_shards)
        ]
        self._count = 0

    def write(self, data):
        self._writers[self._count % len(self._writers)].write(data)
        self._count += 1

    def close(self):
        for w in self._writers:
            w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
