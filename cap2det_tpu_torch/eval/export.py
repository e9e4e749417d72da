"""Detection result exporter: final-iteration detections per image -> JSON
(port of ``cap2det_tpu/eval/export.py``).

Replaces train/export_results.py:69-138 (its stale twin train/export.py is
deliberately not reproduced — it imports modules that do not exist in the
reference).
"""

from __future__ import annotations

import json

import numpy as np

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline as pipeline_lib
from cap2det_tpu_torch.eval.evaluator import MultiScalePredictor
from cap2det_tpu_torch.fields import DetectionFields
from cap2det_tpu_torch.models import registry


def export_results(
    pipeline_config: schema.Pipeline,
    params,
    output_path,
    model=None,
    max_examples=None,
    iteration=None,
    device="cuda",
):
    """Writes {image_id: {detection_boxes, detection_scores,
    detection_classes}} for the chosen OICR iteration (default: last).
    `params` are port tensors on the model's device; without `model`, one
    is built on `device`."""
    if model is None:
        model = registry.build(pipeline_config.model, is_training=False,
                               device=device)
    if iteration is None:
        iteration = model.options.oicr_iterations
    reader_cfg = pipeline_config.eval_reader.cap2det_reader
    pipe = pipeline_lib.InputPipeline(reader_cfg, prefetch=0)
    predictor = MultiScalePredictor(model, params, reader_cfg)

    results = {}
    exported = 0
    for example in pipe.example_stream():
        if example.get("image_encoded") is None:
            continue
        result = predictor.predict(example)
        suffix = "_at_%d" % iteration
        n = int(result[DetectionFields.num_detections + suffix])
        results[result["image_id"]] = {
            "detection_boxes": np.asarray(
                result[DetectionFields.detection_boxes + suffix][:n]
            ).tolist(),
            "detection_scores": np.asarray(
                result[DetectionFields.detection_scores + suffix][:n]
            ).tolist(),
            "detection_classes": np.asarray(
                result[DetectionFields.detection_classes + suffix][:n]
            ).tolist(),
        }
        exported += 1  # count exported results, not skipped records
        if max_examples and exported >= max_examples:
            break
    with open(output_path, "w") as fid:
        json.dump(results, fid)
    return results
