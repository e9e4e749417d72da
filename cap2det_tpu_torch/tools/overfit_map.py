"""End-to-end detection quality: overfit a synthetic set, then evaluate it
(the port's counterpart of ``tests/test_e2e_map.py::
test_overfit_synthetic_detection_map``).

passthrough warm start (``utils/passthrough_init.py``, saved with
``checkpoint.save_params``) -> ``train()`` from PNG TFRecords -> the
checkpoint -> ``continuous_evaluation`` -> multi-scale prediction (two
eval_min_dimensions) -> per-iteration NMS -> VOC mAP -> best-checkpoint
promotion. The pipeline text, records (16 ``make_localizable_example``s,
128x160, 7 distractors, seed 11) and the warm start are the JAX test's.
Both backbone scopes train with gradient multiplier 0, so only the heads
learn.

    python -m cap2det_tpu_torch.tools.overfit_map [--device cuda]

prints the losses' first and last values, the mAP per OICR iteration,
the best step and the wall time, and exits nonzero unless the last loss
is below 0.3x the first and the final mAP is at least 0.5 at step 300.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

CLASSES = ["redthing", "greenthing"]
STEPS = 300
MIN_MAP = 0.5
LOSS_DROP = 0.3

PIPELINE = """
train_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: true
    shuffle_buffer_size: 16
    batch_size: 8
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 96 } }
    preprocess_options { random_flip_left_right_prob: 0.5 }
    max_num_proposals: 8
    batch_resize_scale_value: 1.0
  }
}
eval_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: false
    batch_size: 1
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 96 } }
    max_num_proposals: 8
  }
}
model {
  [Cap2DetModel.ext] {
    midn_loss_weight: 1.0
    oicr_loss_weight: 0.5
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6
      maxpool_kernel_size: 2
      maxpool_stride: 2
      dropout_keep_prob: 1.0
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      regularizer { l2_regularizer { weight: 0.000001 } }
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 1
    oicr_iou_threshold: 0.6
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 5 max_total_size: 10
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 5 max_total_size: 10
    }
    eval_min_dimension: 96
    eval_min_dimension: 128
    label_extractor { groundtruth_extractor { label_file: '%(label_file)s' } }
  }
}
train_config {
  max_steps: 300
  learning_rate: 0.05
  optimizer { adagrad {} }
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier { scope: 'second_stage_feature_extraction' multiplier: 0.0 }
  save_checkpoints_steps: 300
  keep_checkpoint_max: 2
  log_step_count_steps: 100
}
eval_config { steps: 16 }
"""


def write_inputs(directory):
    """The JAX test's 16 records (PNG here) and label file; returns the
    pipeline config."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import synthetic, tfrecord

    record = os.path.join(directory, "train.record")
    rng = np.random.default_rng(11)
    with tfrecord.TFRecordWriter(record) as w:
        for i in range(16):
            w.write(synthetic.make_localizable_example(
                rng, "loc-%05d" % i, CLASSES, image_hw=(128, 160),
                num_distractors=7))
    label_file = synthetic.write_label_file(
        os.path.join(directory, "labels.txt"), CLASSES)
    return schema.loads_pipeline(
        PIPELINE % {"record": record, "label_file": label_file})


def write_warm_start(cfg, path, device):
    """The passthrough backbone of the model's seed-0 init, saved in the
    port's pretrained-checkpoint format."""
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.models import frcnn, registry
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib
    from cap2det_tpu_torch.utils.passthrough_init import make_passthrough

    model = registry.build(cfg.model, is_training=True, device=device)
    tree = model.init_jax_numpy(0)
    iv2 = {}
    iv2.update(make_passthrough(tree[frcnn.FIRST_SCOPE]["InceptionV2"]))
    iv2.update(make_passthrough(tree[frcnn.SECOND_SCOPE]["InceptionV2"]))
    ckpt_lib.save_params(path, params_lib.from_jax_numpy(
        {"InceptionV2": iv2}, "cpu"))
    return path


def run(directory, device="cuda", hooks=()):
    """Trains and evaluates in `directory`. Returns {"losses", "best",
    "map_per_iter", "saved_info", "train_s", "eval_s"}."""
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)
    from cap2det_tpu_torch.eval import evaluator
    from cap2det_tpu_torch.train import trainer

    cfg = write_inputs(directory)
    pre_path = write_warm_start(cfg, os.path.join(directory, "passthrough.pt"),
                                device)
    model_dir = os.path.join(directory, "model")
    losses = []
    t0 = time.perf_counter()
    trainer.train(cfg, model_dir=model_dir, pretrained_checkpoint=pre_path,
                  device=device, hooks=[lambda s, st, logs: losses.append(
                      float(logs["loss/total_loss"]))] + list(hooks))
    t1 = time.perf_counter()
    best = evaluator.continuous_evaluation(
        cfg, model_dir=model_dir, max_eval_examples=16, max_idle_polls=0,
        device=device)
    t2 = time.perf_counter()
    with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
        row = json.loads(f.readlines()[-1])
    map_per_iter = [row["iter%d/PascalBoxes_Precision/mAP@0.5IOU" % i]
                    for i in range(1 + cfg.model.cap2det_model.oicr_iterations)]
    saved_info = os.path.join(model_dir, "saved_ckpts", "saved_info.txt")
    return {"losses": losses, "best": best, "map_per_iter": map_per_iter,
            "saved_info": saved_info if os.path.exists(saved_info) else None,
            "train_s": t1 - t0, "eval_s": t2 - t1}


def check(result):
    """Raises unless the run overfit as the JAX test requires."""
    losses, best = result["losses"], result["best"]
    if not losses[-1] < LOSS_DROP * losses[0]:
        raise AssertionError("loss fell from %r to %r only"
                             % (losses[0], losses[-1]))
    if best is None or best[0] != STEPS or not best[1] >= MIN_MAP:
        raise AssertionError("best checkpoint %r, expected (%d, >= %g)"
                             % (best, STEPS, MIN_MAP))
    if result["saved_info"] is None:
        raise AssertionError("no saved_ckpts/saved_info.txt")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu.")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="overfit_map_") as tmp:
        result = run(tmp, device=args.device)
    print(json.dumps({k: v for k, v in result.items() if k != "losses"}
                     | {"first_loss": result["losses"][0],
                        "last_loss": result["losses"][-1],
                        "steps": len(result["losses"])}))
    check(result)


if __name__ == "__main__":
    main()
