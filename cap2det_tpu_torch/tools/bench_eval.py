"""Eval-daemon wall time at paper shapes: seconds per example, per
checkpoint, and per scale on the card (port of ``tools/bench_eval.py``).

The continuous evaluator (``eval/evaluator.py``) runs multi-scale batch-1
prediction on every example of every checkpoint. If one checkpoint's
evaluation takes longer than the trainer needs for
``save_checkpoints_steps``, the daemon skips checkpoints and the best
checkpoint is chosen from fewer. This tool measures that time on the
card at configs/voc07_inc2.pbtxt's eval shapes (20 VOC classes, 2000
proposals, 4 scales, 3 OICR iterations, seeded random weights) and
extrapolates to the VOC07 test set (4952 images).

Prints three JSON lines with the JAX tool's metrics:
``eval_seconds_per_example_multiscale`` (the host clock around each
``predict``, between synchronisations; with the NMS share of it, the
host clock around ``Cap2DetModel.postprocess``, and the kernel launches),
``eval_seconds_per_checkpoint_voc07_test_extrapolated`` (with one whole
``run_evaluation`` pass over the examples: predict, metrics, AP) and
``eval_device_forward_seconds_per_scale`` (the forward at the largest
canvas on a batch already on the card, by CUDA events). Each line
carries the card's name and power limit.

    python -m cap2det_tpu_torch.tools.bench_eval [--examples 8]
        [--proposals 2000] [--min_dims 1200,800,600,400]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from cap2det_tpu_torch import kernels
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.tools import benchlib

VOC07_TEST_IMAGES = 4952
IMAGE_HW = (480, 640)  # VOC-like sources; the predictor rescales them
FORWARD_ITERS, FORWARD_ROUNDS = 6, 3

_CONFIG = """
eval_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: false
    batch_size: 1
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 1000 } }
    max_num_proposals: %(proposals)d
  }
}
model {
  [Cap2DetModel.ext] {
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 14
      maxpool_kernel_size: 2
      maxpool_stride: 2
      dropout_keep_prob: 1.0
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 3
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 100 max_total_size: 300
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 100 max_total_size: 300
    }
    %(min_dim_lines)s
    label_extractor {
      groundtruth_extractor { label_file: '%(label_file)s' }
    }
  }
}
"""


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--examples", type=int, default=8)
    parser.add_argument("--proposals", type=int, default=2000)
    parser.add_argument(
        "--min_dims", default="1200,800,600,400",
        help="eval_min_dimension multi-scale set (voc07_inc2's)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.data import synthetic
    from cap2det_tpu_torch.eval import evaluator
    from cap2det_tpu_torch.models import registry
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    device = params_lib.resolve_device(args.device)
    cuda = device.type == "cuda"
    fields = benchlib.device_fields(device)
    min_dims = [int(d) for d in args.min_dims.split(",")]
    with tempfile.TemporaryDirectory(prefix="bench_eval_") as work:
        classes = list(synthetic.VOC_CLASSES)
        record = os.path.join(work, "eval.record")
        synthetic.write_synthetic_dataset(
            record, num_examples=args.examples, seed=3, classes=classes,
            image_hw=IMAGE_HW, num_proposals=args.proposals)
        label_file = synthetic.write_label_file(
            os.path.join(work, "labels.txt"), classes)
        cfg = schema.loads_pipeline(_CONFIG % {
            "record": record, "proposals": args.proposals,
            "label_file": label_file,
            "min_dim_lines": "\n".join("eval_min_dimension: %d" % d
                                       for d in min_dims)})
        model = registry.build(cfg.model, is_training=False, device=device)
        params = model.init_params(0)
        reader_cfg = cfg.eval_reader.cap2det_reader
        predictor = evaluator.MultiScalePredictor(model, params, reader_cfg)
        examples = list(pipeline_lib.InputPipeline(
            reader_cfg, prefetch=0).example_stream())

        # The host clock around predict and around its postprocess (NMS),
        # each between synchronisations.
        nms_s = []
        real_post = model.postprocess

        def postprocess(*a, **kw):
            benchlib.synchronize(device)
            t0 = time.perf_counter()
            out = real_post(*a, **kw)
            benchlib.synchronize(device)
            nms_s.append(time.perf_counter() - t0)
            return out

        def timed_predict(example):
            benchlib.synchronize(device)
            t0 = time.perf_counter()
            predictor.predict(example)
            benchlib.synchronize(device)
            return time.perf_counter() - t0

        model.postprocess = postprocess
        try:
            first_s = timed_predict(examples[0])  # lazy set-up, autotuning
            nms_s.clear()
            before = kernels.launch_counts()
            predict_s = [timed_predict(ex) for ex in examples[1:]]
            after = kernels.launch_counts()
        finally:
            del model.postprocess
        n = len(predict_s)
        launches = {k: after[k] - before[k] for k in after}
        want = dict.fromkeys(launches, 0)
        want.update(roi_crop_maxpool=n * len(min_dims),
                    pool_fwd=3 * n * len(min_dims),
                    nms=n * (1 + model.options.oicr_iterations))
        if cuda and launches != want:
            raise AssertionError("bench_eval: launches %s, expected %s"
                                 % (launches, want))
        per_example = sum(predict_s) / max(n, 1)

        # The forward of one scale, the largest, on a batch on the card.
        img = pipeline_lib.decode_jpeg(examples[0]["image_encoded"])
        short, long_ = pipeline_lib.compute_canvas(max(min_dims), 1.0, 1.5,
                                                   32)
        canvas, _ = pipeline_lib.fit_image_to_canvas(
            torch.as_tensor(img, device=device), (short, long_))
        batch = {
            "image": canvas[None],
            "proposals": torch.zeros((1, args.proposals, 4), device=device),
            "num_proposals": torch.tensor([args.proposals],
                                          dtype=torch.int32, device=device),
        }
        with torch.no_grad():
            prepared = model.prepare(params)

        def forward():
            with torch.inference_mode():
                return model.predictions(prepared, batch)

        forward_t = benchlib.time_rounds(forward, device, FORWARD_ITERS,
                                         FORWARD_ROUNDS)
        per_scale = forward_t["ms"] / 1e3

        # A whole pass: predict, metrics and AP over every example.
        t0 = time.perf_counter()
        evaluator.run_evaluation(cfg, params, model=model,
                                 predictor=predictor)
        benchlib.synchronize(device)
        full_pass = time.perf_counter() - t0

    lines = [
        {"metric": "eval_seconds_per_example_multiscale",
         "value": per_example, "min_dims": min_dims,
         "proposals": args.proposals,
         "first_example_incl_warmup_s": first_s,
         "examples_measured": n, "seconds_per_example": predict_s,
         "nms_seconds_per_example": sum(nms_s) / max(n, 1),
         "nms_share": sum(nms_s) / sum(predict_s) if n else None,
         "launches": launches},
        {"metric": "eval_seconds_per_checkpoint_voc07_test_extrapolated",
         "value": per_example * VOC07_TEST_IMAGES,
         "full_pass_s": full_pass, "examples": args.examples,
         "note": "%d images x %.4f s; the whole %d-example run_evaluation "
                 "pass (predict, metrics, AP) took %.2f s"
                 % (VOC07_TEST_IMAGES, per_example, args.examples,
                    full_pass)},
        {"metric": "eval_device_forward_seconds_per_scale",
         "value": per_scale, "largest_canvas": [int(short), int(long_)],
         "ms_min": forward_t["ms_min"], "ms_max": forward_t["ms_max"],
         "clock": forward_t["clock"],
         "compute_bound_seconds_per_checkpoint":
             per_scale * len(min_dims) * VOC07_TEST_IMAGES,
         "note": "a batch already on the device; the gap to the per-example "
                 "time is the host's decode and resize, the other scales' "
                 "canvases and NMS"},
    ]
    for line in lines:
        benchlib.json_line({**line, **fields})
    return lines


if __name__ == "__main__":
    main()
