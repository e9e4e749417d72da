"""The quality-trajectory run (the port's counterpart of
``scripts/quality_run.sh``).

  python -m cap2det_tpu_torch.scripts.quality_run <workdir> [num_images]
      [max_steps] [nproc] [extractor] [caption_style] [class_set]
      [--device cuda|cpu]

Defaults: 240 images, 1500 steps, 1 selective-search process,
``groundtruth``, ``exact`` captions, class set 9. The steps:

  1. rich multi-object scenes (``tools.make_rich_synthetic_dataset
     --phase images``);
  2. selective-search proposals, ``nproc`` processes at once, each with
     ``--process_indicator i/nproc --max_boxes 500``;
  3. train/eval records, labels and the synonym table (``--phase
     records``);
  4. the passthrough backbone (``tools.make_passthrough_checkpoint``),
     unless ``<workdir>/passthrough_ckpt`` is there: the stand-in for the
     ImageNet warm start, loaded through ``--pretrained_checkpoint``
     (the first stage is frozen, and a frozen random first stage learns
     nothing);
  5. ``<workdir>/pipeline-<extractor>-<caption_style>.pbtxt``: voc07-style
     shapes (min dimension 1000 canvases, P <= 500, 3 OICR iterations,
     crop 14), the extractor's line, ``max_steps``, evaluation over
     ``num_images * 15 // 100`` held-out scenes;
  6. ``cli.train_main`` into ``<workdir>/model-<tag>``;
  7. ``cli.evaluate_main --all_checkpoints``: every retained checkpoint,
     oldest first, so the curve in ``<model_dir>/eval_metrics.jsonl``
     covers the whole run.

Training and evaluation run one after the other here, as in JAX, so that
every checkpoint is evaluated; ``scripts.train`` runs them side by side.
Extractors: ``groundtruth`` (the class names the records carry),
``exact_match`` (caption tokens only), ``extend_match`` (plus the synonym
table), ``word_vector`` (the synthetic embedding table's nearest class)
and ``text_classifier``, which needs a text classifier trained at
``<workdir>/text_model`` first (hidden 100, threshold 0.5). With
``caption_style`` ``synonyms`` most class mentions become
out-of-vocabulary synonyms: exact match loses them, extend match finds
them (the paper's central comparison).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import string
import sys

from cap2det_tpu_torch.scripts import steps

# Each extractor's line of the pipeline (scripts/quality_run.sh:42-54).
EXTRACTOR_LINES = {
    "groundtruth": "groundtruth_extractor { label_file: "
                   "'__WORK__/labels.txt' }",
    "exact_match": "exact_match_extractor { label_file: "
                   "'__WORK__/labels.txt' }",
    "extend_match": "extend_match_extractor { label_file: "
                    "'__WORK__/synonyms.txt' }",
    "word_vector": "word_vector_match_extractor { label_file: "
                   "'__WORK__/labels.txt' open_vocabulary_file: "
                   "'__WORK__/open_vocab.txt' "
                   "open_vocabulary_word_embedding_file: "
                   "'__WORK__/embeddings.npy' }",
    "text_classifier": "text_classifier_match_extractor { label_file: "
                       "'__WORK__/labels.txt' open_vocabulary_file: "
                       "'__WORK__/open_vocab.txt' "
                       "open_vocabulary_word_embedding_file: "
                       "'__WORK__/embeddings.npy' "
                       "text_classifier_checkpoint_file: "
                       "'__WORK__/text_model' hidden_units: 100 "
                       "label_threshold: 0.5 }",
}

# The pipeline of scripts/quality_run.sh, $-substituted as the shell does.
PIPELINE = string.Template("""\
train_reader {
  cap2det_reader {
    input_pattern: "$WORK/train.record"
    is_training: true
    shuffle_buffer_size: 64
    batch_size: 2
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 1000 } }
    preprocess_options { random_flip_left_right_prob: 0.5 }
    max_num_proposals: 500
    batch_resize_scale_value: 1.0
    map_num_parallel_calls: 4
  }
}
eval_reader {
  cap2det_reader {
    input_pattern: "$WORK/eval.record"
    is_training: false
    batch_size: 1
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 600 } }
    max_num_proposals: 500
  }
}
model {
  [Cap2DetModel.ext] {
    midn_loss_weight: 1.0
    oicr_loss_weight: 0.5
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 14
      maxpool_kernel_size: 2
      maxpool_stride: 2
      dropout_keep_prob: 0.8
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      regularizer { l2_regularizer { weight: 0.000001 } }
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 3
    oicr_iou_threshold: 0.5
    eval_min_dimension: 400
    eval_min_dimension: 600
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 20 max_total_size: 40
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 20 max_total_size: 40
    }
    label_extractor { $EXTRACTOR_LINE }
  }
}
train_config {
  max_steps: $MAX_STEPS
  learning_rate: 0.01
  learning_rate_decay { decay_steps: 2000 decay_rate: 0.5 staircase: true }
  optimizer { adagrad {} }
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier { scope: 'second_stage_feature_extraction' multiplier: 1.0 }
  save_checkpoints_steps: 250
  keep_checkpoint_max: 50
  log_step_count_steps: 25
}
eval_config { steps: $EVAL_N }
""")


def eval_examples(num_images):
    return num_images * 15 // 100


def selective_search(work, nproc):
    """<work>/images -> <work>/ss_npy, in `nproc` processes at once."""
    steps.run_all([
        ("cap2det_tpu_torch.tools.create_selective_search_data",
         ("--image_dir", os.path.join(work, "images"),
          "--output_dir", os.path.join(work, "ss_npy"),
          "--process_indicator", "%d/%d" % (i, nproc),
          "--max_boxes", 500))
        for i in range(nproc)])


def pipeline_text(work, extractor, max_steps, eval_n):
    line = EXTRACTOR_LINES[extractor].replace("__WORK__", work)
    return PIPELINE.substitute(WORK=work, EXTRACTOR_LINE=line,
                               MAX_STEPS=max_steps, EVAL_N=eval_n)


def read_jsonl(path):
    with open(path) as fid:
        return [json.loads(line) for line in fid if line.strip()]


def best_map(row):
    """The best finite mAP@0.5 over the OICR iterations of an eval row
    (NaN if none is finite)."""
    return max((v for k, v in row.items()
                if k.endswith("PascalBoxes_Precision/mAP@0.5IOU")
                and math.isfinite(v)), default=float("nan"))


def summary(model_dir):
    """A run's curve and times from its model_dir: the best mAP@0.5 over
    the OICR iterations at each evaluated step, the best of them and its
    step, the median milliseconds a step over the trainer's logged
    windows after the first (which holds the feed's start), and the
    median seconds an evaluation took."""
    rows = read_jsonl(os.path.join(model_dir, "eval_metrics.jsonl"))
    curve = {r["step"]: best_map(r) for r in rows}
    finite = {s: m for s, m in curve.items() if math.isfinite(m)}
    best = max(finite, key=finite.get) if finite else None
    windows = read_jsonl(os.path.join(model_dir, "metrics.jsonl"))[1:]
    return {
        "curve": curve,
        "best_step": best,
        "best_map": finite.get(best),
        "step_ms_median": statistics.median(
            1e3 / w["global_step/sec"] for w in windows) if windows else None,
        "eval_s_median": statistics.median(
            r["eval/seconds_per_checkpoint"] for r in rows) if rows else None,
    }


def parse(argv):
    parser = argparse.ArgumentParser(prog="quality_run")
    parser.add_argument("work")
    parser.add_argument("num_images", nargs="?", type=int, default=240)
    parser.add_argument("max_steps", nargs="?", type=int, default=1500)
    parser.add_argument("nproc", nargs="?", type=int, default=1)
    parser.add_argument("extractor", nargs="?", default="groundtruth",
                        choices=sorted(EXTRACTOR_LINES))
    parser.add_argument("caption_style", nargs="?", default="exact",
                        choices=["exact", "synonyms"])
    parser.add_argument("class_set", nargs="?", type=int, default=9,
                        choices=[9, 80])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def run(argv=None):
    args = parse(argv)
    work = os.path.abspath(args.work)
    eval_n = eval_examples(args.num_images)
    os.makedirs(work, exist_ok=True)
    dataset = "cap2det_tpu_torch.tools.make_rich_synthetic_dataset"

    # 1) scenes
    steps.run(dataset, "--phase", "images", "--out", work,
              "--num_images", args.num_images, "--class_set", args.class_set)
    # 2) selective-search proposals, restartable, nproc processes at once
    selective_search(work, args.nproc)
    # 3) records, labels and synonyms.txt
    steps.run(dataset, "--phase", "records", "--out", work,
              "--caption_style", args.caption_style,
              "--class_set", args.class_set)
    # 4) the warm-start backbone
    backbone = os.path.join(work, "passthrough_ckpt")
    if not os.path.exists(backbone):
        steps.run("cap2det_tpu_torch.tools.make_passthrough_checkpoint",
                  "--output", backbone)
    # 5) the pipeline, one per (extractor, caption style), so that runs
    #    over one dataset keep their model dirs apart
    tag = "%s-%s" % (args.extractor, args.caption_style)
    pipeline = os.path.join(work, "pipeline-%s.pbtxt" % tag)
    with open(pipeline, "w") as fid:
        fid.write(pipeline_text(work, args.extractor, args.max_steps, eval_n))
    model_dir = os.path.join(work, "model-%s" % tag)
    os.makedirs(model_dir, exist_ok=True)
    # 6) train
    steps.run("cap2det_tpu_torch.cli.train_main", "--pipeline_proto",
              pipeline, "--model_dir", model_dir, "--pretrained_checkpoint",
              backbone, "--device", args.device,
              log=os.path.join(work, "train-%s.log" % tag))
    # 7) every retained checkpoint -> the mAP-vs-step curve
    steps.run("cap2det_tpu_torch.cli.evaluate_main", "--pipeline_proto",
              pipeline, "--model_dir", model_dir, "--max_eval_examples",
              eval_n, "--all_checkpoints", "--max_idle_polls", 1,
              "--poll_interval", 1, "--device", args.device,
              log=os.path.join(work, "eval-%s.log" % tag))
    print("summary: " + json.dumps(summary(model_dir)))
    print("quality run done; curves: %s" % os.path.join(
        model_dir, "eval_metrics.jsonl"))


def main(argv=None):
    return steps.main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
