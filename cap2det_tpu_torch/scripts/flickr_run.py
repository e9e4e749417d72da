"""flickr30k_text_classifier_match end to end through the flickr tool
chain (the port's counterpart of ``scripts/flickr_run_tpu.sh``).

  python -m cap2det_tpu_torch.scripts.flickr_run <workdir> [num_images]
      [max_steps] [text_steps] [--nproc 1] [--device cuda|cpu]

Defaults: 120 images, 500 Cap2Det steps, 600 text-classifier steps. The
steps: synthetic scenes -> selective-search proposals (``--nproc``
processes at once) -> labelled train/eval records -> a
``results_20130124.token`` caption TSV over the train split and a
GloVe-format stand-in (classes on random unit vectors, each synonym near
its class, fillers apart) -> ``tools.create_flickr30k_tf_record``
(the caption-only flickr schema, no boxes, 2 shards) ->
``tools.create_vocab`` over the TSV -> the text classifier trained on the
labelled records (the stand-in for a COCO-trained ``zoo/coco17_text``)
-> the passthrough backbone -> Cap2Det from the flickr records with the
text_classifier_match extractor, shapes and freeze as
``configs/flickr30k_text_classifier_match.pbtxt`` -> every checkpoint
evaluated on the held-out split (standing in for VOC07 test).
"""

from __future__ import annotations

import argparse
import json
import os
import string
import sys

import numpy as np

from cap2det_tpu_torch.scripts import quality_run, steps
from cap2det_tpu_torch.tools import make_rich_synthetic_dataset as scenes

GLOVE_DIMS = 50
SYNONYM_NOISE = 0.25

# The two pipelines of scripts/flickr_run_tpu.sh, $-substituted as the
# shell does.
TEXT_PIPELINE = string.Template("""\
train_reader {
  cap2det_reader {
    decode_image: false
    input_pattern: "$WORK/train.record"
    is_training: true
    shuffle_buffer_size: 256
    batch_size: 20
    max_num_proposals: 500
  }
}
eval_reader {
  cap2det_reader {
    decode_image: false
    input_pattern: "$WORK/eval.record"
    is_training: false
    batch_size: 1
    max_num_proposals: 500
  }
}
model {
  [TextModel.ext] {
    label_extractor { label_file: '$WORK/labels.txt' }
    text_classifier {
      label_file: '$WORK/labels.txt'
      open_vocabulary_file: '$WORK/open_vocab.txt'
      open_vocabulary_word_embedding_file: '$WORK/open_vocab_50d.npy'
      hidden_units: 400
      dropout_keep_proba: 0.5
      regularizer: 1e-5
      label_threshold: 0.7
    }
  }
}
train_config {
  max_steps: $TEXT_STEPS
  learning_rate: 0.1
  moving_average_decay: 0.0
  optimizer { adagrad {} }
  save_checkpoints_steps: $TEXT_STEPS
  keep_checkpoint_max: 2
  log_step_count_steps: 100
}
eval_config { steps: $EVAL_N }
""")
FLICKR_PIPELINE = string.Template("""\
train_reader {
  cap2det_reader {
    input_pattern: "$WORK/records/flickr30k_trainval.record*"
    is_training: true
    shuffle_buffer_size: 64
    batch_size: 2
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 1000 } }
    preprocess_options { random_flip_left_right_prob: 0.5 }
    max_num_proposals: 500
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
      dropout_keep_prob: 0.5
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      regularizer { l2_regularizer { weight: 0.000001 } }
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 3
    oicr_iou_threshold: 0.6
    eval_min_dimension: 400
    eval_min_dimension: 600
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 20 max_total_size: 40
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 20 max_total_size: 40
    }
    oicr_use_proba_r_given_c: true
    label_extractor {
      text_classifier_match_extractor {
        label_file: '$WORK/labels.txt'
        open_vocabulary_file: '$WORK/open_vocab.txt'
        open_vocabulary_word_embedding_file: '$WORK/open_vocab_50d.npy'
        text_classifier_checkpoint_file: '$WORK/text_model'
        hidden_units: 400
        label_threshold: 0.7
      }
    }
  }
}
train_config {
  max_steps: $MAX_STEPS
  learning_rate: 0.01
  moving_average_decay: 0.0
  optimizer { adagrad {} }
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier { scope: 'second_stage_feature_extraction' multiplier: 1.0 }
  save_checkpoints_steps: 250
  keep_checkpoint_max: 10
  log_step_count_steps: 25
}
eval_config { steps: $EVAL_N }
""")


def text_pipeline_text(work, text_steps, eval_n):
    return TEXT_PIPELINE.substitute(WORK=work, TEXT_STEPS=text_steps,
                                    EVAL_N=eval_n)


def flickr_pipeline_text(work, max_steps, eval_n):
    return FLICKR_PIPELINE.substitute(WORK=work, MAX_STEPS=max_steps,
                                      EVAL_N=eval_n)


def write_captions(work):
    """The caption TSV (``<image>.jpg#<k>\\t<caption>``) of the train split
    and the GloVe text-format stand-in over the caption words."""
    with open(os.path.join(work, "gt.jsonl")) as fid:
        rows = [json.loads(l) for l in fid]
    rows.sort(key=lambda r: r["image_id"])
    n_eval = max(1, int(len(rows) * 0.15))
    train_rows = rows[n_eval:]
    rng = np.random.default_rng(7)
    with open(os.path.join(work, "results_20130124.token"), "w") as fid:
        for row in train_rows:
            caps = scenes.make_captions(rng, row["classes"], "exact")
            for k, cap in enumerate(caps):
                fid.write("%s.jpg#%d\t%s\n" % (row["image_id"], k,
                                               " ".join(cap)))

    erng = np.random.default_rng(11)

    def unit(v):
        return v / max(np.linalg.norm(v), 1e-12)

    vecs = {}
    for cls in scenes.CLASSES:
        vecs[cls] = unit(erng.normal(size=GLOVE_DIMS))
    for cls in scenes.CLASSES:
        for syn in scenes.SYNONYMS[cls]:
            vecs[syn] = unit(vecs[cls]
                             + SYNONYM_NOISE * erng.normal(size=GLOVE_DIMS))
    for filler in scenes._FILLER:
        vecs[filler] = unit(erng.normal(size=GLOVE_DIMS))
    with open(os.path.join(work, "glove_synth.txt"), "w") as fid:
        for word, v in vecs.items():
            fid.write("%s %s\n" % (word, " ".join("%.6f" % x for x in v)))
    print("token TSV over %d train images; glove stand-in %d words"
          % (len(train_rows), len(vecs)))


def parse(argv):
    parser = argparse.ArgumentParser(prog="flickr_run")
    parser.add_argument("work")
    parser.add_argument("num_images", nargs="?", type=int, default=120)
    parser.add_argument("max_steps", nargs="?", type=int, default=500)
    parser.add_argument("text_steps", nargs="?", type=int, default=600)
    parser.add_argument("--nproc", type=int, default=1,
                        help="selective-search processes run at once")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def run(argv=None):
    args = parse(argv)
    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    eval_n = quality_run.eval_examples(args.num_images)
    dataset = "cap2det_tpu_torch.tools.make_rich_synthetic_dataset"

    # 1) scenes (+ gt.jsonl for the eval split)
    steps.run(dataset, "--phase", "images", "--out", work,
              "--num_images", args.num_images)
    # 2) selective-search proposals
    quality_run.selective_search(work, args.nproc)
    # 3) labelled records (text-model training, the gt eval split)
    steps.run(dataset, "--phase", "records", "--out", work)
    # 4) the caption TSV and the GloVe stand-in
    write_captions(work)
    # 5) the flickr record builder (caption-only schema)
    os.makedirs(os.path.join(work, "records"), exist_ok=True)
    steps.run("cap2det_tpu_torch.tools.create_flickr30k_tf_record",
              "--image_source", os.path.join(work, "images"),
              "--annotation_path",
              os.path.join(work, "results_20130124.token"),
              "--proposal_data_path", os.path.join(work, "ss_npy"),
              "--output_path",
              os.path.join(work, "records", "flickr30k_trainval.record"),
              "--num_shards", 2)
    # 6) the vocabulary over the TSV
    steps.run("cap2det_tpu_torch.tools.create_vocab",
              "--caption_tsv_file",
              os.path.join(work, "results_20130124.token"),
              "--glove_file", os.path.join(work, "glove_synth.txt"),
              "--output_vocabulary_file", os.path.join(work, "open_vocab.txt"),
              "--output_vocabulary_word_embedding_file",
              os.path.join(work, "open_vocab_50d.npy"),
              "--min_word_freq", 1)
    # 7) the text classifier, trained on the labelled records
    text_pipeline = os.path.join(work, "pipeline-text.pbtxt")
    with open(text_pipeline, "w") as fid:
        fid.write(text_pipeline_text(work, args.text_steps, eval_n))
    steps.run("cap2det_tpu_torch.cli.train_main", "--pipeline_proto",
              text_pipeline, "--model_dir", os.path.join(work, "text_model"),
              "--device", args.device,
              log=os.path.join(work, "train-text.log"))
    # 8) the warm-start backbone
    backbone = os.path.join(work, "passthrough_ckpt")
    if not os.path.exists(backbone):
        steps.run("cap2det_tpu_torch.tools.make_passthrough_checkpoint",
                  "--output", backbone)
    # 9) Cap2Det from the flickr records, then every checkpoint evaluated
    pipeline = os.path.join(work, "pipeline-flickr.pbtxt")
    with open(pipeline, "w") as fid:
        fid.write(flickr_pipeline_text(work, args.max_steps, eval_n))
    model_dir = os.path.join(work, "model-flickr")
    os.makedirs(model_dir, exist_ok=True)
    steps.run("cap2det_tpu_torch.cli.train_main", "--pipeline_proto",
              pipeline, "--model_dir", model_dir, "--pretrained_checkpoint",
              backbone, "--device", args.device,
              log=os.path.join(work, "train-flickr.log"))
    steps.run("cap2det_tpu_torch.cli.evaluate_main", "--pipeline_proto",
              pipeline, "--model_dir", model_dir, "--max_eval_examples",
              eval_n, "--all_checkpoints", "--max_idle_polls", 1,
              "--poll_interval", 1, "--device", args.device,
              log=os.path.join(work, "eval-flickr.log"))
    print("summary: " + json.dumps(quality_run.summary(model_dir)))
    print("flickr run done; curves: %s" % os.path.join(
        model_dir, "eval_metrics.jsonl"))


def main(argv=None):
    return steps.main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
