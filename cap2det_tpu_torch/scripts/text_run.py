"""coco17_text on synthetic captions (the port's counterpart of
``scripts/text_run_tpu.sh``).

  python -m cap2det_tpu_torch.scripts.text_run <workdir> [max_steps]
      [--device cuda|cpu]

Trains the caption text classifier (embedding -> FC -> masked max -> FC
-> sigmoid CE) at ``configs/coco17_text.pbtxt``'s shapes (batch 20,
hidden 400, Adagrad 0.1; ``max_steps`` defaults to its 100000), then runs
the P/R@{.3,.5,.7} and P/R@k{1,5} evaluation once over 120 held-out
records. The records are synthetic caption examples over the 80 COCO
classes (``data/coco_label.txt``); the vocabulary is
``data/coco_open_vocab.txt`` plus the class names it lacks as single
tokens; a ``RandomState(0)`` table at 0.5 times a unit normal stands in
for GloVe (a smaller spread starves the frozen embedding's features).
Relative paths in the pipeline are read from the repository root, where
the steps run.
"""

from __future__ import annotations

import argparse
import os
import string
import sys

import numpy as np

from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.scripts import steps

TRAIN_RECORDS = 600
EVAL_RECORDS = 120
GLOVE_DIMS = 300
GLOVE_SCALE = 0.5

# The pipeline of scripts/text_run_tpu.sh, $-substituted as the shell does.
PIPELINE = string.Template("""\
train_reader {
  cap2det_reader {
    decode_image: false
    input_pattern: "$WORK/text_train.record"
    is_training: true
    shuffle_buffer_size: 2000
    batch_size: 20
    max_num_proposals: 500
  }
}
eval_reader {
  cap2det_reader {
    decode_image: false
    input_pattern: "$WORK/text_eval.record"
    is_training: false
    batch_size: 1
    max_num_proposals: 500
  }
}
model {
  [TextModel.ext] {
    label_extractor { label_file: 'data/coco_label.txt' }
    text_classifier {
      label_file: 'data/coco_label.txt'
      open_vocabulary_file: '$WORK/open_vocab.txt'
      open_vocabulary_word_embedding_file: '$WORK/open_vocab_300d.npy'
      hidden_units: 400
      dropout_keep_proba: 0.5
      regularizer: 1e-5
      label_threshold: 0.7
    }
  }
}
train_config {
  max_steps: $MAX_STEPS
  learning_rate: 0.1
  learning_rate_decay { decay_steps: 20000 decay_rate: 1.0 staircase: false }
  moving_average_decay: 0.0
  optimizer { adagrad {} }
  save_summary_steps: 2000
  save_checkpoints_steps: 1000
  keep_checkpoint_max: 10
  log_step_count_steps: 100
}
eval_config { steps: 120 }
""")


def pipeline_text(work, max_steps):
    return PIPELINE.substitute(WORK=work, MAX_STEPS=max_steps)


def write_inputs(work):
    """The text records, the open vocabulary and its stand-in table."""
    with open(os.path.join("data", "coco_label.txt")) as fid:
        classes = [l.strip() for l in fid if l.strip()]
    if len(classes) != 80:
        raise ValueError("data/coco_label.txt: %d classes, not 80"
                         % len(classes))
    synthetic.write_synthetic_dataset(
        os.path.join(work, "text_train.record"), num_examples=TRAIN_RECORDS,
        seed=0, classes=classes, with_image=False, num_proposals=8)
    synthetic.write_synthetic_dataset(
        os.path.join(work, "text_eval.record"), num_examples=EVAL_RECORDS,
        seed=1, classes=classes, with_image=False, num_proposals=8)
    # The COCO vocabulary plus the class names it lacks: multi-word names
    # ('traffic light') reach the captions as one token.
    with open(os.path.join("data", "coco_open_vocab.txt")) as fid:
        vocab = [l.rstrip("\n") for l in fid]
    have = set(vocab)
    vocab += [c for c in classes if c not in have]
    with open(os.path.join(work, "open_vocab.txt"), "w") as fid:
        fid.write("\n".join(vocab))
    rs = np.random.RandomState(0)
    emb = (rs.randn(len(vocab), GLOVE_DIMS) * GLOVE_SCALE).astype(np.float32)
    np.save(os.path.join(work, "open_vocab_300d.npy"), emb)
    print("records + vocab(%d) + embeddings ready" % len(vocab))


def parse(argv):
    parser = argparse.ArgumentParser(prog="text_run")
    parser.add_argument("work")
    parser.add_argument("max_steps", nargs="?", type=int, default=100000)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def run(argv=None):
    args = parse(argv)
    work = os.path.abspath(args.work)
    os.chdir(steps.PACKAGE_PARENT)
    os.makedirs(work, exist_ok=True)
    write_inputs(work)
    pipeline = os.path.join(work, "pipeline-text.pbtxt")
    with open(pipeline, "w") as fid:
        fid.write(pipeline_text(work, args.max_steps))
    model_dir = os.path.join(work, "model")
    os.makedirs(model_dir, exist_ok=True)

    print("training on %s ..." % args.device, flush=True)
    steps.run("cap2det_tpu_torch.cli.train_main", "--pipeline_proto",
              pipeline, "--model_dir", model_dir, "--device", args.device,
              log=os.path.join(work, "train.log"))
    sys.stdout.write(steps.tail(os.path.join(model_dir, "metrics.jsonl"), 2))
    steps.run("cap2det_tpu_torch.cli.evaluate_main", "--pipeline_proto",
              pipeline, "--model_dir", model_dir, "--run_once",
              "--max_eval_examples", EVAL_RECORDS, "--device", args.device,
              log=os.path.join(work, "eval.log"))
    sys.stdout.write(steps.tail(os.path.join(work, "eval.log"), 20))
    print("text run done; logs in %s" % work)


def main(argv=None):
    return steps.main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
