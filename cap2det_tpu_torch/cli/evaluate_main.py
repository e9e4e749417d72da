"""Continuous-evaluation CLI (the port's copy of
``cap2det_tpu/cli/evaluate_main.py``; reference train/predict.py flags
shape).

Usage:
  python -m cap2det_tpu_torch.cli.evaluate_main \
      --pipeline_proto configs/coco17_extend_match.pbtxt \
      --model_dir logs/coco17_extend_match \
      [--max_eval_examples 500] [--eval_coco_on_voc] [--run_once] \
      [--shard_indicator 0/2] [--input_pattern path1 path2] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging

from cap2det_tpu_torch.cli.train_main import load_pipeline_proto
from cap2det_tpu_torch.eval import evaluator


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_proto", required=True)
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--max_eval_examples", type=int, default=None)
    parser.add_argument("--min_eval_steps", type=int, default=0)
    parser.add_argument("--eval_coco_on_voc", action="store_true")
    parser.add_argument(
        "--evaluator", default="pascal", choices=["pascal", "coco"],
        help="Detection metric protocol (reference predict.py:565-576).",
    )
    parser.add_argument("--run_once", action="store_true",
                        help="Evaluate the latest checkpoint and exit.")
    parser.add_argument(
        "--max_idle_polls", type=int, default=None,
        help="Exit after this many consecutive no-new-checkpoint polls "
             "(default: poll forever, the reference daemon behavior).",
    )
    parser.add_argument(
        "--poll_interval", type=int, default=10,
        help="Seconds between checkpoint polls (reference predict.py:610).",
    )
    parser.add_argument(
        "--all_checkpoints", action="store_true",
        help="Walk every retained checkpoint oldest-first (metric-vs-step "
             "curve reconstruction) instead of polling only the latest.",
    )
    parser.add_argument(
        "--shard_indicator", default="",
        help="'k/n' hash-shard of the eval data (reference predict.py:539).",
    )
    parser.add_argument(
        "--input_pattern", nargs="*", default=None,
        help="Overrides eval_reader.input_pattern (reference predict.py:543).",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu.")
    args = parser.parse_args(argv)

    pipeline = load_pipeline_proto(args.pipeline_proto, args.model_dir)
    reader = pipeline.eval_reader.cap2det_reader
    if args.shard_indicator:
        object.__setattr__(reader, "shard_indicator", args.shard_indicator)
    if args.input_pattern:
        object.__setattr__(reader, "input_pattern", list(args.input_pattern))

    return evaluator.continuous_evaluation(
        pipeline,
        model_dir=args.model_dir,
        max_eval_examples=args.max_eval_examples,
        eval_coco_on_voc=args.eval_coco_on_voc,
        min_eval_steps=args.min_eval_steps,
        max_idle_polls=0 if args.run_once else args.max_idle_polls,
        poll_interval_secs=args.poll_interval,
        evaluator_kind=args.evaluator,
        evaluate_all=args.all_checkpoints,
        device=args.device,
    )


if __name__ == "__main__":
    main()
