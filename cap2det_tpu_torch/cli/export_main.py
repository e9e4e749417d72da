"""Detection-export CLI (the port's copy of
``cap2det_tpu/cli/export_main.py``; reference train/export_results.py
shape).

Usage:
  python -m cap2det_tpu_torch.cli.export_main \
      --pipeline_proto configs/voc07_inc2.pbtxt --model_dir <dir> \
      --output_json detections.json [--max_examples N] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.eval import export
from cap2det_tpu_torch.train import checkpoint as ckpt_lib


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_proto", required=True)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--output_json", required=True)
    parser.add_argument("--max_examples", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu.")
    args = parser.parse_args(argv)

    device = params_lib.resolve_device(args.device)
    pipeline = schema.load_pipeline(args.pipeline_proto)
    manager = ckpt_lib.CheckpointManager(args.model_dir)
    state = manager.restore()
    manager.close()
    if state is None:
        raise SystemExit("no checkpoint in %s" % args.model_dir)
    # The moving average when the checkpoint holds one.
    saved = state["ema"] if state.get("ema") is not None else state["params"]
    return export.export_results(
        pipeline, params_lib.from_jax_numpy(saved, device), args.output_json,
        max_examples=args.max_examples, device=device,
    )


if __name__ == "__main__":
    main()
