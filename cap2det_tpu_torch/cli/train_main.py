"""Training CLI (the port's copy of ``cap2det_tpu/cli/train_main.py``;
reference train/trainer_main.py:25-56 shape).

Usage:
  python -m cap2det_tpu_torch.cli.train_main \
      --pipeline_proto configs/coco17_extend_match.pbtxt \
      --model_dir logs/coco17_extend_match \
      [--pretrained_checkpoint backbone.pt] [--device cuda]

Data parallel, one process per card (``parallel/distributed.py``):

  torchrun --nproc_per_node=N -m cap2det_tpu_torch.cli.train_main \
      --pipeline_proto ... --model_dir ...

The JAX launcher's JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID start it too.
"""

from __future__ import annotations

import argparse
import logging

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.parallel import distributed
from cap2det_tpu_torch.train import trainer


def load_pipeline_proto(path, model_dir=None):
    pipeline = schema.load_pipeline(path)
    if model_dir:
        object.__setattr__(pipeline, "model_dir", model_dir)
    return pipeline


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline_proto", required=True,
                        help="Path to the pbtxt pipeline config.")
    parser.add_argument("--model_dir", default=None,
                        help="Overrides pipeline.model_dir.")
    parser.add_argument("--pretrained_checkpoint", default=None,
                        help="Converted ImageNet backbone, in the port's "
                             "checkpoint format.")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu.")
    args = parser.parse_args(argv)

    # A no-op without a launcher's settings; else joins the process group
    # and gives this rank's card.
    device = distributed.maybe_initialize(device=args.device) or args.device
    try:
        pipeline = load_pipeline_proto(args.pipeline_proto, args.model_dir)
        trainer.train(
            pipeline,
            model_dir=args.model_dir,
            max_steps=args.max_steps,
            seed=args.seed,
            pretrained_checkpoint=args.pretrained_checkpoint,
            device=device,
        )
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
