"""Entry points on a tiny Cap2Det (the port's counterpart of
``__graft_entry__.py``).

* ``entry(device)`` -> (fn, example_args): the tiny model's forward,
  ``fn(*example_args)`` gives its MIDN/OICR scores.
* ``dryrun_multichip(n_devices, device)``: spawns `n_devices` ranks of
  one process group; each takes ONE full training step of the tiny model
  on its slice of one global batch, the gradients averaged across the
  ranks. Then the same step without dropout is held against one process
  stepping on the whole batch. Prints ``dryrun_multichip ok: <n> ranks
  ...``.

Run ``python -m cap2det_tpu_torch.entry [n] [device]`` (2 ranks on
"cuda" by default; ranks on fewer cards share them through gloo).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

CLASSES = ["person", "dog", "car", "bird", "cat", "horse", "boat", "train"]

_PIPELINE = """
model {
  [Cap2DetModel.ext] {
    midn_loss_weight: 1.0
    oicr_loss_weight: 0.5
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6
      maxpool_kernel_size: 2
      maxpool_stride: 2
      dropout_keep_prob: %(keep_prob)g
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      op: FC
      regularizer { l2_regularizer { weight: 0.000001 } }
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 3
    oicr_iou_threshold: 0.6
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 10 max_total_size: 20
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 10 max_total_size: 20
    }
    label_extractor { groundtruth_extractor { label_file: '%(label_file)s' } }
  }
}
train_config {
  max_steps: 100
  learning_rate: 0.01
  learning_rate_decay { decay_steps: 100000 decay_rate: 1.0 staircase: true }
  moving_average_decay: 0.0
  optimizer { adagrad {} }
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier { scope: 'second_stage_feature_extraction' multiplier: 1.0 }
  gradient_multiplier {
    scope: 'first_stage_feature_extraction/InceptionV2/Mixed_4e'
    multiplier: 1.0
  }
}
"""

# __graft_entry__'s bound: the same step on the whole batch and split
# across ranks differ by float32 reduction order only.
PARITY_TOL = 2e-4


def _label_file(directory):
    from cap2det_tpu_torch.data import synthetic

    return synthetic.write_label_file(os.path.join(directory, "labels.txt"),
                                      CLASSES)


def _config(label_file, keep_prob=0.5):
    from cap2det_tpu_torch.config import schema

    return schema.loads_pipeline(_PIPELINE % {"keep_prob": keep_prob,
                                              "label_file": label_file})


def _build(cfg, device, is_training, compute_dtype):
    from cap2det_tpu_torch.models import registry
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    return registry.build(cfg.model, is_training=is_training,
                          compute_dtype=compute_dtype, device=device)


def _tiny_batch(batch=2, hw=64, num_proposals=16, num_classes=len(CLASSES)):
    """__graft_entry__'s seeded batch, with the port's input keys."""
    from cap2det_tpu_torch.fields import InputFields

    rng = np.random.RandomState(0)
    y0 = rng.uniform(0, 0.5, (batch, num_proposals))
    x0 = rng.uniform(0, 0.5, (batch, num_proposals))
    proposals = np.stack(
        [y0, x0, y0 + rng.uniform(0.2, 0.5, (batch, num_proposals)),
         x0 + rng.uniform(0.2, 0.5, (batch, num_proposals))], -1
    ).astype(np.float32)
    labels = np.zeros((batch, num_classes), np.float32)
    labels[:, :2] = 1.0
    return {
        InputFields.image: rng.uniform(0, 255, (batch, hw, hw, 3)).astype(
            np.float32),
        InputFields.proposals: proposals,
        InputFields.num_proposals: np.full((batch,), num_proposals,
                                           np.int32),
        InputFields.pseudo_labels: labels,
    }


def entry(device="cuda"):
    """(fn, example_args) for the tiny Cap2Det's forward in bfloat16:
    fn(params, batch) -> {score key: [B, P, classes] scores}."""
    cfg = _config(_label_file(tempfile.mkdtemp(prefix="entry_labels_")))
    model = _build(cfg, device, is_training=False,
                   compute_dtype=torch.bfloat16)
    params = model.init_params(0)
    batch = model.device_batch(_tiny_batch())

    def forward(params, batch):
        with torch.no_grad():
            preds = model.predictions(model.prepare(params), batch)
        return {k: preds[k] for k in model.score_keys()}

    return forward, (params, batch)


def _step(device, cfg, host_batch, group, seed=1):
    """One training step of the tiny model in float32 from params of seed
    0: (logs as floats, {trainable path: updated param}, {path: Adagrad
    accumulator}) on the CPU."""
    from cap2det_tpu_torch.train import optimizers, trainer

    model = _build(cfg, device, is_training=True,
                   compute_dtype=torch.float32)
    state, tx, _, mask = trainer.TrainState.create(model, cfg.train_config,
                                                   0)
    step = trainer.make_train_step(model, tx, cfg.train_config, mask,
                                   process_group=group)
    state, logs = step(state, model.device_batch(host_batch), seed)
    trainable = dict(optimizers.flatten_params(mask))
    params = {p: leaf.detach().cpu() for p, leaf
              in optimizers.flatten_params(state["params"]) if trainable[p]}
    slots = {p: s["sum_of_squares"].cpu()
             for p, s in state["opt_state"]["slots"].items()}
    return {k: float(v) for k, v in logs.items()}, params, slots


def _slice(host_batch, rank, world):
    n = len(host_batch[next(iter(host_batch))]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in host_batch.items()}


def _dryrun_rank(device, label_file, out_dir):
    import torch.distributed as dist

    from cap2det_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    rank, world = mesh_lib.rank(), mesh_lib.world_size()
    group = dist.group.WORLD
    logs, _, _ = _step(device, _config(label_file), _slice(
        _tiny_batch(batch=2 * world), rank, world), group)
    if not np.isfinite(logs["loss/total_loss"]):
        raise FloatingPointError("rank %d: loss %r" % (rank, logs))
    # Without dropout, every rank's update equals one process's on the
    # whole batch.
    _, params, _ = _step(device, _config(label_file, keep_prob=1.0), _slice(
        _tiny_batch(batch=world), rank, world), group)
    if rank == 0:
        torch.save({"loss": logs["loss/total_loss"], "params": params},
                   os.path.join(out_dir, "rank0.pt"))


def dryrun_multichip(n_devices, device="cuda", timeout=600.0):
    """Runs the tiny model's training step on `n_devices` ranks and holds
    its update against one process's on the same global batch."""
    from cap2det_tpu_torch.parallel import distributed

    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        label_file = _label_file(tmp)
        distributed.spawn(_dryrun_rank, n_devices, args=(label_file, tmp),
                          device=device, timeout=timeout)
        got = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=True)
        _, want, _ = _step(device, _config(label_file, keep_prob=1.0),
                           _tiny_batch(batch=n_devices), None)
    worst = max(float((got["params"][p].double() - v.double()).abs().max())
                for p, v in want.items())
    if not worst < PARITY_TOL:
        raise AssertionError(
            "data-parallel parity violated: max|params_ranks - "
            "params_single| = %g" % worst)
    print("dryrun_multichip ok: %d ranks on %s, step 1, loss %.5f, "
          "parity max-abs %.2e" % (n_devices, device, got["loss"], worst))
    return worst


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
