"""The port's ``train()`` against the JAX package's ``train()``: the same
records, config, seed and initial params give the same losses step by step
and the same final params; a second ``train()`` resumes from the
checkpoint; the train CLI runs a step.

The config is ``tests/test_cap2det_train.py``'s (canvases at min
dimension 64, P=16, groundtruth labels, Adagrad, Mixed_4e trainable) with
dropout off, both sides in float32 (the JAX model without Pallas). JAX
takes the port's initial params (``init_jax_numpy``) through a
monkeypatch of its model's ``init_params``; nothing of the JAX package
changes. The JAX feed packs canvases space-to-depth for its stem, the
port feeds them raw: the same convolution summed in another order.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.models import registry as jax_registry
from cap2det_tpu.train import optimizers as jax_optimizers
from cap2det_tpu.train import trainer as jax_trainer
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.cli import train_main
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import optimizers, trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car"]
MAX_STEPS = 3
# tests/test_torch_train.py's: losses to 1e-4 relative over steps; an
# Adagrad step moves a param by up to lr = 0.01, so atol 1e-5 is 0.1% of
# one step.
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5

_PIPELINE = """
train_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: true
    shuffle_buffer_size: 4
    batch_size: 2
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
    preprocess_options { random_flip_left_right_prob: 0.5 }
    max_num_proposals: 16
    batch_resize_scale_value: 1.0
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
    midn_post_processor { max_size_per_class: 5 max_total_size: 10 }
    oicr_post_processor { max_size_per_class: 5 max_total_size: 10 }
    label_extractor {
      groundtruth_extractor { label_file: '%(label_file)s' }
    }
  }
}
train_config {
  max_steps: %(max_steps)d
  learning_rate: 0.01
  optimizer { adagrad {} }
  save_checkpoints_steps: 2
  log_step_count_steps: 1
  gradient_multiplier {
    scope: 'first_stage_feature_extraction' multiplier: 0.0
  }
  gradient_multiplier {
    scope: 'second_stage_feature_extraction' multiplier: 1.0
  }
  gradient_multiplier {
    scope: 'first_stage_feature_extraction/InceptionV2/Mixed_4e'
    multiplier: 1.0
  }
}
"""


@pytest.fixture(scope="module")
def config_text(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_loop")
    record = str(root / "train.record")
    synthetic.write_synthetic_dataset(record, num_examples=8, seed=3,
                                      classes=CLASSES, image_hw=(96, 128),
                                      num_proposals=16)
    label_file = synthetic.write_label_file(str(root / "labels.txt"),
                                            CLASSES)
    return lambda max_steps=MAX_STEPS: _PIPELINE % {
        "record": record, "label_file": label_file, "max_steps": max_steps}


def _float32_port_build(monkeypatch):
    real = registry.build
    monkeypatch.setattr(registry, "build", lambda cfg, **kw: real(
        cfg, **dict(kw, compute_dtype=torch.float32)))


def _port_train(config_text, model_dir, monkeypatch, max_steps=MAX_STEPS):
    _float32_port_build(monkeypatch)
    steps = []
    state = trainer.train(
        schema.loads_pipeline(config_text(max_steps)), model_dir=model_dir,
        device="cpu",
        hooks=[lambda step, st, logs: steps.append(
            (step, float(logs["loss/total_loss"]), logs["input/wait_sec"],
             logs["input/canvas_height"], logs["input/canvas_width"]))])
    return state, steps


def _losses(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [(r["step"], {k: v for k, v in r.items() if k.startswith("loss/")})
            for r in records]


@pytest.fixture(scope="module")
def jax_run(config_text, tmp_path_factory):
    """JAX train() with the port's initial params, in float32."""
    model_dir = str(tmp_path_factory.mktemp("jax_model"))
    tree = None
    mp = pytest.MonkeyPatch()
    real_build = jax_registry.build

    def build(cfg, **kwargs):
        nonlocal tree
        model = real_build(cfg, **dict(kwargs, compute_dtype=jnp.float32,
                                       use_pallas=False))
        port = registry.build(schema.loads_pipeline(config_text()).model,
                              device="cpu")
        tree = port.init_jax_numpy(0)
        model.init_params = lambda rng: jax.tree.map(jnp.asarray, tree)
        return model

    mp.setattr(jax_registry, "build", build)
    try:
        state = jax_trainer.train(jax_schema.loads_pipeline(config_text()),
                                  model_dir=model_dir, use_mesh=False)
    finally:
        mp.undo()
    return model_dir, state, tree


def test_train_matches_jax_train(config_text, jax_run, tmp_path,
                                 monkeypatch):
    jax_dir, jax_state, tree = jax_run
    port_dir = str(tmp_path / "port_model")
    state, steps = _port_train(config_text, port_dir, monkeypatch)
    assert state["step"] == MAX_STEPS and type(state["step"]) is int
    assert [s[0] for s in steps] == list(range(1, MAX_STEPS + 1))
    assert all(s[2] >= 0 and (s[3], s[4]) == (64.0, 96.0) for s in steps)

    got, want = _losses(port_dir), _losses(jax_dir)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    for (step, g), (_, w) in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                       err_msg="step %d %s" % (step, key))
    assert got[-1][1]["loss/total_loss"] < got[0][1]["loss/total_loss"]

    flat = dict(optimizers.flatten_params(
        params_lib.to_jax_numpy(state["params"])))
    want_flat = dict(zip(
        jax_optimizers.param_path_strings(jax_state["params"]),
        jax.tree_util.tree_leaves(jax_state["params"])))
    initial = dict(optimizers.flatten_params(tree))
    trainable = {p: leaf.requires_grad
                 for p, leaf in optimizers.flatten_params(state["params"])}
    moved = 0
    for key, value in flat.items():
        if trainable[key]:
            np.testing.assert_allclose(value, np.asarray(want_flat[key]),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=key)
            moved += not np.array_equal(value, initial[key])
        else:
            np.testing.assert_array_equal(value, initial[key], err_msg=key)
    assert moved > 0.9 * sum(trainable.values())
    # Checkpoints at save_checkpoints_steps and at the end, as JAX's.
    assert [s for s, _ in ckpt_lib.list_checkpoints(port_dir)] == [2, 3]
    assert jax_trainer.ckpt_lib.latest_checkpoint(jax_dir)[0] == 3


def test_second_train_resumes_from_the_checkpoint(config_text, tmp_path,
                                                  monkeypatch):
    model_dir = str(tmp_path / "model")
    first, _ = _port_train(config_text, model_dir, monkeypatch)
    # At max_steps the restored state comes back untrained: bit for bit
    # the state the first run saved.
    again, steps = _port_train(config_text, model_dir, monkeypatch)
    assert steps == [] and again["step"] == MAX_STEPS
    for (path, a), (_, b) in zip(optimizers.flatten_params(again["params"]),
                                 optimizers.flatten_params(first["params"])):
        assert torch.equal(a, b) and a.requires_grad == b.requires_grad, path
    assert again["opt_state"]["count"] == first["opt_state"]["count"]
    for path, slots in first["opt_state"]["slots"].items():
        for k, v in slots.items():
            assert torch.equal(again["opt_state"]["slots"][path][k], v)
    # A higher max_steps trains on from the saved step.
    resumed, steps = _port_train(config_text, model_dir, monkeypatch,
                                 max_steps=MAX_STEPS + 2)
    assert [s[0] for s in steps] == [MAX_STEPS + 1, MAX_STEPS + 2]
    assert np.all(np.isfinite([s[1] for s in steps]))
    assert resumed["step"] == MAX_STEPS + 2
    assert [s for s, _ in ckpt_lib.list_checkpoints(model_dir)] == [2, 3, 4,
                                                                    5]


def test_train_cli_runs_a_step_on_the_cpu(config_text, tmp_path):
    proto = tmp_path / "pipeline.pbtxt"
    proto.write_text(config_text())
    model_dir = str(tmp_path / "cli_model")
    train_main.main(["--pipeline_proto", str(proto), "--model_dir",
                     model_dir, "--max_steps", "1", "--device", "cpu"])
    assert [s for s, _ in _losses(model_dir)] == [1]
    assert ckpt_lib.latest_checkpoint(model_dir)[0] == 1
    assert train_main.load_pipeline_proto(
        str(proto), model_dir).model_dir == model_dir


def test_train_needs_a_card_unless_asked_for_the_cpu(config_text):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(schema.loads_pipeline(config_text()))


def test_device_prefetch_times_the_feed_and_the_placing_apart():
    """input/wait_sec holds the wait on the pipeline only, and
    input/place_sec the placing only."""
    import time

    def slow_feed():
        for i in range(4):
            time.sleep(0.2)
            yield i

    timing = {}
    out = []
    for slow_place, feed in ((False, slow_feed()), (True, iter(range(4)))):
        batches = trainer._device_prefetch(
            feed, lambda b: time.sleep(0.2 * slow_place) or b, timing)
        timing.update(wait=0.0, place=0.0)
        next(batches)
        out.append(dict(timing))
        batches.close()
    fed, placed = out
    # The first call fills the queue: three batches taken and placed.
    assert fed["wait"] >= 0.6 and fed["place"] < 0.1
    assert placed["place"] >= 0.6 and placed["wait"] < 0.1
