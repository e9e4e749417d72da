"""The port's checkpoints: a training state survives a save and restore
bit for bit, retention keeps the newest, the warm-start layouts restore,
and best-model promotion writes what the JAX package writes."""

import os

import numpy as np
import pytest
import torch

from cap2det_tpu.train import checkpoint as jax_ckpt
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import optimizers, trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

_PIPELINE = """
model {
  [Cap2DetModel.ext] {
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6 maxpool_kernel_size: 2 maxpool_stride: 2
    }
    oicr_iterations: 2
    label_extractor { groundtruth_extractor {
      label_file: 'data/voc_label.txt' } }
  }
}
train_config {
  learning_rate: 0.01
  optimizer { adagrad { initial_accumulator_value: 0.1 } }
  moving_average_decay: 0.5
  gradient_multiplier { scope: 'first_stage_feature_extraction' multiplier: 0.0 }
  gradient_multiplier {
    scope: 'first_stage_feature_extraction/InceptionV2/Mixed_4e'
    multiplier: 1.0 }
}
"""


@pytest.fixture(scope="module")
def state():
    cfg = schema.loads_pipeline(_PIPELINE)
    model = registry.build(cfg.model, is_training=True, device="cpu")
    state = trainer.TrainState.create(model, cfg.train_config, 0)[0]
    # Slots, EMA and params that differ from their initial values.
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for slots in state["opt_state"]["slots"].values():
            for v in slots.values():
                v.copy_(torch.rand(v.shape, generator=gen))
        for _, leaf in optimizers.flatten_params(state["ema"]):
            leaf.add_(torch.randn(leaf.shape, generator=gen))
    state["opt_state"]["count"] = 7
    state["step"] = 7
    return state


def _equal_trees(a, b):
    fa, fb = optimizers.flatten_params(a), optimizers.flatten_params(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_train_state_round_trips_bit_for_bit(tmp_path, state):
    manager = ckpt_lib.CheckpointManager(str(tmp_path), keep_max=3)
    assert manager.restore(state) is None
    assert manager.save(7, state)
    assert not manager.save(7, state)  # a saved step stays as it is
    restored = manager.restore(state)
    assert type(restored["step"]) is int and restored["step"] == 7
    assert restored["opt_state"]["count"] == 7
    _equal_trees(restored["params"], state["params"])
    _equal_trees(restored["ema"], state["ema"])
    slots = state["opt_state"]["slots"]
    assert set(restored["opt_state"]["slots"]) == set(slots)
    assert any(s.startswith("first_stage_feature_extraction/InceptionV2/"
                            "Mixed_4e/") for s in slots)
    for path, want in slots.items():
        for k, v in want.items():
            assert torch.equal(restored["opt_state"]["slots"][path][k], v)
    for (path, got), (_, want) in zip(
            optimizers.flatten_params(restored["params"]),
            optimizers.flatten_params(state["params"])):
        assert got.requires_grad == want.requires_grad, path
        assert got.data_ptr() != want.data_ptr()
    # The file holds the JAX layout.
    saved = manager.restore()
    conv = ("second_stage_feature_extraction", "InceptionV2", "Mixed_5a",
            "Branch_0", "Conv2d_0a_1x1", "weights")
    leaf_saved, leaf_live = saved["params"], state["params"]
    for key in conv:
        leaf_saved, leaf_live = leaf_saved[key], leaf_live[key]
    assert torch.equal(leaf_saved, leaf_live.detach().permute(2, 3, 1, 0))


def test_keep_max_keeps_the_newest(tmp_path, state):
    manager = ckpt_lib.CheckpointManager(str(tmp_path), keep_max=2)
    for step in (1, 2, 3, 5):
        manager.save(step, state)
    assert manager.all_steps() == [3, 5] and manager.latest_step() == 5
    assert [s for s, _ in ckpt_lib.list_checkpoints(str(tmp_path))] == [3, 5]
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == (
        5, os.path.join(str(tmp_path), "ckpt", "5"))
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "none")) == (None,
                                                                 None)
    assert ckpt_lib.list_checkpoints(str(tmp_path / "none")) == []


def test_restore_params_takes_all_three_layouts(tmp_path, state):
    want = params_lib.to_jax_numpy(state["params"])
    manager = ckpt_lib.CheckpointManager(str(tmp_path / "model"))
    manager.save(4, state)
    ckpt_lib.save_params(str(tmp_path / "params.pt"), state["params"])
    for path in (tmp_path / "params.pt", tmp_path / "model" / "ckpt" / "4",
                 tmp_path / "model"):
        got = ckpt_lib.restore_params(str(path))
        flat_got = dict(optimizers.flatten_params(got))
        for key, value in optimizers.flatten_params(want):
            assert isinstance(flat_got[key], np.ndarray)
            np.testing.assert_array_equal(flat_got[key], value, err_msg=key)
    with pytest.raises(FileNotFoundError, match="no restorable"):
        ckpt_lib.restore_params(str(tmp_path / "absent"))


def test_best_model_promotion_equals_jax(tmp_path):
    for root in ("jax", "port"):
        for step in (10, 20, 30):
            d = tmp_path / root / "ckpt" / str(step)
            d.mkdir(parents=True)
            (d / "state.pt").write_bytes(b"%d" % step)
    results = {}
    for root, module in (("jax", jax_ckpt), ("port", ckpt_lib)):
        saved = str(tmp_path / root / "saved")
        results[root] = [
            module.save_model_if_it_is_better(
                step, metric, str(tmp_path / root / "ckpt" / str(step)),
                saved, reverse=reverse)
            for step, metric, reverse in ((10, 0.5, False), (20, 0.25, False),
                                          (30, 0.75, False))]
        results[root].append(open(os.path.join(saved, "saved_info.txt")).read())
        results[root].append(sorted(os.listdir(saved)))
        results[root].append(os.path.relpath(
            module.get_best_model_checkpoint(saved), saved))
    assert results["port"] == results["jax"]
    assert results["port"][3] == "30\t0.75000000"
    reverse_dir = str(tmp_path / "port" / "rev")
    path10 = str(tmp_path / "port" / "ckpt" / "10")
    ckpt_lib.save_model_if_it_is_better(10, 0.5, path10, reverse_dir, True)
    assert ckpt_lib.save_model_if_it_is_better(
        20, 0.75, path10, reverse_dir, True) == (10, 0.5)
