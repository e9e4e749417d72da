"""A checkpoint whose restore fails is skipped by both eval daemons.

When the trainer's ``keep_checkpoint_max`` deletes a checkpoint while the
daemon reads it, the read fails with whatever error the half-read file
gives: an OSError, an EOFError, a RuntimeError or an unpickling error.
JAX's ``_poll_loop`` catches any of them, logs the step as vanished,
marks it evaluated and goes on (``cap2det_tpu/eval/evaluator.py``); the
port's must do the same. Each package trains the small text model of
``tests/test_eval_all_checkpoints.py`` to checkpoints 3 and 6, then walks
them (``evaluate_all``) with ``CheckpointManager.restore`` raising the
same error for step 3: both write one curve point, step 6's.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.eval import evaluator as jax_evaluator
from cap2det_tpu.train import checkpoint as jax_ckpt_lib
from cap2det_tpu.train import trainer as jax_trainer
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import synthetic
from cap2det_tpu_torch.eval import evaluator
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

PIPELINE = """
train_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: true
    shuffle_buffer_size: 4
    batch_size: 4
    decode_image: false
    max_num_proposals: 4
  }
}
eval_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: false
    batch_size: 2
    decode_image: false
    max_num_proposals: 4
  }
}
model {
  [TextModel.ext] {
    label_extractor { label_file: '%(label_file)s' }
    text_classifier {
      label_file: '%(label_file)s'
      open_vocabulary_file: '%(vocab)s'
      open_vocabulary_word_embedding_file: '%(emb)s'
      hidden_units: 16
      dropout_keep_proba: 1.0
      regularizer: 1e-6
      label_threshold: 0.5
    }
  }
}
train_config {
  max_steps: 6
  learning_rate: 0.05
  optimizer { adagrad {} }
  save_checkpoints_steps: 3
  keep_checkpoint_max: 10
  log_step_count_steps: 3
}
eval_config { steps: 4 }
"""

PACKAGES = {
    "jax": (jax_schema, jax_trainer, jax_evaluator, jax_ckpt_lib,
            {"use_mesh": False}, {}),
    "port": (schema, trainer, evaluator, ckpt_lib, {"device": "cpu"},
             {"device": "cpu"}),
}
ERRORS = [RuntimeError("PytorchStreamReader failed reading zip archive"),
          EOFError("Ran out of input"),
          pickle.UnpicklingError("invalid load key, '\\x00'."),
          FileNotFoundError("checkpoint 3 was deleted")]


@pytest.fixture(scope="module")
def config_text(tmp_path_factory):
    root = tmp_path_factory.mktemp("restore")
    classes = ["person", "dog"]
    label_file = synthetic.write_label_file(str(root / "labels.txt"),
                                            classes)
    words = ["person", "dog", "a", "photo", "of"]
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(words))
    emb = str(root / "emb.npy")
    np.save(emb, np.random.RandomState(0).randn(len(words), 8)
            .astype(np.float32))
    record = str(root / "text.record")
    synthetic.write_synthetic_dataset(record, num_examples=8, seed=0,
                                      classes=classes, with_image=False)
    return PIPELINE % {"record": record, "label_file": label_file,
                       "vocab": str(vocab), "emb": emb}


@pytest.fixture(scope="module")
def trained(config_text, tmp_path_factory):
    """{package: model_dir} with checkpoints 3 and 6 of its train()."""
    dirs = {}
    for name, (schema_lib, trainer_lib, _, ckpt, train_kw, _) in (
            PACKAGES.items()):
        model_dir = str(tmp_path_factory.mktemp(name) / "model")
        trainer_lib.train(schema_lib.loads_pipeline(config_text),
                          model_dir=model_dir, **train_kw)
        assert [s for s, _ in ckpt.list_checkpoints(model_dir)] == [3, 6]
        dirs[name] = model_dir
    return dirs


@pytest.mark.parametrize("error", ERRORS, ids=lambda e: type(e).__name__)
@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_a_checkpoint_that_fails_to_restore_is_skipped(
        package, error, config_text, trained, monkeypatch, caplog):
    schema_lib, _, evaluator_lib, ckpt, _, eval_kw = PACKAGES[package]
    model_dir = trained[package]
    metrics_file = os.path.join(model_dir, "eval_metrics.jsonl")
    if os.path.exists(metrics_file):
        os.remove(metrics_file)
    real_restore = ckpt.CheckpointManager.restore
    tried = []

    def restore(self, state_like=None, step=None):
        tried.append(step)
        if step == 3:
            raise error
        return real_restore(self, state_like, step)

    monkeypatch.setattr(ckpt.CheckpointManager, "restore", restore)
    with caplog.at_level("WARNING"):
        evaluator_lib.continuous_evaluation(
            schema_lib.loads_pipeline(config_text), model_dir=model_dir,
            max_idle_polls=0, evaluate_all=True, poll_interval_secs=0,
            **eval_kw)
    with open(metrics_file) as fid:
        rows = [json.loads(line) for line in fid if line.strip()]
    assert tried == [3, 6]  # step 3 is marked evaluated, not retried
    assert [r["step"] for r in rows] == [6]
    assert "checkpoint 3 vanished before restore" in caplog.text
