"""Cap2Det trained from caption labels that the text model's extractors
make, the port's ``train()`` against the JAX package's: under
``text_classifier_match`` (the classifier warm-started from a checkpoint
file, each package reading its own format of the same weights) and
``word_vector_match``, the same records give the same labels and the
same losses.

The detector is ``tests/test_torch_train_loop.py``'s tiny one (canvases
at min dimension 64, P=16, 1 OICR iteration, Mixed_4e trainable), both
sides in float32 with the port's initial params, dropout off. Half the
records' captions name a class (exact match); the other half name only a
synonym from the vocabulary, which the classifier (identity first layer,
class axes read by the second, as in ``tests/test_extractors.py``) or
the cosine neighbour labels. In the port the labels are made in the
feed's worker process, where the classifier loads its checkpoint on the
CPU. Losses rtol 1e-4 over 2 steps (as the train-loop test); labels
equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import pipeline as jax_pipeline
from cap2det_tpu.models import registry as jax_registry
from cap2det_tpu.train import checkpoint as jax_ckpt_lib
from cap2det_tpu.train import trainer as jax_trainer
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline, synthetic
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.text import classifier
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car"]
SYNONYMS = ["man", "puppy", "automobile"]
FILLERS = ["a", "the", "on", "photo", "of", "with", "near", "sitting"]
DIMS = 8
MAX_STEPS = 2
LOSS_RTOL = 1e-4

_PIPELINE = """
train_reader {
  cap2det_reader {
    input_pattern: "%(pattern)s"
    is_training: true
    shuffle_buffer_size: 4
    batch_size: 2
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
    max_num_proposals: 16
    batch_resize_scale_value: 1.0
  }
}
model {
  [Cap2DetModel.ext] {
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
    oicr_use_proba_r_given_c: true
    midn_post_processor { max_size_per_class: 5 max_total_size: 10 }
    oicr_post_processor { max_size_per_class: 5 max_total_size: 10 }
    label_extractor { %(extractor)s }
  }
}
train_config {
  max_steps: %(max_steps)d
  learning_rate: 0.01
  optimizer { adagrad {} }
  save_checkpoints_steps: 100
  log_step_count_steps: 1
  gradient_multiplier {
    scope: 'first_stage_feature_extraction' multiplier: 0.0
  }
  gradient_multiplier {
    scope: 'first_stage_feature_extraction/InceptionV2/Mixed_4e'
    multiplier: 1.0
  }
}
"""

_EXTRACTORS = {
    "text_classifier_match": """text_classifier_match_extractor {
      label_file: '%(label_file)s'
      open_vocabulary_file: '%(vocab_file)s'
      open_vocabulary_word_embedding_file: '%(emb_file)s'
      text_classifier_checkpoint_file: '%(checkpoint)s'
      hidden_units: 8
      label_threshold: 0.7
    }""",
    "word_vector_match": """word_vector_match_extractor {
      label_file: '%(label_file)s'
      open_vocabulary_file: '%(vocab_file)s'
      open_vocabulary_word_embedding_file: '%(emb_file)s'
    }""",
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """PNG records (4 naming classes, 4 naming synonyms), the vocabulary,
    its embeddings and the classifier's weights in both checkpoint
    formats."""
    root = tmp_path_factory.mktemp("text_cap2det")
    for name, classes, seed in (("exact", CLASSES, 3),
                                ("synonym", SYNONYMS, 4)):
        synthetic.write_synthetic_dataset(
            str(root / ("train-%s.record" % name)), num_examples=4,
            seed=seed, classes=classes, image_hw=(96, 128), num_proposals=16)
    label_file = synthetic.write_label_file(str(root / "labels.txt"),
                                            CLASSES)
    words = CLASSES + SYNONYMS + FILLERS
    vocab_file = root / "open_vocab.txt"
    vocab_file.write_text("\n".join(words))
    emb = np.zeros((len(words), DIMS), np.float32)
    emb[len(CLASSES + SYNONYMS):, 3:] = np.random.default_rng(0).uniform(
        0, 0.3, (len(FILLERS), DIMS - 3))
    for c in range(len(CLASSES)):
        emb[c, c] = 1.0
        emb[len(CLASSES) + c, c] = 0.9
        emb[len(CLASSES) + c, (c + 1) % 3] = 0.1
    emb_file = str(root / "emb.npy")
    np.save(emb_file, emb)

    tree = {
        "word_embedding": {"weights": classifier.build_embedding_table(emb)},
        "text_classifier": {
            "layer1": {"weights": np.eye(DIMS, dtype=np.float32),
                       "biases": np.zeros((DIMS,), np.float32)},
            "layer2": {"weights": 10.0 * np.eye(DIMS, 3, dtype=np.float32),
                       "biases": -5.0 * np.ones((3,), np.float32)},
        },
    }
    port_ckpt, jax_ckpt = str(root / "clf.pt"), str(root / "clf_jax")
    ckpt_lib.save_params(port_ckpt, params_lib.from_jax_numpy(tree, "cpu"))
    jax_ckpt_lib.save_params(jax_ckpt, jax.tree.map(jnp.asarray, tree))

    def text(kind, package):
        extractor = _EXTRACTORS[kind] % {
            "label_file": label_file, "vocab_file": str(vocab_file),
            "emb_file": emb_file,
            "checkpoint": port_ckpt if package == "port" else jax_ckpt}
        return _PIPELINE % {"pattern": str(root / "train-*.record"),
                            "extractor": extractor, "max_steps": MAX_STEPS}

    return text


def _losses(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [(r["step"], {k: v for k, v in r.items() if k.startswith("loss/")})
            for r in records]


@pytest.mark.parametrize("kind", ["text_classifier_match",
                                  "word_vector_match"])
def test_labels_and_train_equal_jax(inputs, kind, tmp_path, monkeypatch):
    port_cfg = schema.loads_pipeline(inputs(kind, "port"))
    jax_cfg = jax_schema.loads_pipeline(inputs(kind, "jax"))

    # The labels both feeds make (the JAX model's pipeline_kwargs pack
    # the canvas for its stem; only the labels are compared).
    port_model = registry.build(port_cfg.model, compute_dtype=torch.float32,
                                device="cpu")
    jax_model = jax_registry.build(jax_cfg.model,
                                   compute_dtype=jnp.float32,
                                   use_pallas=False)
    if kind == "text_classifier_match":
        assert port_model.label_extractor.device.type == "cpu"
    got_pipe = pipeline.build_input_pipeline(
        port_cfg.train_reader, seed=0, **port_model.pipeline_kwargs())
    want_pipe = jax_pipeline.build_input_pipeline(
        jax_cfg.train_reader, seed=0, **jax_model.pipeline_kwargs())
    got_it, want_it = iter(got_pipe), iter(want_pipe)
    try:
        got = [next(got_it) for _ in range(8)]
        want = [next(want_it) for _ in range(8)]
    finally:
        got_it.close()
        want_it.close()
    beyond_exact = 0
    for g, w in zip(got, want):
        assert g[InputFields.image_id] == w[InputFields.image_id]
        np.testing.assert_array_equal(g[InputFields.pseudo_labels],
                                      w[InputFields.pseudo_labels])
        for tokens, labels in zip(g["concat_tokens"],
                                  g[InputFields.pseudo_labels]):
            if not set(tokens) & set(CLASSES):
                beyond_exact += int(labels.any())
    assert beyond_exact > 0  # the fallback labelled synonym captions

    # train(): the JAX package with the port's initial params.
    tree = port_model.init_jax_numpy(0)
    real_build = jax_registry.build

    def build(cfg, **kwargs):
        model = real_build(cfg, **dict(kwargs, compute_dtype=jnp.float32,
                                       use_pallas=False))
        model.init_params = lambda rng: jax.tree.map(jnp.asarray, tree)
        return model

    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    with monkeypatch.context() as mp:
        mp.setattr(jax_registry, "build", build)
        jax_trainer.train(jax_cfg, model_dir=jax_dir, use_mesh=False)
    port_build = registry.build
    monkeypatch.setattr(registry, "build", lambda cfg, **kw: port_build(
        cfg, **dict(kw, compute_dtype=torch.float32)))
    trainer.train(port_cfg, model_dir=port_dir, device="cpu")

    got_losses, want_losses = _losses(port_dir), _losses(jax_dir)
    assert [s for s, _ in got_losses] == [s for s, _ in want_losses] == [1, 2]
    for (step, g), (_, w) in zip(got_losses, want_losses):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                       err_msg="step %d %s" % (step, key))
