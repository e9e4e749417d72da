"""The port's text model against the JAX package's: the classifier, the
two sequence encoders, ``TextModel.loss`` and its gradients, the
streaming metrics, 3 ``train()`` steps, ``run_text_evaluation``, the
daemon over two checkpoints and both CLIs; and the port's own 150-step
run reaching ``tests/test_text_model.py``'s quality thresholds.

The setup is ``tests/test_text_model.py``'s: 64 text-only records, 4
classes, a 12-word vocabulary with seeded 16-d embeddings. Both sides get
the same weights (the port's seeded JAX-layout numpy tree, handed to JAX
as arrays and to the port through ``params.from_jax_numpy``), in float32,
dropout off. Tolerances: logits and losses rtol 1e-5 (one float32
product summed in another order), gradients rtol 1e-4 / atol 1e-7,
``train()`` losses rtol 1e-4 over 3 steps and params rtol 1e-4 / atol
1e-5 (as ``tests/test_torch_train_loop.py``), metrics to 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import synthetic as jax_synthetic
from cap2det_tpu.eval import evaluator as jax_evaluator
from cap2det_tpu.models import registry as jax_registry
from cap2det_tpu.text import classifier as jax_classifier
from cap2det_tpu.text import sequence_encoding as jax_encoding
from cap2det_tpu.train import trainer as jax_trainer
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.cli import evaluate_main, train_main
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.eval import evaluator
from cap2det_tpu_torch.models import registry, text_model
from cap2det_tpu_torch.text import classifier, sequence_encoding
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import optimizers, trainer
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car", "bird"]
FILLERS = ["a", "the", "on", "photo", "of", "with", "near", "sitting"]
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
METRIC_ATOL = 1e-6

_PIPELINE = """
train_reader {
  cap2det_reader {
    decode_image: false
    input_pattern: "%(record)s"
    is_training: true
    shuffle_buffer_size: 16
    batch_size: 8
  }
}
eval_reader {
  cap2det_reader {
    decode_image: false
    input_pattern: "%(record)s"
    is_training: false
    batch_size: %(eval_batch)d
  }
}
model {
  [TextModel.ext] {
    label_extractor { label_file: '%(label_file)s' }
    text_classifier {
      label_file: '%(label_file)s'
      open_vocabulary_file: '%(vocab_file)s'
      open_vocabulary_word_embedding_file: '%(emb_file)s'
      hidden_units: 32
      dropout_keep_proba: %(keep)s
      regularizer: 1e-6
      label_threshold: 0.5
    }
  }
}
train_config {
  max_steps: %(max_steps)d
  learning_rate: 0.5
  optimizer { adagrad {} }
  save_checkpoints_steps: %(save_every)d
  keep_checkpoint_max: 10
  log_step_count_steps: %(log_every)d
  moving_average_decay: 0.0
}
eval_config { steps: 20 }
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("text")
    record = str(d / "text.record-0")
    jax_synthetic.write_synthetic_dataset(
        record, num_examples=64, seed=11, classes=CLASSES, with_image=False)
    label_file = jax_synthetic.write_label_file(str(d / "labels.txt"),
                                                CLASSES)
    vocab_file = str(d / "open_vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(CLASSES + FILLERS))
    emb = np.random.RandomState(0).randn(len(CLASSES + FILLERS), 16).astype(
        np.float32)
    emb_file = str(d / "emb.npy")
    np.save(emb_file, emb)

    def text(max_steps=150, save_every=100, log_every=50, keep="1.0",
             eval_batch=1):
        return _PIPELINE % dict(
            record=record, label_file=label_file, vocab_file=vocab_file,
            emb_file=emb_file, max_steps=max_steps, save_every=save_every,
            log_every=log_every, keep=keep, eval_batch=eval_batch)

    return {"dir": d, "text": text, "emb": emb}


@pytest.fixture(scope="module")
def models(setup):
    """(JAX model, port model on the CPU, JAX-layout tree, port params)."""
    text = setup["text"]()
    jax_model = jax_registry.build(jax_schema.loads_pipeline(text).model)
    model = registry.build(schema.loads_pipeline(text).model, device="cpu")
    tree = model.init_jax_numpy(0)
    return {"jax": jax_model, "port": model, "tree": tree,
            "params": params_lib.from_jax_numpy(tree, "cpu")}


def _token_ids(model, rng, batch=6, length=9):
    """Seeded ids over the vocabulary and OOV, with an all-OOV row and a
    row with one in-vocabulary token."""
    oov = model.vocab.oov_id
    ids = rng.integers(0, oov + 1, (batch, length)).astype(np.int32)
    ids[0] = oov
    ids[1] = oov
    ids[1, 4] = 2
    return ids


# -- the classifier and the encoders ------------------------------------------


def test_build_embedding_table_equals_jax(setup):
    np.testing.assert_array_equal(
        classifier.build_embedding_table(setup["emb"], seed=3),
        jax_classifier.build_embedding_table(setup["emb"], seed=3))


def test_init_params_have_jax_names_and_shapes(models):
    want = models["jax"].init_params(jax.random.PRNGKey(0))
    got = models["tree"]
    assert jax.tree_util.tree_structure(got) == (
        jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(
        got["word_embedding"]["weights"],
        np.asarray(want["word_embedding"]["weights"]))


def test_apply_equals_jax(models):
    """Dropout off, an all-OOV caption included (masked_maximum gives the
    row minimum on both sides)."""
    ids = _token_ids(models["port"], np.random.default_rng(0))
    oov = models["port"].vocab.oov_id
    want = np.asarray(jax_classifier.apply(
        jax.tree.map(jnp.asarray, models["tree"]), jnp.asarray(ids), oov))
    got = classifier.apply(models["params"], torch.from_numpy(ids), oov)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    # Padding never changes a caption's logits.
    padded = np.concatenate([ids, np.full_like(ids, oov)], axis=1)
    np.testing.assert_array_equal(
        classifier.apply(models["params"], torch.from_numpy(padded),
                         oov).numpy(), got.numpy())


def test_dropout_draws_from_the_generator(models):
    ids = torch.from_numpy(_token_ids(models["port"],
                                      np.random.default_rng(1)))
    oov = models["port"].vocab.oov_id

    def run(seed):
        return classifier.apply(models["params"], ids, oov,
                                dropout_keep_proba=0.6, is_training=True,
                                generator=torch.Generator().manual_seed(seed))

    off = classifier.apply(models["params"], ids, oov)
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6)) and not torch.equal(run(5), off)


@pytest.mark.parametrize("kind", ["average", "lstm"])
def test_sequence_encoders_equal_jax(kind):
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((4, 7, 5)).astype(np.float32)
    lengths = np.array([7, 3, 0, 1], np.int32)
    if kind == "average":
        config, jax_config = (sequence_encoding.AverageEncoder(),
                              jax_encoding.AverageEncoder())
    else:
        config, jax_config = (sequence_encoding.LstmEncoder(6),
                              jax_encoding.LstmEncoder(6))
    jax_params, jax_fn = jax_encoding.get_encode_fn(
        jax_config, rng=jax.random.PRNGKey(0), input_dim=5)
    params, fn = sequence_encoding.get_encode_fn(config, seed=0, input_dim=5,
                                                 device="cpu")
    assert {k: v.shape for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jax_params.items()}
    params = {k: torch.from_numpy(np.array(v))
              for k, v in jax_params.items()}
    want = np.asarray(jax_fn(jax_params, jnp.asarray(emb),
                             jnp.asarray(lengths)))
    got = fn(params, torch.from_numpy(emb), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="unknown encoder"):
        sequence_encoding.get_encode_fn(object(), device="cpu")


# -- the loss, its gradients, the metrics -------------------------------------


def _batch(model, rng, batch=6):
    return {"token_ids": _token_ids(model, rng, batch),
            "labels": (rng.random((batch, len(CLASSES))) < 0.4).astype(
                np.float32)}


def test_loss_and_gradients_equal_jax(models):
    model = models["port"]
    batch = _batch(model, np.random.default_rng(3))
    jax_params = jax.tree.map(jnp.asarray, models["tree"])
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, want_dict), want_grads = jax.value_and_grad(
        lambda p: models["jax"].loss(p, jax_batch, is_training=False),
        has_aux=True)(jax_params)

    params = params_lib.from_jax_numpy(models["tree"], "cpu")
    trainable = [(p, leaf) for p, leaf in optimizers.flatten_params(params)
                 if p.startswith("text_classifier/")]
    for _, leaf in trainable:
        leaf.requires_grad_(True)
    got, got_dict = model.loss(params, model.device_batch({
        "concat_caption_token_ids": batch["token_ids"],
        "pseudo_labels": batch["labels"]}), is_training=False)
    grads = torch.autograd.grad(got, [leaf for _, leaf in trainable])

    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert set(got_dict) == set(want_dict)
    for key in want_dict:
        np.testing.assert_allclose(got_dict[key].item(),
                                   float(want_dict[key]), rtol=LOSS_RTOL)
    want_flat = dict(optimizers.flatten_params(
        jax.tree.map(np.asarray, want_grads)))
    for (path, _), g in zip(trainable, grads):
        np.testing.assert_allclose(
            params_lib.to_jax_numpy({"g": {path.split("/")[-1]: g}})["g"][
                path.split("/")[-1]],
            want_flat[path], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=path)
    # The table is frozen: it takes no part in autograd.
    assert not params["word_embedding"]["weights"].requires_grad


def test_metrics_equal_jax_with_ties():
    from cap2det_tpu.models import text_model as jax_text_model

    rng = np.random.default_rng(4)
    got, want = text_model._TextMetrics(), jax_text_model._TextMetrics()
    for _ in range(3):
        # Logits on a coarse grid tie within rows; labels multi-hot.
        logits = np.round(rng.normal(0, 1.5, (10, 7)), 1).astype(np.float32)
        logits[0] = 0.5
        labels = (rng.random((10, 7)) < 0.3).astype(np.float32)
        got.update(labels, logits)
        want.update(labels, logits)
    assert got.result() == want.result()
    assert len(got.result()) == 10


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    """configs/coco17_text.pbtxt as shipped, pointed at a seeded stand-in
    for the 300-d GloVe table of data/coco_open_vocab.txt (not in the
    repository) and at 40 seeded text-only records naming COCO classes.
    Returns the config file's path."""
    d = tmp_path_factory.mktemp("shipped")
    emb_file = str(d / "coco_open_vocab_300d.npy")
    np.save(emb_file, np.random.default_rng(0).standard_normal(
        (7379, 300)).astype(np.float32))
    record = jax_synthetic.write_synthetic_dataset(
        str(d / "coco.record"), num_examples=40, seed=12, with_image=False,
        classes=open("data/coco_label.txt").read().splitlines())
    with open(os.path.join("configs", "coco17_text.pbtxt")) as f:
        text = f.read()
    for old, new in (("data/coco_open_vocab_300d.npy", emb_file),
                     ("output/records/coco17_train.record*", record),
                     ("output/records/coco17_val.record*", record)):
        assert old in text
        text = text.replace(old, new)
    proto = d / "coco17_text.pbtxt"
    proto.write_text(text)
    return str(proto)


def test_shipped_text_config_freezes_the_table(shipped):
    """The [7380, 300] table of the shipped config is frozen
    (requires_grad off, no optimizer slot, unchanged by a step), the FCs
    train."""
    cfg = schema.load_pipeline(shipped)
    model = registry.build(cfg.model, is_training=True, device="cpu")
    state, tx, _, mask = trainer.TrainState.create(model, cfg.train_config,
                                                   0)
    table = state["params"]["word_embedding"]["weights"]
    assert tuple(table.shape) == (300, 7380)  # port layout, [dims, vocab]
    assert mask["word_embedding"]["weights"] is False
    assert not table.requires_grad
    assert "word_embedding/weights" not in state["opt_state"]["slots"]
    before = table.clone()
    rng = np.random.default_rng(1)
    batch = model.device_batch({
        "concat_caption_token_ids": rng.integers(
            0, 7380, (20, 64)).astype(np.int32),
        "pseudo_labels": (rng.random((20, 80)) < 0.05).astype(np.float32)})
    step = trainer.make_train_step(model, tx, cfg.train_config, mask)
    state, logs = step(state, batch, 0)
    assert torch.equal(state["params"]["word_embedding"]["weights"], before)
    assert table.grad is None
    assert np.isfinite(float(logs["loss/total_loss"]))


# -- train() and evaluation ---------------------------------------------------


def _jax_train(text, model_dir, tree):
    mp = pytest.MonkeyPatch()
    real_build = jax_registry.build

    def build(cfg, **kwargs):
        model = real_build(cfg, **kwargs)
        model.init_params = lambda rng: jax.tree.map(jnp.asarray, tree)
        return model

    mp.setattr(jax_registry, "build", build)
    try:
        return jax_trainer.train(jax_schema.loads_pipeline(text),
                                 model_dir=model_dir, use_mesh=False)
    finally:
        mp.undo()


def _losses(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [(r["step"], {k: v for k, v in r.items() if k.startswith("loss/")})
            for r in records]


def test_train_matches_jax_train(setup, models, tmp_path):
    text = setup["text"](max_steps=3, save_every=3, log_every=1)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want_state = _jax_train(text, jax_dir, models["tree"])
    got_state = trainer.train(schema.loads_pipeline(text),
                              model_dir=port_dir, device="cpu")
    want, got = _losses(jax_dir), _losses(port_dir)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    for (step, g), (_, w) in zip(got, want):
        assert set(w) <= set(g), step
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                       err_msg="step %d %s" % (step, key))
    got_tree = params_lib.to_jax_numpy(got_state["params"])
    for (path, g), (_, w) in zip(
            optimizers.flatten_params(got_tree),
            optimizers.flatten_params(jax.tree.map(
                np.asarray, want_state["params"]))):
        np.testing.assert_allclose(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=path)


@pytest.fixture(scope="module")
def trained(setup, tmp_path_factory):
    """The port's 150-step run on the CPU (tests/test_text_model.py's)."""
    model_dir = str(tmp_path_factory.mktemp("trained") / "model")
    losses = []
    state = trainer.train(
        schema.loads_pipeline(setup["text"]()), model_dir=model_dir,
        device="cpu",
        hooks=[lambda step, st, logs: losses.append(
            float(logs["loss/total_loss"]))])
    return model_dir, state, losses


def test_text_model_trains(setup, trained):
    model_dir, state, losses = trained
    assert state["step"] == 150 and "ema" not in state
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10])
    cfg = schema.loads_pipeline(setup["text"]())
    model = registry.build(cfg.model, device="cpu")
    result, (recall,) = evaluator.run_text_evaluation(
        cfg, trainer.eval_params(state), model=model,
        max_eval_examples=32)
    assert result["num_examples"] == 32
    assert recall == result["metrics/recall_at_0.5"] > 0.8, result
    assert result["metrics/precision_at_1"] > 0.8, result
    assert ckpt_lib.latest_checkpoint(model_dir)[0] == 150
    # The frozen table is untouched (port layout: its transpose).
    np.testing.assert_array_equal(
        state["params"]["word_embedding"]["weights"].numpy().T[
            : len(setup["emb"])], setup["emb"])


@pytest.mark.parametrize("eval_batch", [1, 3])
def test_run_text_evaluation_equals_jax(setup, trained, eval_batch):
    _, state, _ = trained
    text = setup["text"](eval_batch=eval_batch)
    tree = params_lib.to_jax_numpy(state["params"])
    jax_cfg = jax_schema.loads_pipeline(text)
    want, want_promo = jax_evaluator.run_text_evaluation(
        jax_cfg, jax.tree.map(jnp.asarray, tree),
        model=jax_registry.build(jax_cfg.model), max_eval_examples=40)
    got, got_promo = evaluator.run_evaluation(
        schema.loads_pipeline(text), state["params"], device="cpu",
        max_eval_examples=40)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=METRIC_ATOL, err_msg=key)
    np.testing.assert_allclose(got_promo, want_promo, atol=METRIC_ATOL)


def test_daemon_walks_every_checkpoint(setup, tmp_path):
    """The counterpart of tests/test_eval_all_checkpoints.py: a text model
    walked over two checkpoints of the port's train(), oldest first,
    promoted on recall at 0.5; no HTML report."""
    text = setup["text"](max_steps=6, save_every=3, log_every=3,
                         eval_batch=2)
    model_dir = str(tmp_path / "model")
    trainer.train(schema.loads_pipeline(text), model_dir=model_dir,
                  device="cpu")
    assert [s for s, _ in ckpt_lib.list_checkpoints(model_dir)] == [3, 6]
    best = evaluator.continuous_evaluation(
        schema.loads_pipeline(text), model_dir=model_dir, max_idle_polls=0,
        evaluate_all=True, poll_interval_secs=0, device="cpu")
    with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [3, 6]
    for r in rows:
        assert r["num_examples"] == 64 and r["eval/seconds_per_checkpoint"] > 0
        assert os.path.isfile(os.path.join(
            model_dir, "eval_report_%d.csv" % r["step"]))
    assert not [f for f in os.listdir(model_dir) if f.endswith(".html")]
    recalls = {r["step"]: r["metrics/recall_at_0.5"] for r in rows}
    assert best[1] == max(recalls.values())
    with open(os.path.join(model_dir, "saved_ckpts", "saved_info.txt")) as f:
        step, metric = f.read().split("\t")
    assert float(metric) == pytest.approx(recalls[int(step)])


def test_shipped_config_trains_and_evaluates_through_the_clis(shipped,
                                                             tmp_path):
    """configs/coco17_text.pbtxt (stand-in table) through train_main for
    2 steps and evaluate_main --run_once, both with --device cpu."""
    model_dir = str(tmp_path / "model")
    train_main.main(["--pipeline_proto", shipped, "--model_dir", model_dir,
                     "--max_steps", "2", "--device", "cpu"])
    assert ckpt_lib.latest_checkpoint(model_dir)[0] == 2
    best = evaluate_main.main([
        "--pipeline_proto", shipped, "--model_dir", model_dir,
        "--run_once", "--max_eval_examples", "5", "--device", "cpu"])
    assert best[0] == 2
    with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    assert row["num_examples"] == 5 and "metrics/recall_at_1" in row


def test_text_model_needs_a_card_unless_asked_for_the_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = schema.loads_pipeline(setup["text"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.build(cfg.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(cfg, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluator.run_text_evaluation(cfg, params=None)
