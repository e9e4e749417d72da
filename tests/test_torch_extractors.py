"""The port's label extractors against the JAX package's: the string
matchers on the repo's label files, with multiword and out-of-vocabulary
tokens; the word-vector and text-classifier matchers on the same
embeddings and classifier weights (``tests/test_extractors.py``'s
synthetic vocabulary, and data/coco_open_vocab.txt with a seeded stand-in
table), labels equal; the text classifier warm-started from checkpoints
of the port's ``train()``."""

import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import pipeline as jax_pipeline
from cap2det_tpu.text import extractors as jax_extractors
from cap2det_tpu.text import vocab as jax_vocab
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline
from cap2det_tpu_torch.text import extractors
from cap2det_tpu_torch.train import optimizers

torch.set_num_threads(1)

CASES = [
    ("groundtruth_extractor", "data/voc_label.txt"),
    ("groundtruth_extractor", "data/coco_label.txt"),
    ("exact_match_extractor", "data/voc_label.txt"),
    ("exact_match_extractor", "data/coco_label.txt"),
    ("extend_match_extractor", "data/coco_label_synonyms.txt"),
]
IDS = ["groundtruth_voc", "groundtruth_coco", "exact_voc", "exact_coco",
       "extend_coco"]


def _config(pkg, kind, label_file):
    return pkg.LabelExtractor.from_dict(
        {kind: {"label_file": label_file}})


def _token_pool(label_file):
    """Every class name and synonym of the file, the renamed multiword
    classes, multiword tokens and out-of-vocabulary tokens."""
    pool = ["zebra-ish", "the", "", "Person", "stop", "sign", "teddy bear",
            "motor bike", "air plane", "unicorn"]
    if label_file.endswith("synonyms.txt"):
        classes, name2id = jax_vocab.load_synonym_table(label_file)
        pool += sorted(name2id)
    else:
        classes = jax_vocab.load_lines(label_file)
        pool += classes
    pool += jax_extractors.replace_class_names(classes)
    pool += list(jax_extractors.CLASS_NAME_SYNONYMS)
    return pool


@pytest.mark.parametrize("kind,label_file", CASES, ids=IDS)
def test_labels_equal_jax(kind, label_file):
    want_ex = jax_extractors.build_label_extractor(
        _config(jax_schema, kind, label_file))
    got_ex = extractors.build_label_extractor(
        _config(schema, kind, label_file))
    assert got_ex.classes == want_ex.classes
    assert got_ex.num_classes == want_ex.num_classes

    pool = _token_pool(label_file)
    rng = np.random.default_rng(0)
    texts = [[], ["unicorn", "the"]] + [
        [pool[i] for i in rng.integers(0, len(pool), rng.integers(1, 12))]
        for _ in range(200)]
    got = got_ex.extract_labels(texts)
    want = want_ex.extract_labels(texts)
    assert got.dtype == np.float32 and got.shape == (len(texts),
                                                     want_ex.num_classes)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size  # matches and misses both occur
    assert not got[:2].any()

    # The feed picks object texts for groundtruth, captions otherwise.
    examples = [{"object_texts": t, "concat_tokens": t[::-1]} for t in texts]
    np.testing.assert_array_equal(
        pipeline.labels_for_examples(got_ex, examples),
        jax_pipeline.labels_for_examples(want_ex, examples))


def test_match_labels_and_renaming_equal_jax():
    names = list(jax_extractors.CLASS_NAME_SYNONYMS) + ["person", "dog"]
    assert (extractors.replace_class_names(names)
            == jax_extractors.replace_class_names(names))
    assert extractors.CLASS_NAME_SYNONYMS == jax_extractors.CLASS_NAME_SYNONYMS
    name2id = {"a": 0, "b": 2}
    texts = [["a", "b", "a"], ["c"], []]
    np.testing.assert_array_equal(
        extractors.match_labels(texts, name2id, 3),
        jax_extractors.match_labels(texts, name2id, 3))


def test_no_extractor_raises():
    with pytest.raises(ValueError, match="Invalid label extractor"):
        extractors.build_label_extractor(schema.LabelExtractor())


# -- the text-model kinds ------------------------------------------------------

SYNTHETIC_WORDS = ["person", "bird", "table", "man", "goose", "desk",
                   "xyzzy"]


def _synthetic_vocab(directory):
    """tests/test_extractors.py's vocabulary: class axes 0-2, near
    synonyms, one unrelated word."""
    emb = np.zeros((len(SYNTHETIC_WORDS), 8), np.float32)
    emb[0, 0] = emb[1, 1] = emb[2, 2] = 1.0
    emb[3] = [0.9, 0.1, 0, 0, 0, 0, 0, 0]
    emb[4] = [0.1, 0.9, 0, 0, 0, 0, 0, 0]
    emb[5] = [0, 0.1, 0.9, 0, 0, 0, 0, 0]
    emb[6, 7] = 1.0
    return _write_vocab(directory, SYNTHETIC_WORDS, emb,
                        ["person", "bird", "dining table"])


def _coco_vocab(directory, dims=16):
    """data/coco_open_vocab.txt and data/coco_label.txt with a seeded
    stand-in for the GloVe table (the 300-d file is not in the repo)."""
    words = jax_vocab.load_lines("data/coco_open_vocab.txt")
    emb = np.random.default_rng(0).standard_normal(
        (len(words), dims)).astype(np.float32)
    return _write_vocab(directory, words, emb,
                        jax_vocab.load_lines("data/coco_label.txt"))


def _write_vocab(directory, words, emb, classes):
    vocab_file = directory / "open_vocab.txt"
    vocab_file.write_text("\n".join(words))
    emb_file = directory / "emb.npy"
    np.save(emb_file, emb)
    label_file = directory / "labels.txt"
    label_file.write_text("\n".join(classes))
    return {"label_file": str(label_file),
            "open_vocabulary_file": str(vocab_file),
            "open_vocabulary_word_embedding_file": str(emb_file),
            "words": words, "classes": classes}


def _text_config(pkg, kind, vocab, **extra):
    fields = {k: vocab[k] for k in ("label_file", "open_vocabulary_file",
                                    "open_vocabulary_word_embedding_file")}
    fields.update(extra)
    return pkg.LabelExtractor.from_dict({kind: fields})


def _captions(vocab, rng, n=300):
    """Token lists over the vocabulary, the class names (renamed and not),
    OOV words and empty captions."""
    pool = (list(vocab["words"]) + list(vocab["classes"])
            + jax_extractors.replace_class_names(vocab["classes"])
            + ["unicorn", "", "zebra-ish"])
    texts = [[], ["unicorn"], ["man"], ["goose", "desk"]]
    texts += [[pool[i] for i in rng.integers(0, len(pool),
                                             rng.integers(1, 9))]
              for _ in range(n)]
    return texts


@pytest.mark.parametrize("which", ["synthetic", "coco"])
def test_word_vector_labels_equal_jax(which, tmp_path):
    vocab = (_synthetic_vocab if which == "synthetic" else _coco_vocab)(
        tmp_path)
    kind = "word_vector_match_extractor"
    want_ex = jax_extractors.build_label_extractor(
        _text_config(jax_schema, kind, vocab), seed=1)
    got_ex = extractors.build_label_extractor(
        _text_config(schema, kind, vocab), seed=1)
    assert got_ex.classes == want_ex.classes
    texts = _captions(vocab, np.random.default_rng(0))
    got, want = got_ex.extract_labels(texts), want_ex.extract_labels(texts)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Exact matches, cosine fallbacks and empty rows all occur.
    exact = jax_extractors.match_labels(
        texts, {c: i for i, c in enumerate(
            jax_extractors.replace_class_names(vocab["classes"]))},
        len(vocab["classes"]))
    assert exact.any(1).sum() < got.any(1).sum() < len(texts)
    if which == "synthetic":
        np.testing.assert_array_equal(got[:4], [[0, 0, 0], [0, 0, 0],
                                                [1, 0, 0], [0, 1, 0]])


def test_word_vector_raises_for_a_class_without_a_vector(tmp_path):
    vocab = _synthetic_vocab(tmp_path)
    (tmp_path / "bad.txt").write_text("notinvocab")
    vocab["label_file"] = str(tmp_path / "bad.txt")
    for pkg, module in ((jax_schema, jax_extractors), (schema, extractors)):
        with pytest.raises(ValueError, match="no vector representation"):
            module.build_label_extractor(_text_config(
                pkg, "word_vector_match_extractor", vocab))


def _classifier_tree(got_ex, seed):
    """A seeded JAX-layout classifier tree with logits spread around 0."""
    tree = got_ex.init_params_numpy(seed)
    tree["text_classifier"]["layer2"]["weights"] *= 4.0
    tree["text_classifier"]["layer2"]["biases"][:] = -1.0
    return tree


# The classifier rows' least |sigmoid(logit) - threshold| must exceed both
# this floor and MARGIN_OVER_GAP times the largest |sigmoid| gap between
# the two packages' logits (float32 products summed in another order), so
# that no label sits where the two could round it apart.
MARGIN_FLOOR = 1e-6
MARGIN_OVER_GAP = 10.0


@pytest.mark.parametrize("which", ["synthetic", "coco"])
def test_text_classifier_labels_equal_jax(which, tmp_path):
    vocab = (_synthetic_vocab if which == "synthetic" else _coco_vocab)(
        tmp_path)
    kind = "text_classifier_match_extractor"
    extra = {"hidden_units": 12, "label_threshold": 0.6}
    want_ex = jax_extractors.build_label_extractor(
        _text_config(jax_schema, kind, vocab, **extra))
    got_ex = extractors.build_label_extractor(
        _text_config(schema, kind, vocab, **extra), device="cpu")
    np.testing.assert_array_equal(got_ex.embedding_table,
                                  want_ex.embedding_table)
    tree = _classifier_tree(got_ex, 3)
    want_ex.set_params(tree)
    got_ex.set_params(params_lib.from_jax_numpy(tree, "cpu"))

    texts = _captions(vocab, np.random.default_rng(1))
    np.testing.assert_array_equal(got_ex.encode_tokens(texts),
                                  want_ex.encode_tokens(texts))
    got, want = got_ex.extract_labels(texts), want_ex.extract_labels(texts)
    np.testing.assert_array_equal(got, want)
    ids = got_ex.encode_tokens(texts)
    probas = 1 / (1 + np.exp(-got_ex.predict_logits(ids).numpy()))
    want_probas = 1 / (1 + np.exp(-np.asarray(want_ex.predict_logits(ids))))
    exact = jax_extractors.match_labels(
        texts, {c: i for i, c in enumerate(vocab["classes"])},
        len(vocab["classes"])).any(1)
    margin = np.abs(probas[~exact] - 0.6).min()
    gap = np.abs(probas - want_probas).max()
    assert margin > max(MARGIN_FLOOR, MARGIN_OVER_GAP * gap), (margin, gap)
    # The classifier labels rows that have no exact match.
    assert got[~exact].any() and (got[~exact] != 0).sum() < got[~exact].size


@pytest.fixture(scope="module")
def text_run(tmp_path_factory):
    """Checkpoints of the port's text-model train() on the CPU (8 steps,
    one save at step 8) over captions of the synthetic vocabulary's
    words."""
    from cap2det_tpu_torch.data import synthetic
    from cap2det_tpu_torch.train import trainer

    d = tmp_path_factory.mktemp("text_run")
    vocab = _synthetic_vocab(d)
    record = str(d / "text.record")
    synthetic.write_synthetic_dataset(
        record, num_examples=16, seed=4, classes=["person", "bird", "man"],
        with_image=False)
    text = """
    train_reader { cap2det_reader {
      decode_image: false input_pattern: "%(record)s" is_training: true
      shuffle_buffer_size: 4 batch_size: 4 } }
    model { [TextModel.ext] {
      label_extractor { label_file: '%(label_file)s' }
      text_classifier {
        label_file: '%(label_file)s'
        open_vocabulary_file: '%(open_vocabulary_file)s'
        open_vocabulary_word_embedding_file:
          '%(open_vocabulary_word_embedding_file)s'
        hidden_units: 8 dropout_keep_proba: 0.5 label_threshold: 0.5 } } }
    train_config { max_steps: 8 learning_rate: 0.5 optimizer { adagrad {} }
      save_checkpoints_steps: 100 log_step_count_steps: 4 }
    """ % dict(vocab, record=record)
    model_dir = str(d / "model")
    state = trainer.train(schema.loads_pipeline(text), model_dir=model_dir,
                          device="cpu")
    return vocab, model_dir, state


@pytest.mark.parametrize("layout", ["model_dir", "step_dir", "save_params"])
def test_text_classifier_warm_starts_from_the_ports_train(text_run, layout,
                                                         tmp_path):
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    vocab, model_dir, state = text_run
    path = {"model_dir": model_dir,
            "step_dir": ckpt_lib.latest_checkpoint(model_dir)[1],
            "save_params": str(tmp_path / "params.pt")}[layout]
    if layout == "save_params":
        ckpt_lib.save_params(path, state["params"])
    cfg = _text_config(schema, "text_classifier_match_extractor", vocab,
                       text_classifier_checkpoint_file=path, hidden_units=8,
                       label_threshold=0.5)
    ex = extractors.build_label_extractor(cfg, device="cpu")
    texts = _captions(vocab, np.random.default_rng(2), n=40)
    got = ex.extract_labels(texts)  # loads the checkpoint
    params = ex._params
    for (p, g), (_, w) in zip(
            optimizers.flatten_params(params),
            optimizers.flatten_params(state["params"])):
        assert torch.equal(g, w), p
    # The JAX extractor with the same params gives the same labels.
    want_ex = jax_extractors.build_label_extractor(_text_config(
        jax_schema, "text_classifier_match_extractor", vocab,
        hidden_units=8, label_threshold=0.5))
    want_ex.set_params(params_lib.to_jax_numpy(state["params"]))
    np.testing.assert_array_equal(got, want_ex.extract_labels(texts))


def test_text_classifier_is_lazy_and_needs_a_card_unless_asked(text_run):
    """Built and pickled without loading its checkpoint (the feed's worker
    loads it at the first batch); "cuda" by default."""
    import pickle

    vocab, model_dir, _ = text_run
    cfg = _text_config(schema, "text_classifier_match_extractor", vocab,
                       text_classifier_checkpoint_file=model_dir,
                       hidden_units=8)
    ex = extractors.build_label_extractor(cfg, device="cpu")
    assert ex._params is None
    copy = pickle.loads(pickle.dumps(ex))
    np.testing.assert_array_equal(copy.extract_labels([["man"], ["goose"]]),
                                  ex.extract_labels([["man"], ["goose"]]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extractors.build_label_extractor(cfg)
