"""The port's string-matching label extractors against the JAX package's,
on the repo's label files, with multiword and out-of-vocabulary tokens."""

import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import pipeline as jax_pipeline
from cap2det_tpu.text import extractors as jax_extractors
from cap2det_tpu.text import vocab as jax_vocab
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline
from cap2det_tpu_torch.text import extractors

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


@pytest.mark.parametrize("kind", ["word_vector_match_extractor",
                                  "text_classifier_match_extractor"])
def test_text_model_kinds_give_classes_and_raise_on_labels(kind):
    ex = extractors.build_label_extractor(
        _config(schema, kind, "data/voc_label.txt"))
    assert ex.classes == jax_vocab.load_lines("data/voc_label.txt")
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        ex.extract_labels([["dog"]])


def test_no_extractor_raises():
    with pytest.raises(ValueError, match="Invalid label extractor"):
        extractors.build_label_extractor(schema.LabelExtractor())
