"""Vocabulary, embedding-table and label-file loading (the port's copy of
``cap2det_tpu/text/vocab.py``).

File formats are the reference's, so its data artifacts are
interchangeable: one class/word per line for label and vocabulary files
(models/label_extractor.py:105-107,225-228), ``class<TAB>syn1,syn2,...``
for synonym tables, and a ``np.load``-able [vocab_size, embedding_dims]
array for the GloVe table (protos/label_extractor.proto:30-35).
"""

from __future__ import annotations

import os

import numpy as np


def _require_file(path):
    if not os.path.isfile(path):
        raise FileNotFoundError("file not found: %r" % (path,))


def load_lines(path):
    """Reads a newline-delimited file, stripping only the trailing newline.

    Raises FileNotFoundError naming the path when the file is missing.
    """
    _require_file(path)
    with open(path, "r") as fid:
        return [line.rstrip("\n") for line in fid.readlines()]


def load_synonym_table(path):
    """Reads a tab-separated ``class<TAB>syn1,syn2,...`` table.

    Returns:
      classes: ordered class names.
      name2id: mapping from class name and every synonym to class id.
    """
    classes = []
    name2id = {}
    for class_id, line in enumerate(load_lines(path)):
        if not line:
            continue
        class_name, synonyms = line.split("\t")
        classes.append(class_name)
        name2id[class_name] = class_id
        for synonym in synonyms.split(","):
            if synonym:
                name2id[synonym] = class_id
    return classes, name2id


def load_embeddings(path):
    """Loads a [vocab_size, dims] float array saved with np.save; raises
    FileNotFoundError naming the path when the file is missing."""
    _require_file(path)
    with open(path, "rb") as fid:
        return np.load(fid)


class Vocabulary:
    """String -> contiguous id mapping with a single out-of-vocabulary id.

    The OOV id equals ``len(words)``, matching the reference's
    ``index_table_from_tensor(..., num_oov_buckets=1)``
    (models/label_extractor.py:272-273).
    """

    def __init__(self, words):
        self.words = list(words)
        self._index = {w: i for i, w in enumerate(self.words)}
        self.oov_id = len(self.words)

    @classmethod
    def from_file(cls, path):
        return cls(load_lines(path))

    def __len__(self):
        return len(self.words)

    def lookup(self, token):
        return self._index.get(token, self.oov_id)

    def encode(self, tokens):
        """Encodes a nested list/array of tokens to an int32 id array."""
        arr = np.asarray(tokens, dtype=object)
        out = np.empty(arr.shape, dtype=np.int32)
        flat_in = arr.reshape(-1)
        flat_out = out.reshape(-1)
        for i, tok in enumerate(flat_in):
            flat_out[i] = self._index.get(tok, self.oov_id)
        return out


def pad_token_matrix(texts, pad=""):
    """Pads a list of token lists to a dense [batch, max_len] object array."""
    max_len = max((len(t) for t in texts), default=0)
    out = np.full((len(texts), max_len), pad, dtype=object)
    for i, t in enumerate(texts):
        out[i, : len(t)] = t
    return out
