"""Caption -> image-level label extractors (port of
``cap2det_tpu/text/extractors.py``; reference
models/label_extractor.py:71-504).

Labels are made on the host, in the input pipeline, as dense [batch,
num_classes] float32 multi-hot arrays equal to the reference's in-graph
lookups:

  * Groundtruth     -- vocabulary match over ground-truth object texts.
  * ExactMatch      -- vocabulary match over caption tokens, after the
                       15-entry multiword->singleword class renaming.
  * ExtendMatch     -- synonym-table match (data/coco_label_synonyms.txt).
  * WordVectorMatch -- GloVe cosine top-1 fallback when exact match is
                       empty, in numpy.
  * TextClassifierMatch -- frozen text classifier, sigmoid > threshold,
                       when exact match is empty; the classifier runs on
                       the extractor's device, the threshold in numpy.

Each extractor implements ``extract_labels(texts) -> [batch, C] float32``
where ``texts`` is a list of token lists (captions are pre-tokenized in
the TFRecords). TextClassifierMatch also carries the classifier that the
text model trains.
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.text import classifier as text_classifier
from cap2det_tpu_torch.text import vocab as vocab_lib
from cap2det_tpu_torch.train import checkpoint as ckpt_lib

# Multiword COCO class names -> single caption tokens
# (reference _replace_class_names, models/label_extractor.py:42-68).
CLASS_NAME_SYNONYMS = {
    "traffic light": "stoplight",
    "fire hydrant": "hydrant",
    "stop sign": "sign",
    "parking meter": "meter",
    "sports ball": "ball",
    "baseball bat": "bat",
    "baseball glove": "glove",
    "tennis racket": "racket",
    "wine glass": "wineglass",
    "hot dog": "hotdog",
    "potted plant": "plant",
    "dining table": "table",
    "cell phone": "cellphone",
    "teddy bear": "teddy",
    "hair drier": "hairdryer",
}


def replace_class_names(class_names):
    return [CLASS_NAME_SYNONYMS.get(x, x) for x in class_names]


def match_labels(texts, name2id, num_classes):
    """Multi-hot labels from token lists via a name->class-id map.

    Tokens absent from the map are dropped (OOV), matching the reference's
    one-hot(1+C)/max/drop-last-column construction
    (models/label_extractor.py:15-39).
    """
    labels = np.zeros((len(texts), num_classes), dtype=np.float32)
    for i, tokens in enumerate(texts):
        for tok in tokens:
            class_id = name2id.get(tok)
            if class_id is not None:
                labels[i, class_id] = 1.0
    return labels


class LabelExtractorBase:
    def __init__(self, classes):
        self._classes = list(classes)

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self):
        return len(self._classes)

    def extract_labels(self, texts):
        raise NotImplementedError


class GroundtruthExtractor(LabelExtractorBase):
    """Matches ground-truth object texts against the class list
    (reference models/label_extractor.py:96-121)."""

    def __init__(self, options: schema.GroundtruthExtractor):
        super().__init__(vocab_lib.load_lines(options.label_file))
        self._name2id = {c: i for i, c in enumerate(self._classes)}

    def extract_labels(self, texts):
        return match_labels(texts, self._name2id, self.num_classes)


class ExactMatchExtractor(LabelExtractorBase):
    """Matches caption tokens against renamed class names
    (reference models/label_extractor.py:124-150)."""

    def __init__(self, options: schema.ExactMatchExtractor):
        super().__init__(vocab_lib.load_lines(options.label_file))
        renamed = replace_class_names(self._classes)
        self._name2id = {c: i for i, c in enumerate(renamed)}

    def extract_labels(self, texts):
        return match_labels(texts, self._name2id, self.num_classes)


class ExtendMatchExtractor(LabelExtractorBase):
    """Synonym-table match (reference models/label_extractor.py:153-207)."""

    def __init__(self, options: schema.ExtendMatchExtractor):
        classes, name2id = vocab_lib.load_synonym_table(options.label_file)
        super().__init__(classes)
        self._name2id = name2id

    def extract_labels(self, texts):
        return match_labels(texts, self._name2id, self.num_classes)


class WordVectorMatchExtractor(LabelExtractorBase):
    """Exact match first; else the top-1 GloVe cosine neighbour
    (reference models/label_extractor.py:210-328), in numpy."""

    def __init__(self, options: schema.WordVectorMatchExtractor, seed=0):
        super().__init__(vocab_lib.load_lines(options.label_file))
        self._vocab = vocab_lib.Vocabulary.from_file(
            options.open_vocabulary_file)
        embeddings = vocab_lib.load_embeddings(
            options.open_vocabulary_word_embedding_file)
        self._embedding_table = text_classifier.build_embedding_table(
            embeddings, seed=seed)

        renamed = replace_class_names(self._classes)
        for class_name in renamed:
            if self._vocab.lookup(class_name) == self._vocab.oov_id:
                raise ValueError(
                    "Class %s has no vector representation." % class_name)
        self._exact_name2id = {c: i for i, c in enumerate(renamed)}
        class_ids = np.array([self._vocab.lookup(c) for c in renamed])
        class_embs = self._embedding_table[class_ids]
        self._class_embs_normed = class_embs / np.maximum(
            np.linalg.norm(class_embs, axis=-1, keepdims=True), 1e-12)

    def extract_labels(self, texts):
        labels_exact = match_labels(texts, self._exact_name2id,
                                    self.num_classes)
        out = labels_exact.copy()
        for i, tokens in enumerate(texts):
            if labels_exact[i].any():
                continue
            token_ids = np.array([self._vocab.lookup(t) for t in tokens],
                                 dtype=np.int64)
            valid = token_ids != self._vocab.oov_id
            if not valid.any():
                continue
            token_embs = self._embedding_table[token_ids[valid]]
            token_embs = token_embs / np.maximum(
                np.linalg.norm(token_embs, axis=-1, keepdims=True), 1e-12)
            # [num_valid_tokens, num_classes] cosine similarity.
            similarity = token_embs @ self._class_embs_normed.T
            pooled = similarity.max(axis=0)
            out[i, int(pooled.argmax())] = 1.0
        return out


class TextClassifierMatchExtractor(LabelExtractorBase):
    """Exact match first; else the frozen classifier's sigmoid > threshold
    (reference models/label_extractor.py:331-472).

    The classifier runs on `device` (the card unless the caller asks for
    the CPU). Its params are port-layout tensors on that device, given to
    ``set_params`` or loaded from ``text_classifier_checkpoint_file`` at
    the first ``extract_labels`` (lazily, as the JAX package does): an
    extractor pickled into the feed's worker process carries no tensors
    of the card and loads its checkpoint there.
    """

    def __init__(self, options: schema.TextClassifierMatchExtractor,
                 params=None, seed=0, device="cuda"):
        super().__init__(vocab_lib.load_lines(options.label_file))
        self._options = options
        self._device = params_lib.resolve_device(device)
        self._vocab = vocab_lib.Vocabulary.from_file(
            options.open_vocabulary_file)
        embeddings = vocab_lib.load_embeddings(
            options.open_vocabulary_word_embedding_file)
        self._embedding_table = text_classifier.build_embedding_table(
            embeddings, seed=seed)
        self._exact_name2id = {c: i for i, c in enumerate(self._classes)}
        self._params = params

    @property
    def vocab(self):
        return self._vocab

    @property
    def embedding_table(self):
        return self._embedding_table

    @property
    def options(self):
        return self._options

    @property
    def device(self):
        return self._device

    def init_params_numpy(self, seed):
        """Fresh (trainable) classifier params as a JAX-layout numpy tree,
        the table this extractor built included."""
        return text_classifier.init_params_numpy(
            seed,
            vocab_size_with_oov=self._embedding_table.shape[0],
            embedding_dims=self._embedding_table.shape[1],
            hidden_units=self._options.hidden_units,
            num_classes=self.num_classes,
            embedding_table=self._embedding_table,
        )

    def init_params(self, seed):
        """``init_params_numpy`` as port tensors on the extractor's
        device."""
        return params_lib.from_jax_numpy(self.init_params_numpy(seed),
                                         self._device)

    def set_params(self, params):
        self._params = params

    def load_checkpoint(self):
        """Reads ``text_classifier_checkpoint_file``: a ``save_params``
        file, a checkpoint step dir or a model_dir (its newest step)."""
        tree = ckpt_lib.restore_params(
            self._options.text_classifier_checkpoint_file)
        self.set_params(params_lib.from_jax_numpy(tree, self._device))

    def predict_logits(self, token_ids, params=None, is_training=False,
                       generator=None):
        """[batch, T] token ids -> [batch, C] logits on the extractor's
        device; `generator` draws the dropout when training."""
        params = self._params if params is None else params
        return text_classifier.apply(
            params,
            torch.as_tensor(token_ids, device=self._device),
            self._vocab.oov_id,
            dropout_keep_proba=self._options.dropout_keep_proba,
            is_training=is_training,
            generator=generator,
        )

    def encode_tokens(self, texts, pad_to=None):
        """Host-side token-id encoding; padding slots get the OOV id."""
        max_len = max((len(t) for t in texts), default=1)
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        max_len = max(max_len, 1)
        out = np.full((len(texts), max_len), self._vocab.oov_id,
                      dtype=np.int32)
        for i, tokens in enumerate(texts):
            for j, tok in enumerate(tokens):
                out[i, j] = self._vocab.lookup(tok)
        return out

    @torch.no_grad()
    def extract_labels(self, texts):
        if self._params is None:
            self.load_checkpoint()
        labels_exact = match_labels(texts, self._exact_name2id,
                                    self.num_classes)
        token_ids = self.encode_tokens(texts)
        logits = self.predict_logits(token_ids).cpu().numpy()
        probas = 1.0 / (1.0 + np.exp(-logits))
        labels_likely = (probas > self._options.label_threshold).astype(
            np.float32)
        use_exact = labels_exact.any(axis=-1, keepdims=True)
        return np.where(use_exact, labels_exact, labels_likely)


def build_label_extractor(config: schema.LabelExtractor, **kwargs):
    """Factory dispatching on the oneof (reference :475-504); `kwargs` go
    to the two text-model kinds. Raises when the config names no
    extractor or a file it names is missing."""
    which = config.which_oneof() if config is not None else None
    if which == "groundtruth_extractor":
        return GroundtruthExtractor(config.groundtruth_extractor)
    if which == "exact_match_extractor":
        return ExactMatchExtractor(config.exact_match_extractor)
    if which == "extend_match_extractor":
        return ExtendMatchExtractor(config.extend_match_extractor)
    if which == "word_vector_match_extractor":
        return WordVectorMatchExtractor(config.word_vector_match_extractor,
                                        **kwargs)
    if which == "text_classifier_match_extractor":
        return TextClassifierMatchExtractor(
            config.text_classifier_match_extractor, **kwargs)
    raise ValueError("Invalid label extractor %r" % which)
