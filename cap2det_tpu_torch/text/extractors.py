"""Caption -> image-level label extractors (the port's copy of the
string-matching part of ``cap2det_tpu/text/extractors.py``).

String matching runs on the host in the input pipeline and emits dense
[batch, num_classes] float32 multi-hot labels, the reference's in-graph
lookups (models/label_extractor.py:71-504):

  * Groundtruth -- vocabulary match over ground-truth object texts.
  * ExactMatch  -- vocabulary match over caption tokens, after the
                   15-entry multiword->singleword class renaming.
  * ExtendMatch -- synonym-table match (data/coco_label_synonyms.txt).

The two text-model kinds (word_vector_match, text_classifier_match) need
embeddings and a text classifier that the port does not have yet
(ROADMAP.md queue 1 item 4): they give their class list, so serving their
configs works, and raise when asked for labels.
"""

from __future__ import annotations

import numpy as np

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.text import vocab as vocab_lib

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


class ClassList(LabelExtractorBase):
    """The class list of a text-model extractor kind, without labels."""

    def __init__(self, classes, kind):
        super().__init__(classes)
        self._kind = kind

    def extract_labels(self, texts):
        raise NotImplementedError(
            "%s needs the text model, which the port does not have yet "
            "(ROADMAP.md queue 1 item 4)" % self._kind)


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


def build_label_extractor(config: schema.LabelExtractor):
    """Factory dispatching on the oneof (reference :475-504); raises when
    the config names no extractor or its label file is missing."""
    which = config.which_oneof() if config is not None else None
    if which == "groundtruth_extractor":
        return GroundtruthExtractor(config.groundtruth_extractor)
    if which == "exact_match_extractor":
        return ExactMatchExtractor(config.exact_match_extractor)
    if which == "extend_match_extractor":
        return ExtendMatchExtractor(config.extend_match_extractor)
    if which in ("word_vector_match_extractor",
                 "text_classifier_match_extractor"):
        return ClassList(
            vocab_lib.load_lines(getattr(config, which).label_file), which)
    raise ValueError("Invalid label extractor %r" % which)
