"""Class lists of the configured label extractor.

Serving needs only ``classes`` and ``num_classes``; extracting labels from
captions is a training concern and is not ported yet. The class list comes
from the extractor's label file exactly as in
``cap2det_tpu/text/extractors.py``: a synonym table for
``extend_match_extractor``, one class per line for every other kind.
"""

from __future__ import annotations

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.text import vocab as vocab_lib

_LINE_FILE_KINDS = (
    "groundtruth_extractor",
    "exact_match_extractor",
    "word_vector_match_extractor",
    "text_classifier_match_extractor",
)


class ClassList:
    def __init__(self, classes):
        self._classes = list(classes)

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self):
        return len(self._classes)


def build_label_extractor(config: schema.LabelExtractor):
    """Class list of a LabelExtractor config; raises when the config names
    no extractor or its label file is missing."""
    which = config.which_oneof() if config is not None else None
    if which == "extend_match_extractor":
        classes, _ = vocab_lib.load_synonym_table(
            config.extend_match_extractor.label_file
        )
        return ClassList(classes)
    if which in _LINE_FILE_KINDS:
        return ClassList(
            vocab_lib.load_lines(getattr(config, which).label_file)
        )
    raise ValueError("Invalid label extractor %r" % which)
