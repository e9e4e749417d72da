"""Label-file loading (the port's copy of the class-list part of
``cap2det_tpu/text/vocab.py``).

File formats are the reference's: one class per line for label files,
``class<TAB>syn1,syn2,...`` for synonym tables.
"""

from __future__ import annotations

import os


def load_lines(path):
    """Reads a newline-delimited file, stripping only the trailing newline.

    Raises FileNotFoundError naming the path when the file is missing.
    """
    if not os.path.isfile(path):
        raise FileNotFoundError("label file not found: %r" % (path,))
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
