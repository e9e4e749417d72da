"""Builds the open vocabulary + GloVe embedding table from caption data
(the port's counterpart of ``tools/create_vocab.py``, same flags and same
files; captions are tokenized by the port's Treebank rules,
``text/tokenize.py``).

Mirrors dataset-tools/create_coco_vocab.py:76-111 (and the flickr30k
twin): count caption tokens, keep tokens with frequency >= min_word_freq
that also have a GloVe vector, write ``vocab.txt`` (one word per line,
frequency order) and a ``[V, dims]`` float ``.npy`` embedding matrix
aligned with it.

Usage:
  python -m cap2det_tpu_torch.tools.create_vocab \
      --caption_annotations_file annotations/captions_train2017.json \
      --glove_file zoo/glove.6B.300d.txt \
      --output_vocabulary_file data/coco_open_vocab.txt \
      --output_vocabulary_word_embedding_file data/coco_open_vocab_300d.npy \
      --min_word_freq 10
"""

from __future__ import annotations

import argparse
import collections
import json
import logging

import numpy as np

from cap2det_tpu_torch.text.tokenize import tokenize_caption

log = logging.getLogger("create_vocab")


def load_glove(path, expected_dims=None):
    """Parses a GloVe text file -> {word: np.array[dims]}.

    Robust to multi-token keys (glove.840B has entries like '. . .'):
    the vector is the LAST `dims` fields, the word is everything before,
    with dims inferred from the first line when not given. Malformed
    lines are skipped with a count.
    """
    table = {}
    skipped = 0
    dims = expected_dims
    with open(path, encoding="utf-8") as fid:
        for line in fid:
            parts = line.rstrip("\n").split(" ")
            if dims is None:
                dims = len(parts) - 1
            if len(parts) < dims + 1:
                skipped += 1
                continue
            word = " ".join(parts[:-dims])
            try:
                vec = np.asarray(parts[-dims:], np.float32)
            except ValueError:
                skipped += 1
                continue
            table[word] = vec
    if skipped:
        log.warning("load_glove: skipped %d malformed lines", skipped)
    return table


def count_caption_tokens(caption_file):
    counts = collections.Counter()
    with open(caption_file) as fid:
        data = json.load(fid)
    anns = data["annotations"] if isinstance(data, dict) else data
    for ann in anns:
        caption = ann["caption"] if isinstance(ann, dict) else ann
        counts.update(tokenize_caption(caption))
    return counts


def count_tokens_from_tsv(token_file):
    counts = collections.Counter()
    with open(token_file, encoding="utf-8") as fid:
        for line in fid:
            line = line.strip()
            if not line:
                continue
            _, caption = line.split("\t", 1)
            counts.update(tokenize_caption(caption))
    return counts


def build_vocab(counts, glove, min_word_freq=10):
    """Frequency-ordered words with freq >= threshold and a GloVe vector."""
    words = [
        w
        for w, c in counts.most_common()
        if c >= min_word_freq and w in glove
    ]
    embeddings = np.stack([glove[w] for w in words]) if words else np.zeros(
        (0, 300), np.float32
    )
    return words, embeddings.astype(np.float32)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--caption_annotations_file", default=None,
                        help="COCO captions json")
    parser.add_argument("--caption_tsv_file", default=None,
                        help="Flickr30k results_20130124.token")
    parser.add_argument("--glove_file", required=True)
    parser.add_argument("--output_vocabulary_file", required=True)
    parser.add_argument("--output_vocabulary_word_embedding_file", required=True)
    parser.add_argument("--min_word_freq", type=int, default=10)
    args = parser.parse_args(argv)

    if args.caption_annotations_file:
        counts = count_caption_tokens(args.caption_annotations_file)
    elif args.caption_tsv_file:
        counts = count_tokens_from_tsv(args.caption_tsv_file)
    else:
        raise SystemExit("need --caption_annotations_file or --caption_tsv_file")

    glove = load_glove(args.glove_file)
    words, embeddings = build_vocab(counts, glove, args.min_word_freq)
    with open(args.output_vocabulary_file, "w") as fid:
        fid.write("\n".join(words))
    np.save(args.output_vocabulary_word_embedding_file, embeddings)
    log.info("vocab size %d, embedding %s", len(words), embeddings.shape)
    return words, embeddings


if __name__ == "__main__":
    main()
