"""Caption tokenization for dataset building (the port's copy of
``cap2det_tpu/text/tokenize.py``).

The reference tokenizes lowercased captions with NLTK's
``TreebankWordTokenizer`` (dataset-tools/create_coco_tf_record.py). The
port keeps its own copy of that tokenizer's rules, so it needs no nltk:
the regular expressions and their order are those of
``nltk.tokenize.treebank.TreebankWordTokenizer.tokenize`` and
``nltk.tokenize.destructive.MacIntyreContractions`` in NLTK 3.10
(Copyright (C) 2001-2026 NLTK Project, Apache License 2.0), with
``convert_parentheses`` off, as the reference calls it:

  starting quotes -> punctuation -> parens and brackets -> double dashes
  -> ending quotes (on the text padded with a space at each end) ->
  MacIntyre contractions 2 and 3 -> split on whitespace.
"""

from __future__ import annotations

import re

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # The final period.
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")

_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")

_ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

# Robert MacIntyre's contractions; the fourth list stays unused, as in
# the sed script the rules come from.
_CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
)]
_CONTRACTIONS3 = [re.compile(p) for p in (
    r"(?i) ('t)(?#X)(is)\b",
    r"(?i) ('t)(?#X)(was)\b",
)]


def treebank_tokenize(text):
    """Tokens of `text` by the Penn Treebank rules, as
    ``TreebankWordTokenizer().tokenize(text)`` gives them."""
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)
    regexp, substitution = _PARENS_BRACKETS
    text = regexp.sub(substitution, text)
    regexp, substitution = _DOUBLE_DASHES
    text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def tokenize_caption(caption):
    """Lowercases and tokenizes one caption string."""
    return treebank_tokenize(caption.lower())


def pack_captions(captions):
    """Packs captions (strings, tokenized here, or token lists) into the
    TFRecord token-buffer framing (buffer + per-caption offset/length;
    reference create_coco_tf_record.py:79-87)."""
    tokens, offsets, lengths = [], [], []
    for cap in captions:
        toks = tokenize_caption(cap) if isinstance(cap, str) else list(cap)
        offsets.append(len(tokens))
        lengths.append(len(toks))
        tokens.extend(toks)
    return tokens, offsets, lengths
