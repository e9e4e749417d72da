"""The port's Treebank tokenizer against nltk's ``TreebankWordTokenizer``
token for token, on lowercased strings drawn by hypothesis from an
alphabet rich in the rules' triggers (quotes, final periods, ``...``,
``--``, brackets, contractions) and on a fixed caption list; and
``pack_captions`` of strings against the JAX package's. The port itself
imports no nltk (``tests/test_torch_no_jax_imports.py``)."""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cap2det_tpu.text import tokenize as jax_tokenize
from cap2det_tpu_torch.text import tokenize

nltk_treebank = pytest.importorskip("nltk.tokenize.treebank")

torch.set_num_threads(1)

TREEBANK = nltk_treebank.TreebankWordTokenizer()

CAPTIONS = [
    "A man riding a wave on top of a surfboard.",
    "Two dogs playing with a frisbee in the park...",
    "A cat sitting on a laptop -- it's \"working\".",
    "The kids can't stop laughing; they're gonna fall!",
    "I cannot believe 'tis a 3.88 $ hot-dog (really) [sic] {ok} <b>",
    "'Twas a giraffe, eating leaves: yum.",
    "A ''quoted'' word and a `backtick` and ``double''",
    "She'll say I'm wrong, we'd go, you've seen, he's here, d'ye know?",
    "Gimme the ball, lemme see, gotta go, wanna eat more'n this.",
    "A zebra.  Another zebra.",
    "ends with a quote.'",
    "ends with a period and bracket.)",
    "commas,between,words and 3,000 numbers: 10:30 pm",
    "",
    "   ",
    "@home #1 50% & more",
    "a traffic light at a stop sign",
]

# The rules' triggers, as characters and as fragments.
_PIECES = (list("abcdegilmnorstwy '\".,:;?!-()[]{}<>$%&@#`0123\n\t")
           + ["can", "not", "gon", "na", "got", "ta", "gim", "me", "lem",
              "'tis", "'twas", "wan", "more'n", "d'ye", "...", "--", "''",
              "``", "n't", "'s", "'ll", "'re", "'ve", "'m", "'d", "."])


@pytest.mark.parametrize("caption", CAPTIONS)
def test_captions_equal_nltk(caption):
    lowered = caption.lower()
    assert tokenize.tokenize_caption(caption) == TREEBANK.tokenize(lowered)


@settings(max_examples=3000, deadline=None)
@given(st.lists(st.sampled_from(_PIECES), max_size=40).map("".join))
def test_generated_strings_equal_nltk(text):
    lowered = text.lower()
    assert tokenize.treebank_tokenize(lowered) == TREEBANK.tokenize(lowered)


@settings(max_examples=500, deadline=None)
@given(st.text(max_size=40))
def test_any_text_equals_nltk(text):
    lowered = text.lower()
    assert tokenize.tokenize_caption(text) == TREEBANK.tokenize(lowered)


def test_pack_captions_equals_jax():
    captions = CAPTIONS + [["pre", "tokenized", "list"], []]
    assert tokenize.pack_captions(captions) == jax_tokenize.pack_captions(
        captions)
