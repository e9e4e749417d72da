"""Caption packing for record building (the port's copy of
``pack_captions`` in ``cap2det_tpu/text/tokenize.py``).

Captions arrive as token lists. Tokenizing a caption string needs the
Treebank rules, which the port does not have yet (ROADMAP.md queue 1 item
4), so a string caption raises.
"""

from __future__ import annotations


def pack_captions(captions):
    """Packs token lists into the TFRecord token-buffer framing
    (buffer + per-caption offset/length; reference
    create_coco_tf_record.py:79-87)."""
    tokens, offsets, lengths = [], [], []
    for cap in captions:
        if isinstance(cap, str):
            raise NotImplementedError(
                "pack_captions: caption %r is a string; the port packs token "
                "lists only until its tokenizer is ported (ROADMAP.md queue "
                "1 item 4)" % (cap,))
        toks = list(cap)
        offsets.append(len(tokens))
        lengths.append(len(toks))
        tokens.extend(toks)
    return tokens, offsets, lengths
