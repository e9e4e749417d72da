"""Text classifier: frozen word embeddings -> FC -> masked max-pool -> ReLU
-> dropout -> FC(num_classes) (port of ``cap2det_tpu/text/classifier.py``;
reference models/label_extractor.py:353-421).

Params are the JAX package's nested dict with its names, each leaf in the
port's layout (``params.from_jax_numpy``): FC weights [out, in] for
``F.linear``, and the word-embedding table [dims, vocab + 1], the
transpose of the JAX [vocab + 1, dims], read through its transpose. The
table (GloVe + one random OOV row, init_width 0.03; reference :373-377)
is part of the params but never trained: the trainer freezes it by path
(``TextModel.non_trainable_paths``), so no gradient is made for it.

The products stay ``F.embedding`` / ``F.linear``: the JAX classifier
reaches no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cap2det_tpu_torch.models.frcnn import dropout
from cap2det_tpu_torch.ops import masked


def build_embedding_table(word_embeddings, seed=0, init_width=0.03):
    """GloVe table with an appended random OOV row (reference :274-276),
    drawn from ``np.random.RandomState(seed)`` as the JAX package draws
    it, so both build the same table."""
    rng = np.random.RandomState(seed)
    oov = init_width * (rng.rand(1, word_embeddings.shape[-1]) * 2 - 1)
    return np.concatenate([word_embeddings, oov], axis=0).astype(np.float32)


def glorot_uniform(rng, fan_in, fan_out):
    """[fan_in, fan_out] float32 glorot-uniform draws from numpy `rng`."""
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, (fan_in, fan_out)).astype(np.float32)


def init_params_numpy(seed_or_rng, vocab_size_with_oov, embedding_dims,
                      hidden_units, num_classes, embedding_table=None):
    """Classifier params as a JAX-layout numpy tree, with the names and
    shapes of the JAX ``init_params``. The FC weights are glorot-uniform
    from a seeded numpy generator (JAX draws them with ``jax.random``, so
    parity tests carry one side's weights to the other); the biases are
    zero; the table is `embedding_table` or zeros."""
    rng = np.random.default_rng(seed_or_rng)
    if embedding_table is None:
        embedding_table = np.zeros((vocab_size_with_oov, embedding_dims),
                                   np.float32)
    return {
        "word_embedding": {
            "weights": np.asarray(embedding_table, np.float32)},
        "text_classifier": {
            "layer1": {
                "weights": glorot_uniform(rng, embedding_dims, hidden_units),
                "biases": np.zeros((hidden_units,), np.float32),
            },
            "layer2": {
                "weights": glorot_uniform(rng, hidden_units, num_classes),
                "biases": np.zeros((num_classes,), np.float32),
            },
        },
    }


def apply(params, token_ids, oov_id, *, dropout_keep_proba=1.0,
          is_training=False, generator=None):
    """Runs the classifier.

    Args:
      params: port-layout tree (see the module docstring).
      token_ids: [batch, num_tokens] int tensor (OOV/padding slots =
        oov_id), on the params' device.
      oov_id: the out-of-vocabulary id (== vocab size).
      generator: the dropout's ``torch.Generator`` when training with
        dropout_keep_proba < 1.

    Returns:
      logits: [batch, num_classes].
    """
    emb = params["word_embedding"]["weights"]
    tc = params["text_classifier"]
    token_embs = F.embedding(token_ids, emb.t())  # [B, T, D]
    mask = (token_ids != oov_id).to(torch.float32)  # [B, T]

    hidden = F.linear(token_embs, tc["layer1"]["weights"],
                      tc["layer1"]["biases"])
    pooled = masked.masked_maximum(hidden, mask[..., None], dim=1,
                                   keepdim=False)
    pooled = torch.relu(pooled)
    if is_training and dropout_keep_proba < 1.0:
        pooled = dropout(pooled, dropout_keep_proba, generator)
    return F.linear(pooled, tc["layer2"]["weights"], tc["layer2"]["biases"])
