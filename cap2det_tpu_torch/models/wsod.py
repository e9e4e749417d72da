"""Weakly-supervised detection heads (port of ``cap2det_tpu/models/wsod.py``,
inference): the FC layer and the MIDN head. OICR target assignment and
loss wait for the training step.

MIDN, per proposal p and class c:

  proba_r_given_c = masked-softmax over proposals of W_det features
  class_logits    = sum_p proba_r_given_c * W_cls features
  proposal_scores = sigmoid(class_logits) * proba_r_given_c
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cap2det_tpu_torch.ops import masked
from cap2det_tpu_torch.params import truncated_normal


def init_fc_numpy(rng, in_dim, out_dim, stddev=0.01):
    """JAX-layout FC params ([in, out] weights, zero bias)."""
    return {
        "weights": truncated_normal(rng, (in_dim, out_dim), stddev),
        "biases": np.zeros((out_dim,), np.float32),
    }


def fc(params, x):
    """x @ W + b with the port's [out, in] weight layout."""
    return F.linear(x, params["weights"], params["biases"])


def midn_head(params, proposal_features, proposal_mask):
    """Multiple-instance detection network.

    Args:
      params: {'proba_r_given_c': fc, 'proba_c_given_r': fc}.
      proposal_features: [B, P, D].
      proposal_mask: [B, P] float (1 = real proposal).

    Returns:
      class_logits [B, C], proposal_scores [B, P, C], proba_r_given_c
      [B, P, C].
    """
    mask = proposal_mask[..., None]
    logits_r_given_c = fc(params["proba_r_given_c"], proposal_features)
    logits_c_given_r = fc(params["proba_c_given_r"], proposal_features)

    proba_r_given_c = masked.masked_softmax(
        mask * logits_r_given_c, mask, dim=1
    )
    proba_r_given_c = mask * proba_r_given_c

    class_logits = masked.masked_sum(
        logits_c_given_r * proba_r_given_c, mask, dim=1, keepdim=False
    )  # [B, C]
    proposal_scores = torch.sigmoid(class_logits)[:, None, :] * proba_r_given_c
    return class_logits, proposal_scores, proba_r_given_c
