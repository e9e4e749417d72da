"""Weakly-supervised detection heads (port of ``cap2det_tpu/models/wsod.py``):
the FC layer, the MIDN head, and OICR's target assignment and loss.

MIDN, per proposal p and class c:

  proba_r_given_c = masked-softmax over proposals of W_det features
  class_logits    = sum_p proba_r_given_c * W_cls features
  proposal_scores = sigmoid(class_logits) * proba_r_given_c

OICR, refinement k: the previous scores seed each class's most confident
proposal; proposals with IoU >= threshold against it (gated on the image
label) are that class's positives, the rest background; the row-normalized
targets are detached and trained with softmax CE, averaged over the real
proposals.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cap2det_tpu_torch.ops import boxes as box_ops
from cap2det_tpu_torch.ops import losses as loss_ops
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


def oicr_target_assignment(labels, proposals, scores_prev, proposal_mask,
                           iou_threshold):
    """Pseudo-label distribution for one OICR refinement.

    Args:
      labels: [B, C] image-level multi-hot.
      proposals: [B, P, 4].
      scores_prev: [B, P, 1+C] previous-iteration scores (col 0 = bkg).
      proposal_mask: [B, P] float.

    Returns:
      [B, P, 1+C] row-normalized targets: per class, the proposals with
      IoU >= threshold against the class's most confident (masked-argmax)
      proposal, gated on the label; background where no class fires.
    """
    seed_idx = masked.masked_argmax(
        scores_prev[:, :, 1:], proposal_mask[..., None], dim=1
    )  # [B, C]
    seed_boxes = torch.gather(
        proposals, 1, seed_idx[..., None].expand(-1, -1, 4)
    )  # [B, C, 4]
    iou = box_ops.pairwise_iou(proposals, seed_boxes)  # [B, P, C]
    target = (iou >= iou_threshold).float() * (labels[:, None, :] > 0)
    bkg = (target.sum(dim=-1, keepdim=True) <= 0).float()
    proposal_labels = torch.cat([bkg, target], dim=-1)
    return proposal_labels / proposal_labels.sum(dim=-1, keepdim=True)


def oicr_loss(labels, proposals, scores_prev, scores_next, proposal_mask,
              iou_threshold=0.5):
    """One refinement's softmax CE against detached targets, averaged
    over the real proposals, then over the batch."""
    targets = oicr_target_assignment(labels, proposals, scores_prev.detach(),
                                     proposal_mask, iou_threshold)
    ce = loss_ops.softmax_cross_entropy(targets.detach(), scores_next)
    return masked.masked_avg(ce, proposal_mask, dim=1).mean()
