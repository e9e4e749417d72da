"""Text-classifier model (port of ``cap2det_tpu/models/text_model.py``).

Trains the GloVe -> FC -> masked-max -> ReLU -> dropout -> FC classifier
against GroundtruthExtractor labels with sigmoid cross-entropy (reference
models/text_model.py:31-129). Its checkpoint warm-starts the
TextClassifierMatchExtractor inside Cap2Det
(models/label_extractor.py:455-457).

The input pipeline supplies token ids and labels (no strings reach the
device); the classifier runs on the model's device ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.models.base import ModelBase
from cap2det_tpu_torch.models.registry import register_model_class
from cap2det_tpu_torch.ops.losses import sigmoid_cross_entropy
from cap2det_tpu_torch.text import extractors as extractors_lib

FIELD_TEXT_LOSS = "text_cross_entropy_loss"


class TextModel(ModelBase):
    non_trainable_paths = ("word_embedding",)

    def __init__(self, options: schema.TextModel, is_training=False,
                 device="cuda", second_stage_remat=False):
        if second_stage_remat:
            raise ValueError("second_stage_remat: the text model has no "
                             "second stage")
        self._options = options
        self._device = params_lib.resolve_device(device)
        self.label_extractor = extractors_lib.GroundtruthExtractor(
            options.label_extractor)
        self.text_classifier = extractors_lib.TextClassifierMatchExtractor(
            options.text_classifier, device=self._device)

    @property
    def options(self):
        return self._options

    @property
    def device(self):
        return self._device

    @property
    def num_classes(self):
        return self.label_extractor.num_classes

    @property
    def vocab(self):
        return self.text_classifier.vocab

    def init_jax_numpy(self, seed):
        """Random params as a JAX-layout numpy tree (the GloVe table with
        its OOV row, glorot-uniform FCs from `seed`)."""
        return self.text_classifier.init_params_numpy(seed)

    def init_params(self, seed):
        """Random params as port tensors on the model's device."""
        return self.text_classifier.init_params(seed)

    def pipeline_kwargs(self):
        """The input pipeline's arguments that the model decides."""
        return {
            "label_extractor": self.label_extractor,
            "vocab": self.text_classifier.vocab,
        }

    def device_batch(self, host_batch):
        """A host text batch -> {"token_ids" [B, T] int32, "labels" [B, C]
        float32} on the model's device."""
        return {
            "token_ids": torch.as_tensor(
                host_batch[InputFields.concat_caption_token_ids],
                device=self._device),
            "labels": torch.as_tensor(
                np.asarray(host_batch[InputFields.pseudo_labels],
                           np.float32), device=self._device),
        }

    def predict_logits(self, params, batch, generator=None,
                       is_training=False):
        return self.text_classifier.predict_logits(
            batch["token_ids"], params=params, is_training=is_training,
            generator=generator)

    def loss(self, params, batch, generator=None, is_training=True):
        """(total, loss_dict): the mean sigmoid CE plus
        regularizer * 1/2 (|W1|^2 + |W2|^2)."""
        logits = self.predict_logits(params, batch, generator=generator,
                                     is_training=is_training)
        ce = sigmoid_cross_entropy(batch["labels"], logits).mean()
        reg_scale = self._options.text_classifier.regularizer
        tc = params["text_classifier"]
        reg = reg_scale * 0.5 * (
            torch.sum(torch.square(tc["layer1"]["weights"]))
            + torch.sum(torch.square(tc["layer2"]["weights"])))
        total = ce + reg
        return total, {FIELD_TEXT_LOSS: ce, "regularization_loss": reg}

    # -- evaluation -----------------------------------------------------------

    def make_metrics(self):
        return _TextMetrics()

    @torch.no_grad()
    def evaluate_batch(self, metrics, params, batch):
        logits = self.predict_logits(params, batch).cpu().numpy()
        labels = batch["labels"].cpu().numpy()
        metrics.update(labels, logits)


class _TextMetrics:
    """Streaming precision/recall at thresholds {.3,.5,.7} and @k {1,5}
    (reference models/text_model.py:105-126), in numpy on the logits: the
    top k by ``np.argsort(-logits)``, as the JAX package ranks them (ties
    broken as numpy's sort breaks them)."""

    THRESHOLDS = (0.3, 0.5, 0.7)
    KS = (1, 5)

    def __init__(self):
        self.tp = {t: 0 for t in self.THRESHOLDS}
        self.pred_pos = {t: 0 for t in self.THRESHOLDS}
        self.actual_pos = 0
        self.topk_tp = {k: 0 for k in self.KS}
        self.topk_pred = {k: 0 for k in self.KS}
        self.topk_actual = 0

    def update(self, labels, logits):
        probs = 1.0 / (1.0 + np.exp(-logits))
        positives = labels > 0
        self.actual_pos += int(positives.sum())
        for t in self.THRESHOLDS:
            pred = probs > t
            self.tp[t] += int((pred & positives).sum())
            self.pred_pos[t] += int(pred.sum())
        order = np.argsort(-logits, axis=-1)
        for k in self.KS:
            topk = np.zeros_like(positives)
            np.put_along_axis(topk, order[:, :k], True, axis=-1)
            self.topk_tp[k] += int((topk & positives).sum())
            self.topk_pred[k] += int(topk.sum())
        self.topk_actual += int(positives.sum())

    def result(self):
        out = {}
        for t in self.THRESHOLDS:
            out["metrics/precision_at_%s" % t] = (
                self.tp[t] / max(self.pred_pos[t], 1))
            out["metrics/recall_at_%s" % t] = (
                self.tp[t] / max(self.actual_pos, 1))
        for k in self.KS:
            out["metrics/precision_at_%d" % k] = (
                self.topk_tp[k] / max(self.topk_pred[k], 1))
            out["metrics/recall_at_%d" % k] = (
                self.topk_tp[k] / max(self.topk_actual, 1))
        return out


register_model_class(schema.TextModel, TextModel)
