"""Cap2Det detector (port of ``cap2det_tpu/models/cap2det.py``).

FRCNN proposal features -> MIDN two-branch head + K OICR refinement FCs;
loss = MIDN sigmoid CE against the image-level labels + per-iteration OICR
CE (+ L2 on the heads); postprocess = per-iteration class-wise NMS
(iteration 0 scored by MIDN, k > 0 by softmax(1+C)[..., 1:]), with padded
proposals masked out.
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.fields import (Cap2DetPredictions, DetectionFields,
                                      InputFields)
from cap2det_tpu_torch.models import frcnn, wsod
from cap2det_tpu_torch.models.base import ModelBase
from cap2det_tpu_torch.models.registry import register_model_class
from cap2det_tpu_torch.ops import losses as loss_ops
from cap2det_tpu_torch.ops import masked, nms
from cap2det_tpu_torch.ops import softmax as softmax_ops
from cap2det_tpu_torch.text import extractors as extractors_lib

FEATURE_DIM = 1024


class Cap2DetModel(ModelBase):
    """Cap2Det on one device ("cuda" unless the caller asks for the CPU).
    Activations and conv weights run in ``compute_dtype``; the heads and
    losses run in float32. ``predictions`` reads the tree that ``prepare``
    makes from the params: once for serving, inside ``loss`` for
    training.

    The label extractor is the host side of the input pipeline, as in the
    JAX package: it makes labels in the feed's worker process. A text
    classifier there is built with device="cpu", loads its checkpoint in
    that process at its first batch, and never starts CUDA."""

    non_trainable_paths = ("word_embedding",)
    non_trainable_substrings = ("/BatchNorm/moving_",)

    def __init__(self, options: schema.Cap2DetModel, is_training=False,
                 compute_dtype=torch.bfloat16, device="cuda"):
        self._options = options
        self._compute_dtype = compute_dtype
        self._device = params_lib.resolve_device(device)
        extractor_kwargs = {}  # a text classifier runs on the CPU
        if (options.label_extractor is not None
                and options.label_extractor.which_oneof()
                == "text_classifier_match_extractor"):
            extractor_kwargs["device"] = "cpu"
        self.label_extractor = extractors_lib.build_label_extractor(
            options.label_extractor, **extractor_kwargs)
        self._midn_post = nms.build_post_processor(options.midn_post_processor)
        self._oicr_post = nms.build_post_processor(options.oicr_post_processor)
        hp = options.fc_hyperparams
        self._fc_stddev = 0.01
        if hp and hp.initializer and hp.initializer.truncated_normal_initializer:
            self._fc_stddev = hp.initializer.truncated_normal_initializer.stddev
        self._fc_l2 = 0.0
        if hp and hp.regularizer and hp.regularizer.l2_regularizer:
            self._fc_l2 = hp.regularizer.l2_regularizer.weight

    @property
    def options(self):
        return self._options

    @property
    def device(self):
        return self._device

    @property
    def num_classes(self):
        return self.label_extractor.num_classes

    # -- params ----------------------------------------------------------------

    def init_jax_numpy(self, seed):
        """Random params as a JAX-layout numpy tree, with the names and
        shapes of the JAX ``Cap2DetModel.init_params`` (He-scaled convs:
        see ``inception_v2.init_first_stage_params_numpy``)."""
        rng = np.random.default_rng(seed)
        tree = frcnn.init_params_numpy(rng, self._options.frcnn_options)
        c = self.num_classes
        tree["midn"] = {
            name: wsod.init_fc_numpy(rng, FEATURE_DIM, c, self._fc_stddev)
            for name in ("proba_r_given_c", "proba_c_given_r")
        }
        tree["oicr"] = {
            "iter%d" % (i + 1): wsod.init_fc_numpy(
                rng, FEATURE_DIM, 1 + c, self._fc_stddev
            )
            for i in range(self._options.oicr_iterations)
        }
        return tree

    def init_params(self, seed):
        """Random params as port tensors on the model's device."""
        return params_lib.from_jax_numpy(self.init_jax_numpy(seed),
                                         self._device)

    def load_pretrained(self, params, converted_checkpoint):
        return frcnn.load_pretrained(params, converted_checkpoint)

    def prepare(self, params):
        """The tree ``predictions`` reads: the backbone's frozen BN folded
        into its convs in ``compute_dtype`` (``frcnn.prepare``); the heads
        as they are. Serving makes it once per set of params; ``loss``
        makes it on every step, differentiably."""
        return {**params, **frcnn.prepare(params, self._compute_dtype)}

    # -- batches ----------------------------------------------------------------

    def pipeline_kwargs(self):
        """The input pipeline's arguments that the model decides."""
        return {"label_extractor": self.label_extractor}

    def device_batch(self, host_batch):
        """A host training batch (``InputFields`` keys) -> the batch
        ``loss`` reads, as tensors on the model's device. The canvas stays
        raw [B, H, W, 3] (uint8 from the pipeline); the forward casts it.

        On a CUDA model each array is first copied into page-locked host
        memory (a page-locked tensor is used as it is) and sent with
        ``non_blocking=True``, so the copy overlaps the work queued before
        it. The page-locked tensors ride along under "pinned": the caller
        keeps the batch until the step that reads it has been queued.
        """
        dev = self._device
        arrays = {
            "image": host_batch[InputFields.image],
            "proposals": np.asarray(host_batch[InputFields.proposals],
                                    np.float32),
            "num_proposals": host_batch[InputFields.num_proposals],
            "labels": np.asarray(host_batch[InputFields.pseudo_labels],
                                 np.float32),
        }
        if dev.type != "cuda":
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in arrays.items()}
        pinned = {k: torch.as_tensor(v).pin_memory()
                  for k, v in arrays.items()}
        batch = {k: v.to(dev, non_blocking=True) for k, v in pinned.items()}
        batch["pinned"] = pinned
        return batch

    # -- forward ----------------------------------------------------------------

    def predictions(self, prepared, batch, is_training=False, generator=None):
        """MIDN/OICR scores of a batch {"image" [B,H,W,3] pixels in
        [0,255], "proposals" [B,P,4], "num_proposals" [B]} (tensors or
        arrays; moved to the model's device), with the params
        ``prepare`` made. `is_training` applies the FRCNN dropout, drawn
        from `generator`."""
        dev = self._device
        images = torch.as_tensor(batch["image"], device=dev)
        proposals = torch.as_tensor(batch["proposals"], dtype=torch.float32,
                                    device=dev)
        num_proposals = torch.as_tensor(batch["num_proposals"], device=dev)
        mask = masked.sequence_mask(num_proposals, proposals.shape[1])

        features = frcnn.extract_features(
            prepared, images, proposals, self._options.frcnn_options,
            is_training=is_training, generator=generator,
        )
        class_logits, proposal_scores, proba_r_given_c = wsod.midn_head(
            prepared["midn"], features, mask
        )
        preds = {
            Cap2DetPredictions.midn_class_logits: class_logits,
            Cap2DetPredictions.midn_proba_r_given_c: proba_r_given_c,
            Cap2DetPredictions.oicr_proposal_scores + "_at_0": proposal_scores,
            DetectionFields.proposal_boxes: proposals,
            DetectionFields.num_proposals: num_proposals,
            "proposal_mask": mask,
        }
        for i in range(self._options.oicr_iterations):
            preds[
                Cap2DetPredictions.oicr_proposal_scores + "_at_%d" % (i + 1)
            ] = wsod.fc(prepared["oicr"]["iter%d" % (i + 1)], features)
        return preds

    def loss(self, params, batch, generator=None, is_training=True):
        """(total, loss_dict) of a batch from ``device_batch``: MIDN sigmoid
        CE, each OICR iteration's CE and the heads' L2, with the JAX
        package's keys and weights. The BN fold runs inside (``prepare``),
        so gradients reach the live params."""
        options = self._options
        preds = self.predictions(self.prepare(params), batch,
                                 is_training=is_training, generator=generator)
        labels = torch.as_tensor(batch["labels"], dtype=torch.float32,
                                 device=self._device)
        loss_dict = {}
        midn_ce = loss_ops.sigmoid_cross_entropy(
            labels, preds[Cap2DetPredictions.midn_class_logits]).mean()
        loss_dict["midn_cross_entropy_loss"] = (midn_ce
                                                * options.midn_loss_weight)

        proposals = preds[DetectionFields.proposal_boxes]
        mask = preds["proposal_mask"]
        scores_0 = preds[Cap2DetPredictions.oicr_proposal_scores + "_at_0"]
        if options.oicr_use_proba_r_given_c:
            scores_0 = preds[Cap2DetPredictions.midn_proba_r_given_c]
        scores_0 = torch.cat([torch.zeros_like(scores_0[..., :1]), scores_0],
                             dim=-1)
        for i in range(options.oicr_iterations):
            scores_1 = preds[
                Cap2DetPredictions.oicr_proposal_scores + "_at_%d" % (i + 1)]
            ce = wsod.oicr_loss(labels, proposals, scores_0, scores_1, mask,
                                iou_threshold=options.oicr_iou_threshold)
            loss_dict["oicr_cross_entropy_loss_at_%d" % (i + 1)] = (
                ce * options.oicr_loss_weight)
            scores_0 = torch.softmax(scores_1, dim=-1)

        total = sum(loss_dict.values())
        if self._fc_l2 > 0:
            reg = loss_ops.l2_regularization(
                {"midn": params["midn"], "oicr": params["oicr"]}, self._fc_l2)
            loss_dict["regularization_loss"] = reg
            total = total + reg
        return total, loss_dict

    # -- postprocess / eval ------------------------------------------------------

    def postprocess(self, score_dict, proposals, num_proposals=None):
        """Per-iteration NMS; padded proposal slots (index >= num_proposals)
        are zeroed so the zero boxes never win. Returns detections keyed by
        iteration suffix."""
        dev = self._device
        proposals = torch.as_tensor(proposals, dtype=torch.float32, device=dev)
        valid = None
        if num_proposals is not None:
            valid = masked.sequence_mask(
                torch.as_tensor(num_proposals, device=dev), proposals.shape[1]
            )[:, :, None]
        results = {}
        for i in range(1 + self._options.oicr_iterations):
            scores = torch.as_tensor(
                score_dict[Cap2DetPredictions.oicr_proposal_scores
                           + "_at_%d" % i], device=dev,
            )
            if i == 0:
                post_fn = self._midn_post
            else:
                post_fn = self._oicr_post
                # The same bits on the card and the CPU (ops/softmax.py).
                scores = softmax_ops.softmax(scores)[:, :, 1:]
            if valid is not None:
                scores = scores * valid
            num, boxes, det_scores, det_classes = post_fn(proposals, scores)
            suffix = "_at_%d" % i
            results[DetectionFields.num_detections + suffix] = num
            results[DetectionFields.detection_boxes + suffix] = boxes
            results[DetectionFields.detection_scores + suffix] = det_scores
            results[DetectionFields.detection_classes + suffix] = det_classes
        return results

    def score_keys(self):
        return [
            Cap2DetPredictions.oicr_proposal_scores + "_at_%d" % i
            for i in range(1 + self._options.oicr_iterations)
        ]


register_model_class(schema.Cap2DetModel, Cap2DetModel)
