"""Cap2Det detector, inference (port of ``cap2det_tpu/models/cap2det.py``).

FRCNN proposal features -> MIDN two-branch head + K OICR refinement FCs;
postprocess = per-iteration class-wise NMS (iteration 0 scored by MIDN,
k > 0 by softmax(1+C)[..., 1:]), with padded proposals masked out. The
loss and its OICR targets wait for the training step.
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.fields import Cap2DetPredictions, DetectionFields
from cap2det_tpu_torch.models import frcnn, wsod
from cap2det_tpu_torch.models.registry import register_model_class
from cap2det_tpu_torch.ops import masked, nms
from cap2det_tpu_torch.text import extractors as extractors_lib

FEATURE_DIM = 1024


class Cap2DetModel:
    """Cap2Det inference on one device ("cuda" unless the caller asks for
    the CPU). Activations and conv weights run in ``compute_dtype``; the
    heads run in float32. ``predictions`` reads the tree that ``prepare``
    makes once from the params."""

    def __init__(self, options: schema.Cap2DetModel, is_training=False,
                 compute_dtype=torch.bfloat16, device="cuda"):
        if is_training:
            raise NotImplementedError(
                "the training step is not ported yet; build with "
                "is_training=False"
            )
        self._options = options
        self._compute_dtype = compute_dtype
        self._device = params_lib.resolve_device(device)
        self.label_extractor = extractors_lib.build_label_extractor(
            options.label_extractor
        )
        self._midn_post = nms.build_post_processor(options.midn_post_processor)
        self._oicr_post = nms.build_post_processor(options.oicr_post_processor)
        hp = options.fc_hyperparams
        self._fc_stddev = 0.01
        if hp and hp.initializer and hp.initializer.truncated_normal_initializer:
            self._fc_stddev = hp.initializer.truncated_normal_initializer.stddev

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
        """The tree ``predictions`` reads, made once per set of params: the
        backbone's frozen BN folded into its convs in ``compute_dtype``
        (``frcnn.prepare``); the heads as they are."""
        return {**params, **frcnn.prepare(params, self._compute_dtype)}

    # -- forward ----------------------------------------------------------------

    def predictions(self, prepared, batch):
        """MIDN/OICR scores of a batch {"image" [B,H,W,3] pixels in
        [0,255], "proposals" [B,P,4], "num_proposals" [B]} (tensors or
        arrays; moved to the model's device), with the params
        ``prepare`` made."""
        dev = self._device
        images = torch.as_tensor(batch["image"], device=dev)
        proposals = torch.as_tensor(batch["proposals"], dtype=torch.float32,
                                    device=dev)
        num_proposals = torch.as_tensor(batch["num_proposals"], device=dev)
        mask = masked.sequence_mask(num_proposals, proposals.shape[1])

        features = frcnn.extract_features(
            prepared, images, proposals, self._options.frcnn_options
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
                scores = torch.softmax(scores, dim=-1)[:, :, 1:]
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
