"""Multi-scale prediction (port of ``MultiScalePredictor`` in
``cap2det_tpu/eval/evaluator.py``).

Per ``eval_min_dimension`` the image is fitted to a landscape or portrait
canvas, the proposals are rescaled to the canvas, and per-iteration
proposal scores are computed; the scores are averaged over the scales
before one NMS pass. The canvas goes to the model as a raw [1, H, W, 3]
uint8 tensor: the JAX package's space-to-depth packing is a TPU layout
choice that the port leaves out.
"""

from __future__ import annotations

import numpy as np
import torch

from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline as pipeline_lib


class MultiScalePredictor:
    """Per-scale score computation + NMS for one example, on the model's
    device. The params are prepared (``Cap2DetModel.prepare``) once, here."""

    def __init__(self, model, params, reader_cfg: schema.Cap2DetReader,
                 aspect_cap=1.5, canvas_multiple=32):
        self._model = model
        self._prepared = model.prepare(params)
        self._reader = reader_cfg
        self._aspect_cap = aspect_cap
        self._multiple = canvas_multiple

        min_dims = list(model.options.eval_min_dimension)
        if not min_dims:
            resizer = reader_cfg.image_resizer
            if resizer and resizer.which_oneof() == "keep_aspect_ratio_resizer":
                min_dims = [resizer.keep_aspect_ratio_resizer.min_dimension]
            else:
                min_dims = [600]
        self._min_dims = min_dims

    @torch.inference_mode()
    def predict(self, example):
        """Detections per OICR iteration for one example.

        `example` holds "proposals" [n, 4] (true-image-normalized) and the
        image, either decoded as "image" ([H, W, 3] uint8) or encoded as
        "image_encoded"; "image_id" is optional.
        """
        model = self._model
        dev = model.device
        image = example.get("image")
        if image is None:
            image = pipeline_lib.decode_jpeg(example["image_encoded"])
        image = torch.as_tensor(np.array(image, dtype=np.uint8), device=dev)
        h, w = image.shape[:2]
        landscape = w >= h
        max_p = self._reader.max_num_proposals
        props_true = np.zeros((max_p, 4), np.float32)
        n_props = min(len(example["proposals"]), max_p)
        props_true[:n_props] = example["proposals"][:n_props]
        props = torch.from_numpy(props_true).to(dev)
        num = torch.tensor([n_props], dtype=torch.int32, device=dev)

        score_sum = None
        for min_dim in self._min_dims:
            short, long = pipeline_lib.compute_canvas(
                min_dim, 1.0, self._aspect_cap, self._multiple
            )
            ch, cw = (short, long) if landscape else (long, short)
            canvas, (new_h, new_w) = pipeline_lib.fit_image_to_canvas(
                image, (ch, cw)
            )
            fy, fx = new_h / ch, new_w / cw
            scale_vec = torch.tensor([fy, fx, fy, fx], dtype=torch.float32,
                                     device=dev)
            preds = model.predictions(self._prepared, {
                "image": canvas[None],
                "proposals": (props * scale_vec)[None],
                "num_proposals": num,
            })
            scores = {k: preds[k] for k in model.score_keys()}
            if score_sum is None:
                score_sum = scores
            else:
                score_sum = {k: score_sum[k] + scores[k] for k in score_sum}

        score_mean = {k: v / len(self._min_dims) for k, v in score_sum.items()}
        results = model.postprocess(score_mean, props[None], num)
        out = {k: v[0].cpu().numpy() for k, v in results.items()}
        out["image_id"] = example.get("image_id")
        out["image_hw"] = (h, w)
        out["proposal_scores"] = {
            k: v.cpu().numpy() for k, v in score_mean.items()
        }
        out["num_proposals"] = n_props
        out["proposals"] = props_true
        return out
