"""Evaluation loop (port of ``cap2det_tpu/eval/evaluator.py``):
multi-scale prediction, per-iteration VOC or COCO metrics, continuous
checkpoint polling, best-model promotion.

Mirrors the reference evaluator daemon (train/predict.py:328-611):
  * polls the checkpoint dir, evaluates each new checkpoint,
  * one detection evaluator per OICR iteration (+1 for the MIDN stage),
  * multi-scale test-time inference: per ``eval_min_dimension`` the image
    is re-resized and per-iteration proposal scores are averaged before
    NMS (reference cap2det_model.py:231-272),
  * optional COCO->VOC class remap (``eval_coco_on_voc``),
  * metrics to JSONL/TensorBoard + CSV report + HTML gallery, best
    checkpoint promoted via saved_info.txt bookkeeping.

The canvas goes to the model as a raw [1, H, W, 3] uint8 tensor: the JAX
package's space-to-depth packing is a TPU layout choice that the port
leaves out. Checkpoints hold the JAX layout (``train/checkpoint.py``);
the daemon hands them to the model through ``params.from_jax_numpy``.
Everything runs on the card unless the caller asks for the CPU.

Coordinates: with eval batch 1 the reference's padded batch is a no-op,
so proposals/GT are true-image-normalized; we evaluate in those
coordinates directly (IoU is invariant to the absolute-pixel conversion
the reference applies, train/predict.py:377-415).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline as pipeline_lib
from cap2det_tpu_torch.eval import coco_eval, voc_eval
from cap2det_tpu_torch.eval.html_report import HTMLReport
from cap2det_tpu_torch.fields import DetectionFields
from cap2det_tpu_torch.models import registry
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train.metrics import MetricsWriter

log = logging.getLogger("cap2det_torch.eval")


class MultiScalePredictor:
    """Per-scale score computation + NMS for one example, on the model's
    device. The params are prepared (``Cap2DetModel.prepare``: the BN
    fold, the cast, the channels_last copy) once per set of params: here,
    or in ``update_params`` when built with ``params=None``."""

    def __init__(self, model, params, reader_cfg: schema.Cap2DetReader,
                 aspect_cap=1.5, canvas_multiple=32):
        self._model = model
        self._prepared = None
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
        if params is not None:
            self.update_params(params)

    @torch.no_grad()
    def update_params(self, params):
        """Prepares `params` (port tensors on the model's device) for the
        next predictions: a new checkpoint needs its own folded weights."""
        self._prepared = self._model.prepare(params)

    @torch.inference_mode()
    def predict(self, example):
        """Detections per OICR iteration for one example.

        `example` holds "proposals" [n, 4] (true-image-normalized) and the
        image, either decoded as "image" ([H, W, 3] uint8) or encoded as
        "image_encoded"; "image_id" is optional.
        """
        if self._prepared is None:
            raise RuntimeError(
                "MultiScalePredictor has no params: pass them to the "
                "constructor or call update_params first")
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

        # A tensor divisor: CUDA turns division by a Python scalar into a
        # reciprocal multiply, up to one ulp off numpy's quotient.
        num_scales = torch.tensor(float(len(self._min_dims)), device=dev)
        score_mean = {k: v / num_scales for k, v in score_sum.items()}
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


def _require_detection_model(model):
    if not hasattr(model, "postprocess"):
        raise NotImplementedError(
            "evaluating a model without detections (the text model) is "
            "not ported yet (ROADMAP.md queue 1 item 4)")


def build_detection_evaluators(model, eval_coco_on_voc=False,
                               evaluator_kind="pascal"):
    """One evaluator per OICR iteration (reference predict.py:565-576).

    ``evaluator_kind`` selects the metric protocol ('pascal' or 'coco'),
    mirroring the reference's ``--evaluator`` flag.
    """
    if eval_coco_on_voc:
        from cap2det_tpu_torch.data.synthetic import VOC_CLASSES

        categories = [
            {"id": i + 1, "name": name} for i, name in enumerate(VOC_CLASSES)
        ]
    else:
        categories = [
            {"id": i + 1, "name": name}
            for i, name in enumerate(model.label_extractor.classes)
        ]
    n = 1 + model.options.oicr_iterations
    if evaluator_kind == "coco":
        return [
            coco_eval.CocoDetectionEvaluator(categories) for _ in range(n)
        ], categories
    if evaluator_kind != "pascal":
        raise ValueError("unknown evaluator kind %r" % evaluator_kind)
    return [
        voc_eval.PascalDetectionEvaluator(categories) for _ in range(n)
    ], categories


def run_evaluation(
    pipeline_config: schema.Pipeline,
    params,
    model=None,
    max_eval_examples=None,
    eval_coco_on_voc=False,
    visualize_fn=None,
    evaluator_kind="pascal",
    predictor=None,
    device="cuda",
):
    """Single evaluation pass. Returns (metrics dict, per-iteration mAP list).

    `params` are port tensors on the model's device. Pass a `predictor`
    (its params are replaced by `params`) when evaluating many
    checkpoints. Without `model`, one is built on `device`.
    """
    if model is None:
        model = registry.build(pipeline_config.model, is_training=False,
                               device=device)
    _require_detection_model(model)
    reader_cfg = pipeline_config.eval_reader.cap2det_reader
    pipe = pipeline_lib.InputPipeline(reader_cfg, prefetch=0)
    if predictor is None:
        predictor = MultiScalePredictor(model, params, reader_cfg)
    else:
        predictor.update_params(params)
    evaluators, categories = build_detection_evaluators(
        model, eval_coco_on_voc, evaluator_kind
    )
    category_to_id = {c["name"]: c["id"] for c in categories}

    count = 0
    total_gt = 0
    for example in pipe.example_stream():
        if example.get("image_encoded") is None:
            continue
        result = predictor.predict(example)

        gt_sel = [
            (box, category_to_id[text])
            for box, text in zip(example["object_boxes"], example["object_texts"])
            if text in category_to_id
        ]
        gt_boxes = np.array([b for b, _ in gt_sel], np.float32).reshape(-1, 4)
        gt_classes = np.array([c for _, c in gt_sel], np.int64)
        total_gt += len(gt_sel)

        # COCO metrics split by absolute pixel area; convert from
        # normalized coordinates (IoU itself is scale-invariant).
        abs_vec = np.ones(4, np.float32)
        if evaluator_kind == "coco":
            ih, iw = result["image_hw"]
            abs_vec = np.array([ih, iw, ih, iw], np.float32)
        gt_boxes = gt_boxes * abs_vec

        for i, evaluator in enumerate(evaluators):
            suffix = "_at_%d" % i
            n = int(result[DetectionFields.num_detections + suffix])
            boxes = result[DetectionFields.detection_boxes + suffix][:n]
            scores = result[DetectionFields.detection_scores + suffix][:n]
            classes = result[DetectionFields.detection_classes + suffix][:n]
            if eval_coco_on_voc:
                boxes, scores, classes = voc_eval.convert_coco_result_to_voc(
                    boxes, scores, classes
                )
            boxes = np.asarray(boxes, np.float32).reshape(-1, 4) * abs_vec
            evaluator.add_single_ground_truth_image_info(
                result["image_id"],
                {
                    "groundtruth_boxes": gt_boxes,
                    "groundtruth_classes": gt_classes,
                    "groundtruth_difficult": np.zeros(len(gt_boxes), bool),
                },
            )
            evaluator.add_single_detected_image_info(
                result["image_id"],
                {
                    "detection_boxes": boxes,
                    "detection_scores": scores,
                    "detection_classes": classes,
                },
            )
        if visualize_fn is not None:
            visualize_fn(example, result)
        count += 1
        if max_eval_examples and count >= max_eval_examples:
            break

    if count and not total_gt:
        log.warning(
            "evaluated %d examples but matched ZERO ground-truth texts to "
            "the label map — mAP will be NaN; check that object_text values "
            "match the label file's class names", count,
        )
    metrics = {}
    map_per_iter = []
    for i, evaluator in enumerate(evaluators):
        res = evaluator.evaluate()
        for k, v in res.items():
            metrics["iter%d/%s" % (i, k)] = v
        if evaluator_kind == "coco":
            map_key = [k for k in res if k.endswith("_Precision/mAP")][0]
        else:
            map_key = [k for k in res if k.endswith("mAP@0.5IOU")][0]
        map_per_iter.append(res[map_key])
    metrics["num_examples"] = count
    return metrics, map_per_iter


def write_csv_report(path, metrics):
    with open(path, "w") as fid:
        for key in sorted(metrics):
            fid.write("%s,%s\n" % (key, metrics[key]))


def continuous_evaluation(
    pipeline_config: schema.Pipeline,
    model_dir=None,
    max_eval_examples=None,
    eval_coco_on_voc=False,
    poll_interval_secs=10,
    min_eval_steps=0,
    max_idle_polls=None,
    evaluator_kind="pascal",
    evaluate_all=False,
    device="cuda",
):
    """Checkpoint-polling evaluation daemon (reference predict.py:578-611)
    on `device` ("cuda" unless the caller asks for the CPU). Returns
    (step, final-iteration mAP) of the best checkpoint it evaluated, or
    None.

    With evaluate_all, each poll takes the OLDEST not-yet-evaluated
    retained checkpoint instead of the newest — walking the whole
    retained history to build a metric-vs-step curve after (or during)
    training.
    """
    model_dir = model_dir or pipeline_config.model_dir
    model = registry.build(pipeline_config.model, is_training=False,
                           device=device)
    _require_detection_model(model)
    saved_dir = os.path.join(model_dir, "saved_ckpts")
    # Eval curves to TensorBoard beside the trainer's (reference
    # train/predict.py:491-496 writes per-iteration mAP/CorLoc summaries);
    # JSONL twin stays in eval_metrics.jsonl.
    writer = MetricsWriter(
        model_dir, jsonl_name="eval_metrics.jsonl", tb_name="tb_eval"
    )
    try:
        return _poll_loop(
            pipeline_config, model, model_dir, saved_dir, writer,
            max_eval_examples=max_eval_examples,
            eval_coco_on_voc=eval_coco_on_voc,
            poll_interval_secs=poll_interval_secs,
            min_eval_steps=min_eval_steps,
            max_idle_polls=max_idle_polls,
            evaluator_kind=evaluator_kind,
            evaluate_all=evaluate_all,
        )
    finally:
        # Close on EVERY exit path (exceptions, SIGTERM-as-exception):
        # the JSONL handle and TB event writer would otherwise leak and
        # drop buffered events.
        writer.close()


def _poll_loop(
    pipeline_config,
    model,
    model_dir,
    saved_dir,
    writer,
    *,
    max_eval_examples,
    eval_coco_on_voc,
    poll_interval_secs,
    min_eval_steps,
    max_idle_polls,
    evaluator_kind,
    evaluate_all=False,
):
    evaluated = set()
    idle = 0
    best = None
    # Built once and given each checkpoint's params (update_params).
    predictor = MultiScalePredictor(
        model, None, pipeline_config.eval_reader.cap2det_reader
    )
    while True:
        if evaluate_all:
            step, path = None, None
            for s_, p_ in ckpt_lib.list_checkpoints(model_dir):
                if s_ not in evaluated and s_ >= min_eval_steps:
                    step, path = s_, p_
                    break
        else:
            step, path = ckpt_lib.latest_checkpoint(model_dir)
        if step is None or step in evaluated or step < min_eval_steps:
            idle += 1
            if max_idle_polls is not None and idle > max_idle_polls:
                return best
            time.sleep(poll_interval_secs)
            continue
        idle = 0
        manager = ckpt_lib.CheckpointManager(model_dir)
        try:
            state = manager.restore(step=step)
        except OSError as exc:
            # Races the trainer's checkpoint GC (max_to_keep) when used
            # during training — especially evaluate_all, whose
            # oldest-first target is exactly the next deletion victim.
            # A deleted checkpoint never comes back: mark it evaluated
            # and move on instead of dying mid-curve.
            log.warning("checkpoint %s vanished before restore (%s); "
                        "skipping", step, exc)
            evaluated.add(step)
            continue
        finally:
            manager.close()
        # Evaluate the moving average when present (swapping-saver parity).
        saved = state["ema"] if "ema" in state else state["params"]
        params = params_lib.from_jax_numpy(saved, model.device)

        report = HTMLReport(model.label_extractor.classes, max_examples=20)
        final_iter = model.options.oicr_iterations
        eval_start = time.time()
        metrics, map_per_iter = run_evaluation(
            pipeline_config,
            params,
            model=model,
            max_eval_examples=max_eval_examples,
            eval_coco_on_voc=eval_coco_on_voc,
            visualize_fn=lambda ex, res: report.add_example(ex, res,
                                                            final_iter),
            evaluator_kind=evaluator_kind,
            predictor=predictor,
        )
        # Wall time per checkpoint: if this exceeds the trainer's
        # save_checkpoints_steps cadence the daemon silently skips
        # checkpoints and degrades best-ckpt selection — keep it visible.
        metrics["eval/seconds_per_checkpoint"] = time.time() - eval_start
        report.write(os.path.join(model_dir, "eval_report_%d.html" % step))
        final_map = map_per_iter[-1]
        log.info("step %d mAP per iter: %s (%.1fs)", step, map_per_iter,
                 metrics["eval/seconds_per_checkpoint"])
        write_csv_report(
            os.path.join(model_dir, "eval_report_%d.csv" % step), metrics
        )
        writer.write(step, {
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float, np.floating))
        })
        ckpt_lib.save_model_if_it_is_better(
            step, final_map, path, saved_dir
        )
        evaluated.add(step)
        # Ties keep the LATEST step here; save_model_if_it_is_better uses
        # a strict > and keeps the earliest. Both are defensible; the
        # return value is informational while saved_ckpts/ is the durable
        # artifact, so the mismatch is harmless.
        if best is None or final_map >= best[1]:
            best = (step, final_map)
