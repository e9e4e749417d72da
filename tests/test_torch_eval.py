"""The port's evaluation slice against the JAX package: ``run_evaluation``
(VOC and COCO), ``export_results``, ``MultiScalePredictor.update_params``,
the daemon (``continuous_evaluation``), the HTML report, the drawing
helpers, ``make_passthrough``, ``make_localizable_example`` and the
evaluate/export CLIs.

The config is ``tests/test_eval.py``'s tiny one (96x128 JPEG records,
P=12, canvases at 64 and 96, 1 OICR iteration). Both sides get the same
weights: the port's seeded numpy tree in the JAX layout, handed to JAX as
arrays and to the port through ``params.from_jax_numpy``, both in
float32 (the JAX model without Pallas, as its CPU tests run it).
Detection scores go through float32 backbones that sum in another order:
rtol 1e-5; boxes are proposals, so equal; counts, classes and metrics
equal to 1e-6.
"""

import base64
import copy
import io
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import synthetic as jax_synthetic
from cap2det_tpu.data import tfrecord as jax_tfrecord
from cap2det_tpu.eval import evaluator as jax_evaluator
from cap2det_tpu.eval import export as jax_export
from cap2det_tpu.eval import html_report as jax_html_report
from cap2det_tpu.models import registry as jax_registry
from cap2det_tpu.ops import boxes as jax_boxes
from cap2det_tpu.utils import passthrough_init as jax_passthrough
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.cli import evaluate_main, export_main
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline, synthetic, tfrecord
from cap2det_tpu_torch.eval import evaluator, export, html_report
from cap2det_tpu_torch.models import frcnn, registry
from cap2det_tpu_torch.ops import boxes
from cap2det_tpu_torch.train import checkpoint as ckpt_lib
from cap2det_tpu_torch.train import trainer
from cap2det_tpu_torch.utils import passthrough_init, visualize
import cap2det_tpu_torch.models  # noqa: F401  (registers models)

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car"]
SCORE_RTOL = 1e-5
METRIC_ATOL = 1e-6

_PIPELINE = """
train_reader {
  cap2det_reader {
    input_pattern: "%(train_record)s"
    is_training: true
    shuffle_buffer_size: 4
    batch_size: 2
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
    max_num_proposals: 12
    batch_resize_scale_value: 1.0
  }
}
eval_reader {
  cap2det_reader {
    input_pattern: "%(record)s"
    is_training: false
    batch_size: 1
    image_resizer { keep_aspect_ratio_resizer { min_dimension: 64 } }
    max_num_proposals: 12
  }
}
model {
  [Cap2DetModel.ext] {
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6
      maxpool_kernel_size: 2
      maxpool_stride: 2
      dropout_keep_prob: 1.0
      dropout_on_feature_map: false
    }
    fc_hyperparams {
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 1
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 5 max_total_size: 10
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 5 max_total_size: 10
    }
    eval_min_dimension: 64
    eval_min_dimension: 96
    label_extractor {
      groundtruth_extractor { label_file: '%(label_file)s' }
    }
  }
}
train_config {
  max_steps: 2
  learning_rate: 0.01
  optimizer { adagrad {} }
  moving_average_decay: 0.9
  save_checkpoints_steps: 1
  log_step_count_steps: 1
}
eval_config { steps: 4 }
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """tests/test_eval.py's 4 JPEG records (JAX writer) for evaluation, 4
    PNG records (the port's writer) for training, and the config text."""
    root = tmp_path_factory.mktemp("eval")
    record = str(root / "eval.record")
    jax_synthetic.write_synthetic_dataset(
        record, num_examples=4, seed=5, classes=CLASSES, image_hw=(96, 128),
        num_proposals=12)
    train_record = str(root / "train.record")
    synthetic.write_synthetic_dataset(
        train_record, num_examples=4, seed=6, classes=CLASSES,
        image_hw=(96, 128), num_proposals=12)
    label_file = synthetic.write_label_file(str(root / "labels.txt"), CLASSES)
    text = _PIPELINE % {"record": record, "train_record": train_record,
                        "label_file": label_file}
    proto = root / "pipeline.pbtxt"
    proto.write_text(text)
    return {"root": root, "text": text, "proto": str(proto)}


@pytest.fixture(scope="module")
def models(inputs):
    """(JAX model, JAX params, port model, port params, tree) in float32,
    and a second tree (seed 1)."""
    jax_cfg = jax_schema.loads_pipeline(inputs["text"])
    cfg = schema.loads_pipeline(inputs["text"])
    jax_model = jax_registry.build(jax_cfg.model, is_training=False,
                                   compute_dtype=jnp.float32)
    model = registry.build(cfg.model, compute_dtype=torch.float32,
                           device="cpu")
    tree = model.init_jax_numpy(0)
    return {"jax_cfg": jax_cfg, "cfg": cfg, "jax_model": jax_model,
            "model": model, "tree": tree, "tree2": model.init_jax_numpy(1),
            "jax_params": jax.tree.map(jnp.asarray, tree),
            "params": params_lib.from_jax_numpy(tree, "cpu")}


def _run_both(models, kind):
    results = {"jax": [], "port": []}
    want = jax_evaluator.run_evaluation(
        models["jax_cfg"], models["jax_params"], model=models["jax_model"],
        evaluator_kind=kind,
        visualize_fn=lambda ex, res: results["jax"].append(res))
    got = evaluator.run_evaluation(
        models["cfg"], models["params"], model=models["model"],
        evaluator_kind=kind,
        visualize_fn=lambda ex, res: results["port"].append(res))
    return got, want, results


def _same_detections(got, want, iterations=(0, 1)):
    for i in iterations:
        s = "_at_%d" % i
        n = int(want["num_detections" + s])
        assert int(got["num_detections" + s]) == n > 0
        np.testing.assert_array_equal(got["detection_classes" + s],
                                      want["detection_classes" + s])
        np.testing.assert_array_equal(got["detection_boxes" + s],
                                      np.asarray(want["detection_boxes" + s]))
        np.testing.assert_allclose(got["detection_scores" + s],
                                   want["detection_scores" + s],
                                   rtol=SCORE_RTOL)


def _same_metrics(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(got[key]), key
        else:
            np.testing.assert_allclose(got[key], w, rtol=0,
                                       atol=METRIC_ATOL, err_msg=key)


@pytest.mark.parametrize("kind", ["pascal", "coco"])
def test_run_evaluation_matches_jax(models, kind):
    (got, got_maps), (want, want_maps), results = _run_both(models, kind)
    assert len(results["port"]) == len(results["jax"]) == 4
    for g, w in zip(results["port"], results["jax"]):
        assert g["image_id"] == w["image_id"]
        assert g["image_hw"] == w["image_hw"]
        _same_detections(g, w)
    _same_metrics(got, want)
    assert got["num_examples"] == 4
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=METRIC_ATOL)
    assert len(got_maps) == 2 and all(0.0 < m <= 1.0 for m in got_maps)
    prefix = "DetectionBoxes_" if kind == "coco" else "PascalBoxes_"
    assert all(k.split("/", 1)[1].startswith(prefix)
               for k in got if k.startswith("iter"))


def test_export_results_matches_jax(models, tmp_path):
    want = jax_export.export_results(
        models["jax_cfg"], models["jax_params"], str(tmp_path / "jax.json"),
        model=models["jax_model"])
    path = str(tmp_path / "port.json")
    got = export.export_results(models["cfg"], models["params"], path,
                                model=models["model"])
    with open(path) as f:
        loaded = json.load(f)
    with open(str(tmp_path / "jax.json")) as f:
        jax_loaded = json.load(f)
    assert list(loaded) == list(jax_loaded) == list(got) == list(want)
    assert len(loaded) == 4
    for image_id, w in jax_loaded.items():
        g = loaded[image_id]
        assert set(g) == {"detection_boxes", "detection_scores",
                          "detection_classes"}
        assert g["detection_classes"] == w["detection_classes"]
        assert g["detection_boxes"] == w["detection_boxes"]
        np.testing.assert_allclose(g["detection_scores"],
                                   w["detection_scores"], rtol=SCORE_RTOL)
    # One example, the MIDN iteration.
    one = export.export_results(models["cfg"], models["params"],
                                str(tmp_path / "one.json"),
                                model=models["model"], max_examples=1,
                                iteration=0)
    assert list(one) == list(loaded)[:1]


def _example(models):
    reader = models["cfg"].eval_reader.cap2det_reader
    return next(pipeline.InputPipeline(reader, prefetch=0).example_stream())


def _equal_outputs(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "proposal_scores":
            for s in a[k]:
                np.testing.assert_array_equal(a[k][s], b[k][s])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_update_params_prepares_again(models):
    model = models["model"]
    reader = models["cfg"].eval_reader.cap2det_reader
    example = _example(models)
    second = params_lib.from_jax_numpy(models["tree2"], "cpu")

    late = evaluator.MultiScalePredictor(model, None, reader)
    with pytest.raises(RuntimeError, match="update_params"):
        late.predict(example)
    late.update_params(models["params"])
    built = evaluator.MultiScalePredictor(model, models["params"], reader)
    first_out = built.predict(example)
    _equal_outputs(late.predict(example), first_out)

    built.update_params(second)
    want = evaluator.MultiScalePredictor(model, second, reader).predict(
        example)
    got = built.predict(example)
    _equal_outputs(got, want)
    assert not np.array_equal(got["proposal_scores"]["oicr_proposal_scores_at_1"],
                              first_out["proposal_scores"][
                                  "oicr_proposal_scores_at_1"])


# -- the daemon over checkpoints written by the port's train() ---------------


@pytest.fixture(scope="module")
def trained(inputs, tmp_path_factory):
    """A model_dir holding checkpoints 1 and 2 of the port's train() on
    the CPU (each with a moving average)."""
    model_dir = str(tmp_path_factory.mktemp("trained") / "model")
    trainer.train(schema.loads_pipeline(inputs["text"]), model_dir=model_dir,
                  device="cpu")
    assert [s for s, _ in ckpt_lib.list_checkpoints(model_dir)] == [1, 2]
    return model_dir


def _copy(model_dir, tmp_path):
    dst = str(tmp_path / "model")
    shutil.copytree(model_dir, dst)
    return dst


def _rows(model_dir):
    with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_continuous_evaluation_walks_every_checkpoint(inputs, trained,
                                                      tmp_path, monkeypatch):
    model_dir = _copy(trained, tmp_path)
    restored, converted = [], []
    real_restore = ckpt_lib.CheckpointManager.restore
    real_convert = params_lib.from_jax_numpy

    def restore(self, state_like=None, step=None):
        restored.append(real_restore(self, state_like, step))
        return restored[-1]

    def convert(tree, device="cuda"):
        converted.append(tree)
        return real_convert(tree, device)

    monkeypatch.setattr(ckpt_lib.CheckpointManager, "restore", restore)
    monkeypatch.setattr(params_lib, "from_jax_numpy", convert)
    best = evaluator.continuous_evaluation(
        schema.loads_pipeline(inputs["text"]), model_dir=model_dir,
        max_idle_polls=0, evaluate_all=True, poll_interval_secs=0,
        device="cpu")

    rows = _rows(model_dir)
    assert [r["step"] for r in rows] == [1, 2]  # oldest first
    for r in rows:
        assert r["num_examples"] == 4 and r["eval/seconds_per_checkpoint"] > 0
        assert {"iter0/PascalBoxes_Precision/mAP@0.5IOU",
                "iter1/PascalBoxes_Precision/mAP@0.5IOU"} <= set(r)
    maps = {r["step"]: r["iter1/PascalBoxes_Precision/mAP@0.5IOU"]
            for r in rows}
    for step in (1, 2):
        with open(os.path.join(model_dir, "eval_report_%d.csv" % step)) as f:
            lines = f.read().splitlines()
        assert lines == sorted(lines) and any(
            l.startswith("eval/seconds_per_checkpoint,") for l in lines)
        with open(os.path.join(model_dir, "eval_report_%d.html" % step)) as f:
            page = f.read()
        assert page.count("data:image/jpeg;base64,") == 2 * 4
    # The moving average is what the daemon evaluates.
    assert len(restored) == len(converted) == 2
    assert all(c is s["ema"] for c, s in zip(converted, restored))
    # Promotion: strict >, so a tie keeps the earlier step.
    winner = 2 if maps[2] > maps[1] else 1
    with open(os.path.join(model_dir, "saved_ckpts", "saved_info.txt")) as f:
        step, metric = f.read().split("\t")
    assert int(step) == winner and float(metric) == pytest.approx(
        maps[winner])
    assert os.path.isdir(os.path.join(model_dir, "saved_ckpts",
                                      "model.ckpt-%d" % winner))
    assert best[0] in (1, 2) and best[1] == max(maps.values())


def test_a_vanished_checkpoint_is_skipped(inputs, trained, tmp_path,
                                          monkeypatch, caplog):
    """The trainer's retention deletes checkpoint 1 between the daemon's
    listing and its restore: logged, marked evaluated, not fatal."""
    model_dir = _copy(trained, tmp_path)
    real_restore = ckpt_lib.CheckpointManager.restore

    def restore(self, state_like=None, step=None):
        if step == 1:
            shutil.rmtree(self.checkpoint_path(1))
        return real_restore(self, state_like, step)

    monkeypatch.setattr(ckpt_lib.CheckpointManager, "restore", restore)
    with caplog.at_level("WARNING", logger="cap2det_torch.eval"):
        best = evaluator.continuous_evaluation(
            schema.loads_pipeline(inputs["text"]), model_dir=model_dir,
            max_idle_polls=0, evaluate_all=True, poll_interval_secs=0,
            device="cpu")
    assert [r["step"] for r in _rows(model_dir)] == [2]
    assert best[0] == 2
    assert "vanished before restore" in caplog.text
    assert not os.path.exists(os.path.join(model_dir, "eval_report_1.csv"))


def test_daemon_without_checkpoints_returns_none(inputs, tmp_path):
    model_dir = str(tmp_path / "empty")
    assert evaluator.continuous_evaluation(
        schema.loads_pipeline(inputs["text"]), model_dir=model_dir,
        max_idle_polls=1, poll_interval_secs=0, device="cpu") is None
    assert _rows(model_dir) == []


def test_evaluate_cli_on_the_cpu(inputs, trained, tmp_path):
    model_dir = _copy(trained, tmp_path)
    best = evaluate_main.main([
        "--pipeline_proto", inputs["proto"], "--model_dir", model_dir,
        "--run_once", "--evaluator", "coco", "--max_eval_examples", "3",
        "--device", "cpu"])
    rows = _rows(model_dir)
    assert [r["step"] for r in rows] == [2] and best[0] == 2
    assert rows[0]["num_examples"] == 3
    assert "iter1/DetectionBoxes_Precision/mAP" in rows[0]


def test_export_cli_on_the_cpu(inputs, trained, tmp_path):
    path = str(tmp_path / "detections.json")
    export_main.main(["--pipeline_proto", inputs["proto"], "--model_dir",
                      trained, "--output_json", path, "--device", "cpu"])
    with open(path) as f:
        loaded = json.load(f)
    assert len(loaded) == 4
    for entry in loaded.values():
        assert set(entry) == {"detection_boxes", "detection_scores",
                              "detection_classes"}
        assert len(entry["detection_boxes"]) == len(
            entry["detection_scores"]) > 0


def test_clis_need_a_card_unless_asked_for_the_cpu(inputs, trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_main.main(["--pipeline_proto", inputs["proto"],
                            "--model_dir", str(tmp_path), "--run_once"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_main.main(["--pipeline_proto", inputs["proto"], "--model_dir",
                          trained, "--output_json",
                          str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluator.continuous_evaluation(
            schema.loads_pipeline(inputs["text"]), model_dir=str(tmp_path),
            max_idle_polls=0)
    assert not os.path.exists(str(tmp_path / "x.json"))


# -- the HTML report and the drawing helpers ----------------------------------


GT_BOXES = np.array([[0.2, 0.1, 0.6, 0.5], [0.7, 0.6, 0.95, 0.9]],
                    np.float32)


def _report_inputs():
    """A 500x640 JPEG (downscaled to 312x400), an id and captions that
    need escaping, one ground truth outside the label map, and detections
    at iteration 1: a hit, a miss and one below the score threshold."""
    rng = np.random.default_rng(9)
    image = rng.integers(0, 256, (500, 640, 3)).astype(np.uint8)
    example = {
        "image_encoded": jax_synthetic.encode_jpeg(image),
        "image_id": "a<b>&\"c\"",
        "captions": [["a", "<dog>"], ["x&y"]],
        "object_boxes": GT_BOXES,
        "object_texts": ["dog", "unicorn"],
    }
    result = {
        "num_detections_at_1": np.int32(3),
        "detection_boxes_at_1": np.array(
            [[0.21, 0.11, 0.6, 0.5], [0.7, 0.1, 0.9, 0.3],
             [0.1, 0.1, 0.2, 0.2], [0, 0, 0, 0]], np.float32),
        "detection_scores_at_1": np.array([0.9, 0.5, 0.01, 0.0], np.float32),
        "detection_classes_at_1": np.array([2, 1, 3, 0], np.int32),
    }
    return example, result


def _strip_images(row):
    return re.sub(r"base64,[A-Za-z0-9+/=]*", "base64,", row)


def test_html_report_rows_match_jax(tmp_path):
    pytest.importorskip("cv2")
    example, result = _report_inputs()
    got = html_report.HTMLReport(CLASSES, max_examples=2)
    want = jax_html_report.HTMLReport(CLASSES, max_examples=2)
    for _ in range(3):  # the third is past max_examples
        got.add_example(example, result, 1)
        want.add_example(example, result, 1)
    assert len(got._rows) == len(want._rows) == 2
    assert [_strip_images(r) for r in got._rows] == [
        _strip_images(r) for r in want._rows]
    assert "a&lt;b&gt;&amp;&quot;c&quot;" in got._rows[0]
    assert "a &lt;dog&gt; / x&amp;y" in got._rows[0]
    for report, name in ((got, "port.html"), (want, "jax.html")):
        report.write(str(tmp_path / name))
    pages = [_strip_images((tmp_path / n).read_text())
             for n in ("port.html", "jax.html")]
    assert pages[0] == pages[1]
    assert pages[0].count("data:image/jpeg;base64,") == 4


def test_html_report_draws_on_a_downscaled_copy(monkeypatch):
    from PIL import Image

    example, result = _report_inputs()
    before = copy.deepcopy(example)
    drawn = []
    real = visualize.to_base64_jpeg

    def capture(image, quality=90):
        drawn.append(np.copy(image))
        return real(image, quality)

    monkeypatch.setattr(visualize, "to_base64_jpeg", capture)
    report = html_report.HTMLReport(CLASSES)
    report.add_example(example, result, 1)
    np.testing.assert_array_equal(example.pop("object_boxes"),
                                  before.pop("object_boxes"))
    assert example == before

    payloads = re.findall(r"base64,([A-Za-z0-9+/=]*)", report._rows[0])
    assert len(payloads) == len(drawn) == 2
    for payload in payloads:
        with Image.open(io.BytesIO(base64.b64decode(payload))) as im:
            assert im.format == "JPEG" and im.size == (400, 312)
    gt_img, det_img = drawn
    h, w = gt_img.shape[:2]
    for box in GT_BOXES:
        y1, x1, y2, x2 = (box * [h, w, h, w]).astype(int)
        for y, x in ((y1, x1), (y1, x2), (y2, x1), (y2, x2)):
            assert tuple(gt_img[y, x]) == html_report._GT_COLOR, (y, x)
    # The hit (class 2, "dog", on the dog) and the miss; the detection
    # below the score threshold is not drawn.
    for box, color in ((result["detection_boxes_at_1"][0],
                        html_report._HIT_COLOR),
                       (result["detection_boxes_at_1"][1],
                        html_report._DET_COLOR)):
        y1, x1, y2, x2 = (box * [h, w, h, w]).astype(int)
        for y, x in ((y1, x1), (y2, x2)):
            assert tuple(det_img[y, x]) == color, (y, x)
    y, x = int(0.15 * h), int(0.15 * w)  # inside the thresholded box only
    assert tuple(det_img[y, x]) not in (html_report._HIT_COLOR,
                                        html_report._DET_COLOR)


def test_downscale_equals_cv2():
    cv2 = pytest.importorskip("cv2")
    image = np.random.default_rng(10).integers(0, 256, (500, 640, 3)).astype(
        np.uint8)
    got = pipeline.resize_bilinear_u8(torch.from_numpy(image), 312, 400)
    np.testing.assert_array_equal(got.numpy(), cv2.resize(image, (400, 312)))


def test_evaluate_precision_and_recall_equals_jax():
    rng = np.random.default_rng(12)
    for _ in range(20):
        ng, nd = rng.integers(0, 5), rng.integers(0, 7)
        gt = np.sort(rng.uniform(0, 1, (ng, 4)).astype(np.float32), axis=-1)
        dt = np.concatenate([gt[:min(ng, 2)] + 0.01,
                             rng.uniform(0, 1, (nd, 4))]).astype(np.float32)
        gt_labels = rng.integers(1, 3, ng)
        dt_labels = rng.integers(1, 3, len(dt))
        args = (len(gt), gt, gt_labels, len(dt), dt, dt_labels)
        for g, w in zip(boxes.evaluate_precision_and_recall(*args),
                        jax_boxes.evaluate_precision_and_recall(*args)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("thickness", [1, 2])
def test_draw_rectangles_equals_cv2(thickness):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(thickness)
    image = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    # Inside, touching the border, past it, reversed, degenerate.
    rects = [((5, 7), (40, 30)), ((0, 0), (63, 47)), ((50, 40), (70, 60)),
             ((30, 20), (10, 5)), ((12, 12), (12, 30))]
    for p1, p2 in rects:
        want = cv2.rectangle(image.copy(), p1, p2, (10, 200, 30), thickness)
        got = visualize.fill_rectangle_outline(image.copy(), p1, p2,
                                               (10, 200, 30), thickness)
        np.testing.assert_array_equal(got, want, err_msg=str((p1, p2)))
    box = np.array([[0.1, 0.2, 0.8, 0.9]])
    want = cv2.rectangle(image.copy(), (int(0.2 * 64), int(0.1 * 48)),
                         (int(0.9 * 64), int(0.8 * 48)), (1, 2, 3), thickness)
    got = visualize.draw_rectangles(image, box, color=(1, 2, 3),
                                    thickness=thickness)
    np.testing.assert_array_equal(got, want)


def test_heatmap_equals_matplotlib_jet():
    matplotlib = pytest.importorskip("matplotlib")
    jet = matplotlib.colormaps["jet"]
    values = np.random.default_rng(13).normal(size=(8, 10))
    values[0, :3] = [values.min(), values.max(), np.nan_to_num(0.0)]
    got = visualize.convert_to_heatmap(values)
    assert got.shape == (8, 10, 3) and got.dtype == np.uint8
    v = values.astype(np.float32)
    v = (v - v.min()) / max(float(v.max() - v.min()), 1e-12)
    want = (jet(np.clip(v, 0, 1))[..., :3] * 255).astype(
        np.uint8)
    np.testing.assert_array_equal(got, want)
    ramp = np.linspace(0, 1, 1001, dtype=np.float32)[None]
    np.testing.assert_array_equal(
        visualize.convert_to_heatmap(ramp, normalize=False),
        (jet(ramp)[..., :3] * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="jet"):
        visualize.convert_to_heatmap(values, colormap="viridis")


def test_draw_rectangles_and_caption():
    img = np.zeros((40, 60, 3), np.uint8)
    out = visualize.draw_rectangles(img, [[0.1, 0.1, 0.9, 0.9]],
                                    labels=["cat"], color=(0, 255, 0))
    assert out.sum() > 0 and out[int(0.1 * 40), int(0.1 * 60), 1] == 255
    assert img.sum() == 0  # input untouched
    captioned = visualize.draw_caption(out, "hello")
    assert captioned.shape == img.shape
    assert (captioned != out).any() and captioned[:20].sum() > out[:20].sum()


def test_base64_jpeg():
    img = np.random.RandomState(0).randint(0, 255, (16, 16, 3), np.uint8)
    decoded = base64.b64decode(visualize.to_base64_jpeg(img))
    assert decoded[:2] == b"\xff\xd8"


def test_missing_pillow_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ImportError, match="Pillow"):
        visualize.to_base64_jpeg(img)
    with pytest.raises(ImportError, match="Pillow"):
        visualize.draw_caption(img, "x")
    # Boxes alone need no Pillow.
    assert visualize.draw_rectangles(img, [[0, 0, 0.5, 0.5]]).sum() > 0


# -- the warm start and the localizable records -------------------------------


def test_make_passthrough_equals_jax(models):
    tree = models["tree"]
    for scope in (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE):
        src = tree[scope]["InceptionV2"]
        got = passthrough_init.make_passthrough(src)
        want = jax_passthrough.make_passthrough(src)
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            assert g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_localizable_example_equals_jax(tmp_path, monkeypatch):
    encoded = []
    real = jax_synthetic.encode_jpeg

    def capture(image):
        encoded.append(np.copy(image))
        return real(image)

    monkeypatch.setattr(jax_synthetic, "encode_jpeg", capture)
    classes = ["redthing", "greenthing"]
    paths = {"jax": str(tmp_path / "jax.record"),
             "port": str(tmp_path / "port.record")}
    for name, (writer_mod, synth) in {
            "jax": (jax_tfrecord, jax_synthetic),
            "port": (tfrecord, synthetic)}.items():
        rng = np.random.default_rng(11)
        with writer_mod.TFRecordWriter(paths[name]) as w:
            for i in range(6):
                w.write(synth.make_localizable_example(
                    rng, "loc-%05d" % i, classes, image_hw=(128, 160),
                    num_distractors=7))
    port_path = synthetic.write_localizable_dataset(
        str(tmp_path / "written.record"), num_examples=6, seed=11,
        classes=classes, image_hw=(128, 160), num_distractors=7)
    assert len(encoded) == 6
    parsed = {name: [pipeline.parse_example(r)
                     for r in tfrecord.read_records(p)]
              for name, p in dict(paths, written=port_path).items()}
    for i, (g, w) in enumerate(zip(parsed["port"], parsed["jax"])):
        assert g["image_id"] == w["image_id"] == "loc-%05d" % i
        for key in ("captions", "object_texts", "object_labels"):
            assert g[key] == w[key], key
        for key in ("object_boxes", "proposals"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert g["proposals"].shape == (8, 4)
        assert g["image_encoded"][:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(
            pipeline.decode_jpeg(g["image_encoded"]), encoded[i])
    for g, w in zip(parsed["written"], parsed["port"]):
        assert g["image_id"].startswith("localizable-")
        assert g["image_encoded"] == w["image_encoded"]


@pytest.mark.slow
def test_overfit_synthetic_detection_map(tmp_path):
    """tests/test_e2e_map.py's overfit run through the port on the CPU:
    passthrough warm start, 300 train() steps, the daemon's mAP."""
    from cap2det_tpu_torch.tools import overfit_map

    result = overfit_map.run(str(tmp_path), device="cpu")
    overfit_map.check(result)


def test_moving_average_keeps_the_params_nesting(models):
    """The average is a params tree the model runs: leafless blocks (pool
    branches) stay, as jax.tree.map keeps them."""
    from cap2det_tpu_torch.train import optimizers

    def shape(tree):
        return {k: shape(v) if isinstance(v, dict) else None
                for k, v in tree.items()}

    ema = optimizers.ema_init(models["params"])
    assert shape(ema) == shape(models["params"]) == shape(models["tree"])
    assert "Branch_2" in ema[frcnn.SECOND_SCOPE]["InceptionV2"]["Mixed_5a"]
