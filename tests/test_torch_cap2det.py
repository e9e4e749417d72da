"""The port's serving path against the JAX package at float32:
``Cap2DetModel.predictions`` and ``postprocess``, and
``MultiScalePredictor.predict`` on synthetic JPEGs.

Both sides get the same weights: a numpy tree made from a seed (He-scaled
convolutions, so scores are spread and NMS sees no near-ties), handed to
JAX as arrays and to the port through ``params.from_jax_numpy``. The
model is the small one of ``tests/test_cap2det_model.py``: 3 classes, 2
OICR iterations, 6x6 crops.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import pipeline as jax_pipeline
from cap2det_tpu.data import synthetic
from cap2det_tpu.eval import evaluator as jax_evaluator
from cap2det_tpu.models import registry as jax_registry
import cap2det_tpu.models  # noqa: F401  (registers models)
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import pipeline
from cap2det_tpu_torch.eval import evaluator
from cap2det_tpu_torch.models import registry
import cap2det_tpu_torch.models  # noqa: F401  (registers models)
from cap2det_tpu_torch.text import extractors

torch.set_num_threads(1)

CLASSES = ["person", "dog", "car"]
# Scores: float32 through the backbone, ~1e-5 apart between XLA and
# PyTorch's CPU kernels; MIDN scores are ~1/P, hence the atol.
RTOL, ATOL = 1e-4, 1e-7

_PIPELINE = """
eval_reader { cap2det_reader { max_num_proposals: %d } }
model {
  [Cap2DetModel.ext] {
    frcnn_options {
      feature_extractor { type: 'faster_rcnn_inception_v2' }
      initial_crop_size: 6 maxpool_kernel_size: 2 maxpool_stride: 2
    }
    fc_hyperparams {
      initializer { truncated_normal_initializer { stddev: 0.01 } }
    }
    oicr_iterations: 2
    midn_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.4
      max_size_per_class: 10 max_total_size: 20
    }
    oicr_post_processor {
      score_thresh: 0.00001 iou_thresh: 0.3
      max_size_per_class: 10 max_total_size: 20
    }
    %s
    label_extractor { groundtruth_extractor { label_file: '%s' } }
  }
}
"""


def _build(label_file, scales=(64,), max_p=12):
    text = _PIPELINE % (max_p, " ".join(
        "eval_min_dimension: %d" % s for s in scales), label_file)
    jax_cfg, cfg = jax_schema.loads_pipeline(text), schema.loads_pipeline(text)
    jax_model = jax_registry.build(jax_cfg.model, compute_dtype=jnp.float32)
    model = registry.build(cfg.model, compute_dtype=torch.float32,
                           device="cpu")
    tree = model.init_jax_numpy(0)
    return (jax_model, jax.tree.map(jnp.asarray, tree),
            jax_cfg.eval_reader.cap2det_reader, model,
            params_lib.from_jax_numpy(tree, "cpu"),
            cfg.eval_reader.cap2det_reader)


@pytest.fixture(scope="module")
def label_file(tmp_path_factory):
    return synthetic.write_label_file(
        str(tmp_path_factory.mktemp("labels") / "labels.txt"), CLASSES)


@pytest.fixture(scope="module")
def models(label_file):
    return _build(label_file)


def _proposals(rng, shape):
    y0 = rng.uniform(0, 0.6, shape)
    x0 = rng.uniform(0, 0.6, shape)
    return np.stack([y0, x0, y0 + rng.uniform(0.1, 0.4, shape),
                     x0 + rng.uniform(0.1, 0.4, shape)], -1).astype(np.float32)


def _batch():
    rng = np.random.default_rng(3)
    proposals = _proposals(rng, (2, 8))
    proposals[1, 5:] = 0.0  # padding slots
    return {
        "image": rng.integers(0, 256, (2, 64, 96, 3)).astype(np.uint8),
        "proposals": proposals,
        "num_proposals": np.array([8, 5], np.int32),
    }


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _same_detections(got, want, num_iterations=2):
    for i in range(1 + num_iterations):
        s = "_at_%d" % i
        np.testing.assert_array_equal(got["num_detections" + s],
                                      want["num_detections" + s])
        np.testing.assert_array_equal(got["detection_classes" + s],
                                      want["detection_classes" + s])
        np.testing.assert_allclose(got["detection_boxes" + s],
                                   want["detection_boxes" + s], rtol=1e-6)
        _close(got["detection_scores" + s], want["detection_scores" + s],
               "detection_scores" + s)
        assert np.asarray(got["num_detections" + s]).min() > 0


def test_predictions_match_jax(models):
    jax_model, jax_params, _, model, params, _ = models
    batch = _batch()
    want = jax_model.predictions(jax_params, batch)
    with torch.inference_mode():
        got = model.predictions(model.prepare(params), batch)
    keys = model.score_keys() + ["midn_class_logits", "midn_proba_r_given_c",
                                 "proposal_mask"]
    assert set(keys) <= set(want) and set(keys) <= set(got)
    for key in keys:
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key], want[key], key)
    # Padded proposal slots get no MIDN probability.
    assert float(got["midn_proba_r_given_c"][1, 5:].abs().max()) == 0.0


def test_postprocess_matches_jax(models):
    jax_model, _, _, model, _, _ = models
    rng = np.random.default_rng(4)
    proposals = _proposals(rng, (2, 12))
    num = np.array([12, 9], np.int32)
    scores = {"oicr_proposal_scores_at_0": rng.uniform(
        0, 0.2, (2, 12, 3)).astype(np.float32)}
    for i in (1, 2):
        scores["oicr_proposal_scores_at_%d" % i] = rng.normal(
            0, 2, (2, 12, 4)).astype(np.float32)
    want = jax_model.postprocess(scores, proposals, num)
    got = model.postprocess({k: torch.from_numpy(v) for k, v in scores.items()},
                            proposals, num)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    _same_detections(got, want)
    # Padded slots never come back as detections.
    for i in range(3):
        boxes = got["detection_boxes_at_%d" % i][1]
        assert not any(np.array_equal(b, p) for b in boxes
                       for p in proposals[1, 9:])


def _example(rng, hw, image_id):
    image = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    return {"image_encoded": synthetic.encode_jpeg(image),
            "image_id": image_id, "proposals": _proposals(rng, (10,))}


def _predict_both(models, example):
    jax_model, jax_params, jax_reader, model, params, reader = models
    want = jax_evaluator.MultiScalePredictor(
        jax_model, jax_params, jax_reader).predict(example)
    got = evaluator.MultiScalePredictor(model, params, reader).predict(example)
    return got, want


def _same_predictions(got, want):
    assert got["image_id"] == want["image_id"]
    assert got["image_hw"] == want["image_hw"]
    assert got["num_proposals"] == want["num_proposals"]
    np.testing.assert_array_equal(got["proposals"], want["proposals"])
    for k, v in want["proposal_scores"].items():
        _close(got["proposal_scores"][k], v, k)
    _same_detections(got, want)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)],
                         ids=["landscape", "portrait"])
def test_multiscale_predict_matches_jax_identity_resize(models, hw):
    """The JPEG already has the canvas size, so both resizes are the
    identity and both sides see the same canvas."""
    got, want = _predict_both(models, _example(np.random.default_rng(5), hw,
                                               "img%dx%d" % hw))
    _same_predictions(got, want)


def test_multiscale_predict_matches_jax_over_scales(label_file):
    """Two scales, each a real resize: the port's own integer resize
    against the JAX package's cv2 resize end to end, so the test holds the
    per-scale canvases, the proposal rescaling and the mean over scales."""
    pytest.importorskip("cv2")
    models = _build(label_file, scales=(64, 32))
    example = _example(np.random.default_rng(6), (70, 90), "scaled")
    got, want = _predict_both(models, example)
    _same_predictions(got, want)


@pytest.mark.parametrize("hw,canvas", [
    ((70, 90), (64, 96)), ((40, 50), (96, 64)), ((64, 96), (64, 96)),
    # chip_smoke.py's three serving images at scale 1200.
    ((375, 500), (1216, 1824)), ((500, 333), (1824, 1216)),
    ((400, 400), (1216, 1824)),
    ((800, 1200), (400, 600)),  # exact 2x downscale
    ((37, 53), (416, 608)),  # x11 upscale to 416x596
], ids=["down", "up_portrait", "identity", "serve_landscape",
        "serve_portrait", "serve_square", "down_2x", "up_x11"])
def test_resize_matches_cv2_bit_for_bit(hw, canvas):
    pytest.importorskip("cv2")
    image = np.random.default_rng(7).integers(0, 256, hw + (3,)).astype(
        np.uint8)
    want, want_hw = jax_pipeline.fit_image_to_canvas(image, canvas)
    got, got_hw = pipeline.fit_image_to_canvas(image, canvas)
    assert got_hw == want_hw and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_keeps_the_vertical_border_weights(monkeypatch):
    """cv2 clamps a border row's two indices but not their weights, unlike
    the horizontal axis, where the weight moves to the edge pixel."""
    pytest.importorskip("cv2")
    import cv2

    y0, y1, b0, b1 = pipeline._linear_coeffs(6, 23, False, "cpu")
    assert y0[0] == y1[0] == 0 and b0[0] > 0 and b1[0] > 0
    x0, x1, a0, a1 = pipeline._linear_coeffs(8, 31, True, "cpu")
    assert x0[0] == 0 and a0[0] == 2048 and a1[0] == 0
    assert x0[-1] == x1[-1] == 7 and a0[-1] == 2048 and a1[-1] == 0
    image = np.random.default_rng(8).integers(0, 256, (6, 8, 3)).astype(
        np.uint8)
    want = cv2.resize(image, (31, 23), interpolation=cv2.INTER_LINEAR)
    got = pipeline.resize_bilinear_u8(torch.from_numpy(image), 23, 31)
    np.testing.assert_array_equal(got.numpy(), want)
    # Clamping the vertical weights too changes the border rows.
    coeffs = pipeline._linear_coeffs
    monkeypatch.setattr(pipeline, "_linear_coeffs",
                        lambda src, dst, _, device: coeffs(src, dst, True,
                                                           device))
    clamped = pipeline.resize_bilinear_u8(torch.from_numpy(image), 23, 31)
    assert (clamped.numpy() != want).any()


def test_canvas_matches_jax():
    for min_dim in (1200, 800, 600, 400, 64):
        assert (pipeline.compute_canvas(min_dim)
                == jax_pipeline.compute_canvas(min_dim))
    assert pipeline.compute_canvas(1200) == (1216, 1824)


def test_predict_accepts_a_decoded_image(models):
    _, _, _, model, params, reader = models
    predictor = evaluator.MultiScalePredictor(model, params, reader)
    example = _example(np.random.default_rng(5), (64, 96), "decoded")
    from_bytes = predictor.predict(example)
    decoded = dict(example,
                   image=pipeline.decode_jpeg(example["image_encoded"]))
    del decoded["image_encoded"]
    from_array = predictor.predict(decoded)
    for k, v in from_bytes["proposal_scores"].items():
        np.testing.assert_array_equal(from_array["proposal_scores"][k], v)


def test_missing_pil_and_label_file_raise(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        pipeline.decode_jpeg(b"\xff\xd8")
    cfg = schema.loads_pipeline(_PIPELINE % (
        4, "", str(tmp_path / "absent.txt")))
    with pytest.raises(FileNotFoundError, match="absent.txt"):
        extractors.build_label_extractor(
            cfg.model.cap2det_model.label_extractor)


def test_cuda_is_the_default_device(label_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = schema.loads_pipeline(_PIPELINE % (4, "", label_file))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build(cfg.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_lib.from_jax_numpy({"w": {"beta": np.zeros(2, np.float32)}})
