"""The port's photometric augmentation against the JAX package's, bit for
bit: its RGB<->HSV against ``cv2.cvtColor`` on every uint8 input, each op
and the whole chain from the same ``random.Random`` seeds, and the input
pipeline's batches with the chain on (the opt-in and all four
probabilities set) against JAX's ``InputPipeline(pack_s2d=False)``."""

import random

import cv2
import numpy as np
import pytest
import torch

from cap2det_tpu.config import schema as jax_schema
from cap2det_tpu.data import augment as jax_augment
from cap2det_tpu.data import pipeline as jax_pipeline
from cap2det_tpu.text import extractors as jax_extractors
from cap2det_tpu_torch.config import schema
from cap2det_tpu_torch.data import augment, pipeline, synthetic
from cap2det_tpu_torch.fields import InputFields
from cap2det_tpu_torch.text import extractors
from tests.test_torch_input_pipeline import KEYS, _reader, _take, _write

torch.set_num_threads(1)

PHOTOMETRIC = """preprocess_options {
  random_flip_left_right_prob: 0.5
  random_brightness_prob: 0.6 random_brightness_max_delta: 0.3
  random_contrast_prob: 0.6
  random_hue_prob: 0.6 random_hue_max_delta: 0.25
  random_saturation_prob: 0.6 random_saturation_lower: 0.5
  random_saturation_upper: 1.6
  %s
}"""
OPT_IN = "enable_photometric_augmentation: true"


def test_rgb_to_hsv_equals_cv2_on_every_color():
    cube = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([cube >> 16, (cube >> 8) & 255, cube & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(augment.rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [2048, 31], ids=["vector", "scalar"])
def test_hsv_to_rgb_equals_cv2_on_every_triple(width):
    """cv2's vector loop takes a row's first multiple of 32 pixels, its
    scalar code the rest: rows of 2048 hold every triple to the first,
    rows of 31 to the second (the last 23 triples are left out)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)
    hsv = hsv[:len(hsv) - len(hsv) % width].reshape(-1, width, 3)
    np.testing.assert_array_equal(augment.hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("shape", [(37, 53), (5, 100), (2, 64), (4, 65),
                                   (1, 1961), (13, 17), (96, 72)])
def test_hsv_to_rgb_splits_each_row_as_cv2(shape):
    rng = np.random.default_rng(shape[1])
    hsv = np.concatenate([rng.integers(0, 180, shape + (1,)),
                          rng.integers(0, 256, shape + (2,))], -1).astype(
                              np.uint8)
    np.testing.assert_array_equal(augment.hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _image(seed, hw=(37, 53)):
    return np.random.default_rng(seed).integers(0, 256, hw + (3,)).astype(
        np.uint8)


OPS = {
    "brightness": lambda m, img, rs: m.random_brightness(img, 0.3, rs),
    "contrast": lambda m, img, rs: m.random_contrast(img, 0.5, 1.5, rs),
    "hue": lambda m, img, rs: m.random_hue(img, 0.4, rs),
    "saturation": lambda m, img, rs: m.random_saturation(img, 0.3, 1.9, rs),
    "crop": lambda m, img, rs: m.random_crop(img, 0.5, rs),
}


@pytest.mark.parametrize("op", list(OPS), ids=list(OPS))
def test_each_op_equals_jax(op):
    for seed in range(8):
        img = _image(seed)
        want = OPS[op](jax_augment, img.copy(), np.random.RandomState(seed))
        got = OPS[op](augment, img.copy(), np.random.RandomState(seed))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg="seed %d" % seed)


def test_apply_photometric_equals_jax():
    text = "train_reader { cap2det_reader { %s } }" % (PHOTOMETRIC % OPT_IN)
    jax_opts = jax_schema.loads_pipeline(
        text).train_reader.cap2det_reader.preprocess_options
    opts = schema.loads_pipeline(
        text).train_reader.cap2det_reader.preprocess_options
    assert augment.has_photometric(opts) and jax_augment.has_photometric(
        jax_opts)
    changed = 0
    for seed in range(24):
        img = _image(seed)
        jax_rng, rng = random.Random(seed), random.Random(seed)
        want = jax_augment.apply_photometric(img.copy(), jax_opts, jax_rng)
        got = augment.apply_photometric(img.copy(), opts, rng)
        np.testing.assert_array_equal(got, want, err_msg="seed %d" % seed)
        assert rng.random() == jax_rng.random()  # the same draws taken
        changed += not np.array_equal(got, img)
    assert changed > 12
    img = _image(0)
    assert augment.apply_photometric(img, None, random.Random(0)) is img


def _photometric_pipelines(records, opt_in):
    pattern, label_file = records
    text = ('input_pattern: "%s" is_training: true shuffle_buffer_size: 4 '
            'batch_size: 2 image_resizer { keep_aspect_ratio_resizer { '
            'min_dimension: 64 } } max_num_proposals: 16 '
            'batch_resize_scale_value: 1.0 batch_resize_scale_value: 0.5 %s'
            % (pattern, PHOTOMETRIC % opt_in))
    extractor = {"groundtruth_extractor": {"label_file": label_file}}
    want = jax_pipeline.InputPipeline(
        _reader(jax_schema, text),
        label_extractor=jax_extractors.build_label_extractor(
            jax_schema.LabelExtractor.from_dict(extractor)),
        seed=4, pack_s2d=False)
    got = pipeline.InputPipeline(
        _reader(schema, text),
        label_extractor=extractors.build_label_extractor(
            schema.LabelExtractor.from_dict(extractor)),
        seed=4)
    return got, want


def test_photometric_batches_equal_jax(tmp_path, monkeypatch):
    records = _write(synthetic, tmp_path)
    with pytest.raises(ValueError, match="opt in"):
        _photometric_pipelines(records, "")
    calls = []
    real = augment.apply_photometric
    monkeypatch.setattr(augment, "apply_photometric",
                        lambda *a: calls.append(1) or real(*a))
    got_pipe, want_pipe = _photometric_pipelines(records, OPT_IN)
    got, want = _take(got_pipe, 8), _take(want_pipe, 8)
    assert len(calls) >= 16  # every example went through the chain
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[InputFields.image_id] == w[InputFields.image_id], i
        for key in KEYS:
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg="batch %d %s" % (i, key))
        for gb, wb in zip(g[InputFields.object_boxes],
                          w[InputFields.object_boxes]):
            np.testing.assert_array_equal(gb, wb)
