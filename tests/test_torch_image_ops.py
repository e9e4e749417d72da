"""The port's ``ops/image.py`` against the JAX package's on seeded inputs
(resizes and blurs to rtol 1e-5, integral images and box sums exactly),
and the port's model protocol (``models/base.py``)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap2det_tpu.ops import image as jax_image
from cap2det_tpu_torch.models import base, cap2det, text_model
from cap2det_tpu_torch.ops import image

torch.set_num_threads(1)

RTOL = 1e-5  # float32 sums in another order


@pytest.mark.parametrize("src,dst", [((7, 9), (16, 20)), ((30, 40), (11, 13)),
                                     ((12, 12), (5, 30)), ((1, 6), (4, 3))],
                         ids=["up", "down", "mixed", "one_row"])
def test_resize_to_size_matches_jax(src, dst):
    img = np.random.default_rng(0).uniform(0, 255, src + (3,)).astype(
        np.float32)
    want, want_shape = jax_image.resize_image_to_size(img, *dst)
    got, shape = image.resize_image_to_size(img, *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_array_equal(shape.numpy(), np.asarray(want_shape))


def test_resize_uint8_to_dimensions_matches_jax():
    img = np.random.default_rng(1).integers(0, 256, (30, 60, 3)).astype(
        np.uint8)
    assert (image.compute_new_size_min_dimension(480, 640, 1000)
            == jax_image.compute_new_size_min_dimension(480, 640, 1000))
    assert (image.compute_new_size_max_dimension(480, 640, 320)
            == jax_image.compute_new_size_max_dimension(480, 640, 320))
    for got, want in (
            (image.resize_image_to_min_dimension(img, 15),
             jax_image.resize_image_to_min_dimension(img, 15)),
            (image.resize_image_to_max_dimension(img, 40, pad_to_max=True),
             jax_image.resize_image_to_max_dimension(img, 40,
                                                     pad_to_max=True))):
        assert got[0].dtype == torch.float32
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=RTOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_integral_image_and_box_sums_equal_jax():
    rng = np.random.default_rng(2)
    # Integers: every partial sum is exact in float32 on both sides.
    img = rng.integers(0, 100, (2, 8, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        image.calc_integral_image(img).numpy(),
        np.asarray(jax_image.calc_integral_image(img)))
    lo = rng.integers(0, 4, (2, 6, 2))
    hi = lo + rng.integers(0, 5, (2, 6, 2))
    boxes = np.concatenate([lo, hi], -1).astype(np.int32)  # y0 x0 y1 x1
    want = np.asarray(jax_image.calc_cumsum_2d(img, boxes))
    np.testing.assert_array_equal(image.calc_cumsum_2d(img, boxes).numpy(),
                                  want)
    b, n = 1, 4
    y0, x0, y1, x1 = boxes[b, n]
    assert want[b, n] == img[b, y0:y1, x0:x1].sum()


@pytest.mark.parametrize("ksize,sigma", [(1, -1.0), (3, -1.0), (5, -1.0),
                                         (7, -1.0), (9, -1.0), (5, 1.5)])
def test_gaussian_kernel_and_filter_match_jax(ksize, sigma):
    np.testing.assert_array_equal(
        image.gaussian_kernel(ksize, sigma).numpy(),
        np.asarray(jax_image.gaussian_kernel(ksize, sigma)))
    img = np.random.default_rng(3).uniform(0, 255, (2, 3, 11, 14)).astype(
        np.float32)
    want = jax.jit(lambda x: jax_image.gaussian_filter(x, ksize, sigma))(
        jnp.asarray(img))
    got = image.gaussian_filter(img, ksize, sigma)
    assert got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("model", [cap2det.Cap2DetModel,
                                   text_model.TextModel])
def test_models_follow_the_model_protocol(model):
    assert issubclass(model, base.ModelBase)
    assert not inspect.isabstract(model)
    assert list(inspect.signature(model.loss).parameters) == [
        "self", "params", "batch", "generator", "is_training"]
    for name in ("init_params", "pipeline_kwargs", "device_batch",
                 "non_trainable_paths", "non_trainable_substrings"):
        assert hasattr(model, name), name
    assert model.non_trainable_paths == ("word_embedding",)
    if model is cap2det.Cap2DetModel:
        assert callable(model.predictions)
