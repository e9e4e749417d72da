"""Photometric augmentations, host-side numpy (the port's copy of
``cap2det_tpu/data/augment.py``).

The reference's v1 photometric chain (core/preprocess.py:81-148):
brightness, contrast, hue and saturation, each drawn with its
probability, in the JAX package's order and from its random draws, so
both packages give the same pixels from one ``random.Random``. The
reference's cap2det reader never runs this chain (its v2 preprocess is
flip-only), so the input pipeline refuses these options unless
``enable_photometric_augmentation`` opts in.

The JAX package converts to and from HSV with ``cv2.cvtColor``. The port
has no OpenCV: ``rgb_to_hsv`` and ``hsv_to_rgb`` compute what cv2 does
for uint8 (hue in [0, 180)), bit for bit on every input.
"""

from __future__ import annotations

import numpy as np

# cv2's RGB2HSV_b: 12-bit fixed point, with tables of rounded quotients.
_HSV_SHIFT = 12
_DIVISORS = np.arange(1, 256, dtype=np.float64)
_SDIV = np.zeros(256, np.int32)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / _DIVISORS)
_HDIV180 = np.zeros(256, np.int32)
_HDIV180[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * _DIVISORS))
# cv2's HSV2RGB sector table: per sector, the (b, g, r) entries of
# (v, v(1 - s), v(1 - s h), v(1 - s (1 - h))).
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])
# cv2 (its x86-64 build) converts HSV to uint8 RGB row by row: its vector
# loop takes 32 pixels at a time and truncates, the pixels left over at
# the row's end go through its scalar code, which rounds to nearest even.
_CV2_VECTOR_PIXELS = 32


def has_photometric(options):
    """True when any v1 photometric probability is nonzero."""
    if options is None:
        return False
    return any(
        getattr(options, name) > 0
        for name in (
            "random_brightness_prob",
            "random_contrast_prob",
            "random_hue_prob",
            "random_saturation_prob",
        )
    )


def rgb_to_hsv(image):
    """uint8 [..., 3] RGB -> uint8 HSV, hue in [0, 180): cv2's integer
    conversion (``cvtColor(COLOR_RGB2HSV)``)."""
    x = image.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fused(a, b, c):
    """a * b + c rounded to float32 once, as a fused multiply-add: the
    float32 product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def hsv_to_rgb(image):
    """uint8 [H, W, 3] HSV, hue in [0, 180) -> uint8 RGB: cv2's float32
    conversion (``cvtColor(COLOR_HSV2RGB)``): s and v scaled by 1/255, the
    hue's sector and fraction, v(1 - s h) and v(1 - s (1 - h)) with fused
    multiply-adds, each channel times 255, then truncated toward zero in
    the first multiple of 32 columns and rounded to nearest even in the
    rest (``_CV2_VECTOR_PIXELS``)."""
    f32 = np.float32
    one = f32(1.0)
    h = image[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = image[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = image[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = h - sector
    tab = np.stack([v, v * (one - s), v * _fused(-s, h, 1.0),
                    v * _fused(-s, one - h, 1.0)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1)
    rgb = bgr[..., ::-1] * f32(255.0)
    width = image.shape[-2]
    vector = np.arange(width) < width - width % _CV2_VECTOR_PIXELS
    rgb = np.where(vector[:, None], np.trunc(rgb), np.rint(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def random_brightness(image, max_delta, rng):
    """tf.image.random_brightness on uint8: add delta*255."""
    delta = rng.uniform(-max_delta, max_delta)
    return np.clip(image.astype(np.float32) + delta * 255.0, 0, 255).astype(
        np.uint8
    )


def random_contrast(image, lower, upper, rng):
    factor = rng.uniform(lower, upper)
    x = image.astype(np.float32)
    mean = x.mean(axis=(0, 1), keepdims=True)
    return np.clip((x - mean) * factor + mean, 0, 255).astype(np.uint8)


def random_hue(image, max_delta, rng):
    """tf.image.random_hue: rotate hue by delta (fraction of the wheel)."""
    delta = rng.uniform(-max_delta, max_delta)
    hsv = rgb_to_hsv(image)
    # The uint8 hue range is [0, 180).
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(delta * 180)) % 180
    return hsv_to_rgb(hsv)


def random_saturation(image, lower, upper, rng):
    factor = rng.uniform(lower, upper)
    hsv = rgb_to_hsv(image).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0, 255)
    return hsv_to_rgb(hsv.astype(np.uint8))


def random_crop(image, min_scale, rng):
    """Crops to a random window with sides >= min_scale of the original
    (reference core/preprocess.py:10-39)."""
    h, w = image.shape[:2]
    min_h = int(round(h * min_scale))
    min_w = int(round(w * min_scale))
    target_h = rng.randint(min_h, h + 1)
    target_w = rng.randint(min_w, w + 1)
    off_h = rng.randint(0, h + 1 - target_h)
    off_w = rng.randint(0, w + 1 - target_w)
    return image[off_h : off_h + target_h, off_w : off_w + target_w]


def apply_photometric(image, options, rng):
    """Applies the v1 augmentation chain per config probabilities (flip
    and crop excluded: the pipeline flips with its boxes, and refuses the
    crop)."""
    if options is None:
        return image
    if options.random_brightness_prob > 0 and rng.random() < options.random_brightness_prob:
        image = random_brightness(image, options.random_brightness_max_delta, _np_rng(rng))
    if options.random_contrast_prob > 0 and rng.random() < options.random_contrast_prob:
        image = random_contrast(
            image, options.random_contrast_lower, options.random_contrast_upper,
            _np_rng(rng),
        )
    if options.random_hue_prob > 0 and rng.random() < options.random_hue_prob:
        image = random_hue(image, options.random_hue_max_delta, _np_rng(rng))
    if options.random_saturation_prob > 0 and rng.random() < options.random_saturation_prob:
        image = random_saturation(
            image, options.random_saturation_lower,
            options.random_saturation_upper, _np_rng(rng),
        )
    return image


def _np_rng(py_rng):
    return np.random.RandomState(py_rng.randrange(1 << 31))
