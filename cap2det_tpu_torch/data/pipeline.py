"""Image decoding and canvas fitting for serving (the port's copy of the
eval-time part of ``cap2det_tpu/data/pipeline.py``).

The resize is cv2's fixed-point INTER_LINEAR for uint8 images, written
as integer tensor arithmetic on whatever device the image lies on, so a
canvas equals the JAX package's (``cv2.resize``) bit for bit.
"""

from __future__ import annotations

import io

import numpy as np
import torch


def decode_jpeg(data):
    """Encoded image bytes -> [H, W, 3] uint8 RGB array (needs Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decode_jpeg needs Pillow (PIL), which is not installed; pass a "
            "decoded uint8 image instead"
        ) from e
    img = Image.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def _round_up(x, m):
    return int(-(-x // m) * m)


def compute_canvas(min_dimension, scale=1.0, aspect_cap=1.5, multiple=32):
    """Fixed (short_side, long_side) canvas for one scale bucket."""
    short = _round_up(round(min_dimension * scale), multiple)
    long = _round_up(round(min_dimension * scale * aspect_cap), multiple)
    return short, long


# cv2's INTER_RESIZE_COEF_SCALE: interpolation weights in 1/2048ths.
_COEF_SCALE = 2048


def _linear_coeffs(src, dst, clamp_weights, device):
    """cv2's fixed-point bilinear coefficients of one axis: the two source
    indices and their integer weights for each of the `dst` outputs.

    The source position is float32((d + 0.5) * src/dst - 0.5), its floor
    the first index and the rest the fraction f; the weights are 1 - f and
    f in 1/2048ths, rounded half to even. cv2 clamps the horizontal axis
    as a whole (an index outside the map moves to the edge with f = 0) but
    only the two row indices of the vertical axis, whose weights stay as
    computed (`clamp_weights` False).
    """
    scale = 1.0 / (dst / src)
    # Built on the image's device: a copy from the host would wait for the
    # work queued before it.
    pos = ((torch.arange(dst, dtype=torch.float64, device=device) + 0.5)
           * scale - 0.5).to(torch.float32)
    first = torch.floor(pos)
    frac = pos - first
    first = first.to(torch.int64)
    if clamp_weights:
        low, high = first < 0, first >= src - 1
        first = torch.where(low, 0, torch.where(high, src - 1, first))
        frac = torch.where(low | high, 0.0, frac)
    w1 = torch.round(frac * _COEF_SCALE)
    w0 = torch.round((1.0 - frac) * _COEF_SCALE)
    return (first.clamp(0, src - 1), (first + 1).clamp(0, src - 1),
            w0.to(torch.int32), w1.to(torch.int32))


def resize_bilinear_u8(image, new_h, new_w):
    """[H, W, C] uint8 tensor -> [new_h, new_w, C] uint8, bit for bit as
    ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)``: a horizontal pass
    into int32 (weights sum to 2048), then cv2's SIMD vertical pass,
    ((b0 * (H0 >> 4)) >> 16) + ((b1 * (H1 >> 4)) >> 16) rounded by
    (+ 2) >> 2."""
    h, w = image.shape[:2]
    x0, x1, a0, a1 = _linear_coeffs(w, new_w, True, image.device)
    y0, y1, b0, b1 = _linear_coeffs(h, new_h, False, image.device)
    src = image.to(torch.int32)
    rows = src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]
    out = (((b0[:, None, None] * (rows[y0] >> 4)) >> 16)
           + ((b1[:, None, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


def resize_to_canvas(image, canvas_hw):
    """Keep-aspect resize so min-dim hits the canvas short side (or the
    image fits, whichever is smaller).

    Args:
      image: [H, W, 3] uint8 tensor or array.

    Returns:
      (resized [new_h, new_w, 3] uint8 tensor on the image's device,
      (new_h, new_w)).
    """
    image = torch.as_tensor(image)
    if image.dtype != torch.uint8:
        raise TypeError("resize_to_canvas: uint8 image expected, got %s"
                        % image.dtype)
    ch, cw = canvas_hw
    h, w = image.shape[:2]
    target = min(ch, cw) / min(h, w)
    scale = min(target, ch / h, cw / w)
    new_h = max(1, min(ch, int(round(h * scale))))
    new_w = max(1, min(cw, int(round(w * scale))))
    return resize_bilinear_u8(image, new_h, new_w), (new_h, new_w)


def fit_image_to_canvas(image, canvas_hw):
    """resize_to_canvas + top-left placement on a zero uint8 canvas.

    Returns (canvas [ch, cw, 3] uint8 tensor, (new_h, new_w)).
    """
    resized, (new_h, new_w) = resize_to_canvas(image, canvas_hw)
    ch, cw = canvas_hw
    canvas = torch.zeros((ch, cw, 3), dtype=torch.uint8, device=resized.device)
    canvas[:new_h, :new_w] = resized
    return canvas, (new_h, new_w)
