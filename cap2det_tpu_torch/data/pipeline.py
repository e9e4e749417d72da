"""Image decoding and canvas fitting for serving (the port's copy of the
eval-time part of ``cap2det_tpu/data/pipeline.py``).

The resize is bilinear ``F.interpolate`` (align_corners=False, no
antialiasing) rounded back to uint8, on whatever device the image lies
on. The JAX package resizes with cv2's fixed-point bilinear, so a resized
canvas may differ from it by one intensity step; an identity resize is
exact.
"""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F


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
    ch, cw = canvas_hw
    h, w = image.shape[:2]
    target = min(ch, cw) / min(h, w)
    scale = min(target, ch / h, cw / w)
    new_h = max(1, min(ch, int(round(h * scale))))
    new_w = max(1, min(cw, int(round(w * scale))))
    x = image.permute(2, 0, 1)[None].float()
    resized = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                            align_corners=False, antialias=False)
    resized = resized.round_().clamp_(0, 255).to(torch.uint8)
    return resized[0].permute(1, 2, 0), (new_h, new_w)


def fit_image_to_canvas(image, canvas_hw):
    """resize_to_canvas + top-left placement on a zero uint8 canvas.

    Returns (canvas [ch, cw, 3] uint8 tensor, (new_h, new_w)).
    """
    resized, (new_h, new_w) = resize_to_canvas(image, canvas_hw)
    ch, cw = canvas_hw
    canvas = torch.zeros((ch, cw, 3), dtype=torch.uint8, device=resized.device)
    canvas[:new_h, :new_w] = resized
    return canvas, (new_h, new_w)
