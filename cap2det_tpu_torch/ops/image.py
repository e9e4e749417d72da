"""Image operations: resizers, integral images, Gaussian filtering (the
port's copy of ``cap2det_tpu/ops/image.py``, on tensors).

After the reference core/imgproc.py:
  * resize_image_to_size / _to_max_dimension / _to_min_dimension
    (:193-353): bilinear with half-pixel centres and no antialiasing,
    which is what ``jax.image.resize(..., antialias=False)`` computes and
    TF1's resize_bilinear did;
  * calc_integral_image / calc_cumsum_2d (:99-151): cumulative sums and
    box-sum queries;
  * a Gaussian kernel and separable blur (:14-28, OpenCV
    getGaussianKernel semantics for the default sigma).

As in the JAX package, nothing on the training or serving path calls
these; the input pipeline resizes with cv2's integer bilinear
(``data/pipeline.resize_bilinear_u8``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_image_to_size(image, new_height, new_width):
    """Resizes [H, W, C] to [new_height, new_width, C] float32.
    Returns (image, shape[3] int32)."""
    x = torch.as_tensor(image).to(torch.float32)
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(new_height, new_width),
                        mode="bilinear", align_corners=False,
                        antialias=False)[0].permute(1, 2, 0)
    shape = torch.tensor([new_height, new_width, x.shape[-1]],
                         dtype=torch.int32, device=x.device)
    return out, shape


def compute_new_size_min_dimension(height, width, min_dimension):
    """Target size so min(h', w') == min_dimension (reference :330-345)."""
    scale = float(min_dimension) / min(height, width)
    return int(round(height * scale)), int(round(width * scale))


def compute_new_size_max_dimension(height, width, max_dimension):
    """Target size so max(h', w') == max_dimension (reference :258-271)."""
    scale = float(max_dimension) / max(height, width)
    return int(round(height * scale)), int(round(width * scale))


def resize_image_to_min_dimension(image, min_dimension):
    h, w = image.shape[:2]
    nh, nw = compute_new_size_min_dimension(h, w, min_dimension)
    return resize_image_to_size(image, nh, nw)


def resize_image_to_max_dimension(image, max_dimension, pad_to_max=False):
    h, w = image.shape[:2]
    nh, nw = compute_new_size_max_dimension(h, w, max_dimension)
    out, shape = resize_image_to_size(image, nh, nw)
    if pad_to_max:
        out = F.pad(out, (0, 0, 0, max_dimension - nw, 0, max_dimension - nh))
    return out, shape


def calc_integral_image(image):
    """[..., H, W] -> [..., H+1, W+1] integral image (zero row/col first)."""
    s = torch.cumsum(torch.cumsum(torch.as_tensor(image), dim=-2), dim=-1)
    return F.pad(s, (1, 0, 1, 0))


def calc_cumsum_2d(image, boxes):
    """Box sums via the integral image.

    Args:
      image: [batch, H, W] values.
      boxes: [batch, N, 4] integer [ymin, xmin, ymax, xmax] (exclusive
        max, pixel units).

    Returns:
      [batch, N] sums over each box.
    """
    integral = calc_integral_image(image)  # [B, H+1, W+1]
    boxes = torch.as_tensor(boxes, dtype=torch.int64,
                            device=integral.device)
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    b = torch.arange(integral.shape[0], device=integral.device)[:, None]
    return (integral[b, ymax, xmax] - integral[b, ymin, xmax]
            - integral[b, ymax, xmin] + integral[b, ymin, xmin])


_OPENCV_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel(ksize, sigma=-1.0):
    """1-D Gaussian kernel matching OpenCV getGaussianKernel: for
    sigma<=0, small odd sizes use OpenCV's fixed binomial tables, larger
    sizes the formula sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0 and ksize in _OPENCV_SMALL_GAUSSIAN:
        return torch.tensor(_OPENCV_SMALL_GAUSSIAN[ksize], dtype=torch.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return torch.tensor(k / k.sum(), dtype=torch.float32)


def gaussian_filter(image, ksize=3, sigma=-1.0):
    """Separable Gaussian blur over [..., H, W], edges replicated
    (reference :14-28)."""
    image = torch.as_tensor(image)
    k = gaussian_kernel(ksize, sigma).to(image.device)
    pad = ksize // 2
    lead = image.shape[:-2]
    h, w = image.shape[-2:]
    x = image.reshape((-1, h, w))
    rows_idx = torch.arange(-pad, h + pad, device=image.device).clamp(0, h - 1)
    xp = x[:, rows_idx, :]
    rows = sum(xp[:, i:i + h, :] * k[i] for i in range(ksize))
    cols_idx = torch.arange(-pad, w + pad, device=image.device).clamp(0, w - 1)
    rp = rows[:, :, cols_idx]
    out = sum(rp[:, :, j:j + w] * k[j] for j in range(ksize))
    return out.reshape(lead + (h, w))
