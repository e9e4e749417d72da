"""Fused ROI crop_and_resize + max-pool (port of
``cap2det_tpu/kernels/roi_pool.py``, forward).

``roi_crop_maxpool`` launches ``csrc/roi_pool.cu`` for CUDA tensors and
runs the plain version (``ops/roi.crop_resize_maxpool``) for CPU tensors.
The kernel handles every pool kernel/stride with kernel <= crop, so unlike
the JAX package no config falls back to the plain path on the card.
Forward only: the backward (K2) arrives with the training step.
"""

from __future__ import annotations

import ctypes

import torch

from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.ops import roi as roi_ops

# The JAX package's alternative TPU formulations compute the same function.
IMPLS = ("slice", "ymm", "mm")
MAX_CROP = 64  # kMaxCrop in csrc/roi_pool.cu

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _threads(channels):
    """Threads per block along C: the fewest warps that cover C in tiles
    of at most 256 channels (576 -> 3 tiles of 192)."""
    tiles = -(-channels // 256)
    return 32 * -(-channels // (32 * tiles))


def _launch(features, boxes, crop_size, pool_kernel, pool_stride):
    global launches
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("roi_crop_maxpool: features must be float32 or "
                        "bfloat16, got %s" % features.dtype)
    if boxes.dtype != torch.float32:
        raise TypeError("roi_crop_maxpool: boxes must be float32, got %s"
                        % boxes.dtype)
    if boxes.device != features.device:
        raise ValueError("roi_crop_maxpool: boxes on %s, features on %s"
                         % (boxes.device, features.device))
    if not (features.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("roi_crop_maxpool: inputs must be contiguous")
    if not 1 <= pool_kernel <= crop_size <= MAX_CROP or pool_stride < 1:
        raise ValueError(
            "roi_crop_maxpool: needs 1 <= pool_kernel <= crop_size <= %d and "
            "pool_stride >= 1; got %d, %d, %d"
            % (MAX_CROP, pool_kernel, crop_size, pool_stride)
        )
    batch, height, width, channels = features.shape
    num_p = boxes.shape[1]
    pooled = (crop_size - pool_kernel) // pool_stride + 1
    out = torch.empty(
        (batch, num_p, pooled, pooled, channels), dtype=features.dtype,
        device=features.device,
    )
    if out.numel() == 0:
        return out
    fn = build.function("cap2det_roi_crop_maxpool_fwd", _ARGTYPES)
    with torch.cuda.device(features.device):
        rc = fn(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            batch, height, width, channels, num_p, crop_size, pool_kernel,
            pool_stride, int(features.dtype == torch.bfloat16),
            _threads(channels), torch.cuda.current_stream().cuda_stream,
        )
    build.check(rc, "roi_crop_maxpool")
    launches += 1
    return out


def roi_crop_maxpool(features, boxes, crop_size, pool_kernel=2,
                     pool_stride=2, impl="slice"):
    """Fused TF-semantics crop_and_resize + VALID max-pool.

    Args:
      features: [B, H, W, C] float32 or bfloat16 feature map, H, W >= 2.
      boxes: [B, P, 4] float32 normalized [ymin, xmin, ymax, xmax].
      crop_size: S (pre-pool crop side).
      impl: accepted for the JAX package's names ("slice", "ymm", "mm");
        all compute the same function and run the one kernel.

    Returns:
      [B, P, S', S', C] in the features' dtype,
      S' = (S - pool_kernel)//pool_stride + 1.
    """
    if impl not in IMPLS:
        raise ValueError("roi_crop_maxpool: unknown impl %r" % (impl,))
    if (features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4
            or boxes.shape[0] != features.shape[0]):
        raise ValueError("roi_crop_maxpool: features [B,H,W,C] and boxes "
                         "[B,P,4] expected; got %s and %s"
                         % (tuple(features.shape), tuple(boxes.shape)))
    if features.shape[1] < 2 or features.shape[2] < 2:
        raise ValueError(
            "roi_crop_maxpool needs a feature map of at least 2x2; got %s"
            % (tuple(features.shape),)
        )
    if features.is_cuda or boxes.is_cuda:
        return _launch(features, boxes, crop_size, pool_kernel, pool_stride)
    return roi_ops.crop_resize_maxpool(
        features, boxes, crop_size, pool_kernel, pool_stride
    )
