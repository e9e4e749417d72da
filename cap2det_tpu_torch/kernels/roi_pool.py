"""Fused ROI crop_and_resize + max-pool, forward and backward (port of
``cap2det_tpu/kernels/roi_pool.py``).

``roi_crop_maxpool`` is a ``torch.autograd.Function``: its forward (K1)
launches ``csrc/roi_pool.cu``, its backward (K2,
``roi_crop_maxpool_grad``) launches ``csrc/roi_pool_bwd.cu``; for CPU
tensors both run their plain versions (``ops/roi.crop_resize_maxpool`` and
``crop_resize_maxpool_grad``). The kernels handle every pool
kernel/stride with kernel <= crop, so unlike the JAX package no config
falls back to the plain path on the card. Boxes are data and get no
gradient; when the features need none either (a frozen first stage),
autograd never calls the backward.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.ops import roi as roi_ops

# The JAX package's alternative TPU formulations compute the same function
# forward and backward ("mm" is K1-mm/K2-mm there).
IMPLS = ("slice", "ymm", "mm")
MAX_CROP = 64  # kMaxCrop in csrc/roi_common.cuh

# Launch counts of K1 (forward) and K2 (backward).
launches = 0
grad_launches = 0

_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _threads(channels):
    """Threads per block along C: the fewest warps that cover C in tiles
    of at most 256 channels (576 -> 3 tiles of 192)."""
    tiles = -(-channels // 256)
    return 32 * -(-channels // (32 * tiles))


def _pooled(crop_size, pool_kernel, pool_stride):
    return (crop_size - pool_kernel) // pool_stride + 1


def _check_launch(name, features, boxes, crop_size, pool_kernel,
                  pool_stride):
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s: features must be float32 or bfloat16, got %s"
                        % (name, features.dtype))
    if boxes.dtype != torch.float32:
        raise TypeError("%s: boxes must be float32, got %s"
                        % (name, boxes.dtype))
    if boxes.device != features.device:
        raise ValueError("%s: boxes on %s, features on %s"
                         % (name, boxes.device, features.device))
    if not (features.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("%s: inputs must be contiguous" % name)
    if not 1 <= pool_kernel <= crop_size <= MAX_CROP or pool_stride < 1:
        raise ValueError(
            "%s: needs 1 <= pool_kernel <= crop_size <= %d and "
            "pool_stride >= 1; got %d, %d, %d"
            % (name, MAX_CROP, pool_kernel, crop_size, pool_stride)
        )


def _launch(features, boxes, crop_size, pool_kernel, pool_stride):
    global launches
    _check_launch("roi_crop_maxpool", features, boxes, crop_size,
                  pool_kernel, pool_stride)
    batch, height, width, channels = features.shape
    num_p = boxes.shape[1]
    pooled = _pooled(crop_size, pool_kernel, pool_stride)
    out = torch.empty(
        (batch, num_p, pooled, pooled, channels), dtype=features.dtype,
        device=features.device,
    )
    if out.numel() == 0:
        return out
    fn = build.function("cap2det_roi_crop_maxpool_fwd", _FWD_ARGTYPES)
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


def _launch_grad(features, boxes, grad, crop_size, pool_kernel, pool_stride):
    global grad_launches
    name = "roi_crop_maxpool_grad"
    _check_launch(name, features, boxes, crop_size, pool_kernel, pool_stride)
    if grad.dtype != features.dtype or grad.device != features.device:
        raise TypeError("%s: grad is %s on %s, features %s on %s"
                        % (name, grad.dtype, grad.device, features.dtype,
                           features.device))
    if not grad.is_contiguous():
        raise ValueError("%s: grad must be contiguous" % name)
    batch, height, width, channels = features.shape
    num_p = boxes.shape[1]
    # The kernel adds into a float32 map with atomics.
    dfeat = torch.zeros(features.shape, dtype=torch.float32,
                        device=features.device)
    if num_p == 0 or dfeat.numel() == 0:
        return dfeat.to(features.dtype)
    fn = build.function("cap2det_roi_crop_maxpool_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(features.device):
        rc = fn(
            features.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
            dfeat.data_ptr(), batch, height, width, channels, num_p,
            crop_size, pool_kernel, pool_stride,
            int(features.dtype == torch.bfloat16), _threads(channels),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(rc, name)
    grad_launches += 1
    return dfeat.to(features.dtype)


def _check_args(name, features, boxes):
    if (features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4
            or boxes.shape[0] != features.shape[0]):
        raise ValueError("%s: features [B,H,W,C] and boxes [B,P,4] "
                         "expected; got %s and %s"
                         % (name, tuple(features.shape), tuple(boxes.shape)))
    if features.shape[1] < 2 or features.shape[2] < 2:
        raise ValueError(
            "%s needs a feature map of at least 2x2; got %s"
            % (name, tuple(features.shape),)
        )


def roi_crop_maxpool_grad(features, boxes, grad, crop_size, pool_kernel=2,
                          pool_stride=2):
    """dF of ``roi_crop_maxpool`` (K2): each pooled gradient goes to the
    first maximal crop sample of its window, in row-major order, and
    through that sample's bilinear weights into dF, accumulated in float32
    and returned in the features' dtype.

    Args:
      features: [B, H, W, C] float32 or bfloat16.
      boxes: [B, P, 4] float32 normalized [ymin, xmin, ymax, xmax].
      grad: [B, P, S', S', C] in the features' dtype.
    """
    _check_args("roi_crop_maxpool_grad", features, boxes)
    pooled = _pooled(crop_size, pool_kernel, pool_stride)
    want = tuple(boxes.shape[:2]) + (pooled, pooled, features.shape[-1])
    if tuple(grad.shape) != want:
        raise ValueError("roi_crop_maxpool_grad: grad must be %s, got %s"
                         % (want, tuple(grad.shape)))
    if features.is_cuda or boxes.is_cuda or grad.is_cuda:
        return _launch_grad(features, boxes, grad, crop_size, pool_kernel,
                            pool_stride)
    return roi_ops.crop_resize_maxpool_grad(
        features, boxes, grad, crop_size, pool_kernel, pool_stride
    )


class _RoiCropMaxpool(torch.autograd.Function):
    """K1 forward, K2 backward; no gradient for the boxes."""

    @staticmethod
    def forward(ctx, features, boxes, crop_size, pool_kernel, pool_stride):
        ctx.conf = (crop_size, pool_kernel, pool_stride)
        ctx.save_for_backward(features, boxes)
        if features.is_cuda or boxes.is_cuda:
            return _launch(features, boxes, crop_size, pool_kernel,
                           pool_stride)
        return roi_ops.crop_resize_maxpool(
            features, boxes, crop_size, pool_kernel, pool_stride
        )

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        features, boxes = ctx.saved_tensors
        dfeat = roi_crop_maxpool_grad(features, boxes, grad.contiguous(),
                                      *ctx.conf)
        return dfeat, None, None, None, None


def roi_crop_maxpool(features, boxes, crop_size, pool_kernel=2,
                     pool_stride=2, impl="slice"):
    """Fused TF-semantics crop_and_resize + VALID max-pool, differentiable
    in the features.

    Args:
      features: [B, H, W, C] float32 or bfloat16 feature map, H, W >= 2.
      boxes: [B, P, 4] float32 normalized [ymin, xmin, ymax, xmax].
      crop_size: S (pre-pool crop side).
      impl: accepted for the JAX package's names ("slice", "ymm", "mm");
        all compute the same function and run the one pair of kernels.

    Returns:
      [B, P, S', S', C] in the features' dtype,
      S' = (S - pool_kernel)//pool_stride + 1.
    """
    if impl not in IMPLS:
        raise ValueError("roi_crop_maxpool: unknown impl %r" % (impl,))
    _check_args("roi_crop_maxpool", features, boxes)
    return _RoiCropMaxpool.apply(features, boxes, crop_size, pool_kernel,
                                 pool_stride)
