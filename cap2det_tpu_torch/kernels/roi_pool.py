"""Fused ROI crop_and_resize + max-pool, forward and backward (port of
``cap2det_tpu/kernels/roi_pool.py``).

``roi_crop_maxpool`` is a ``torch.autograd.Function``: its forward (K1)
launches ``csrc/roi_pool.cu``, its backward (K2,
``roi_crop_maxpool_grad``) launches ``csrc/roi_pool_bwd.cu``; for CPU
tensors both run their plain versions (``ops/roi.crop_resize_maxpool`` and
``crop_resize_maxpool_grad``). Each source holds two kernels, and
``_staged`` picks one on the host from the crop, the pool, the map's shape
and dtype: the staged kernel (one proposal's footprint in shared memory,
16-byte lanes) for the model's shapes, the generic one (one channel per
thread) for channel rows that are not a multiple of 16 bytes and crops
too large to stage. The kernels handle every pool
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
# The staged kernels' limits (csrc/roi_common.cuh): crop, shared memory,
# the 128-byte channel tile of 8 lanes of 16 bytes, and the slot budget
# (kStagedSlots: footprint positions a block holds in shared memory).
STAGED_MAX_CROP = 32
STAGED_SMEM = 220 * 1024
TILE_BYTES = 128
STAGED_SLOTS = 256

# Launch counts of K1 (forward) and K2 (backward), and of each by path.
launches = 0
staged_launches = 0
generic_launches = 0
grad_launches = 0
grad_staged_launches = 0
grad_generic_launches = 0

_FWD_STAGED_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
_FWD_GENERIC_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                         + [ctypes.c_void_p])
_BWD_STAGED_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
_BWD_GENERIC_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                         + [ctypes.c_void_p])
_FROM_FIXED_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_void_p]


def _threads(channels):
    """Threads per block of the generic kernels, along C: the fewest warps
    that cover C in tiles of at most 256 channels (576 -> 3 tiles of
    192)."""
    tiles = -(-channels // 256)
    return 32 * -(-channels // (32 * tiles))


def _slots(crop_size, height, width):
    """A staged launch's slot budget (`staged_slots` in
    csrc/roi_common.cuh): STAGED_SLOTS, or the largest footprint,
    min(2S, H) x min(2S, W), if that is smaller."""
    return min(STAGED_SLOTS,
               min(2 * crop_size, height) * min(2 * crop_size, width))


def _staged_smem_bytes(crop_size, pool_kernel, pool_stride, height, width,
                       itemsize):
    """Dynamic shared memory of a staged K2 launch (K1 takes the first
    term): the slot budget of 128-byte tiles, plus a tile of gradients and
    of winner bytes for every pooled cell."""
    pooled = _pooled(crop_size, pool_kernel, pool_stride)
    return (_slots(crop_size, height, width) * TILE_BYTES
            + pooled * pooled * (TILE_BYTES // itemsize) * (itemsize + 1))


def _staged(crop_size, pool_kernel, pool_stride, shape, dtype, aligned=True):
    """Which kernel K1 and K2 launch: the staged one (footprint in shared
    memory, 16-byte lanes) when a row of C channels is a multiple of 16
    bytes, the pointers are 16-byte aligned, the crop and the pool's taps
    fit its limits and its shared memory fits STAGED_SMEM; else the
    generic one. The same rule as the C entries' checks."""
    _, height, width, channels = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (aligned and (channels * itemsize) % 16 == 0
            and crop_size <= STAGED_MAX_CROP
            and pool_kernel * pool_kernel <= 256
            and height * width * channels < 2 ** 31
            and _staged_smem_bytes(crop_size, pool_kernel, pool_stride,
                                  height, width, itemsize) <= STAGED_SMEM)


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
    global launches, staged_launches, generic_launches
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
    staged = _staged(crop_size, pool_kernel, pool_stride, features.shape,
                     features.dtype, build.aligned(features, out))
    args = (features.data_ptr(), boxes.data_ptr(), out.data_ptr(), batch,
            height, width, channels, num_p, crop_size, pool_kernel,
            pool_stride, int(features.dtype == torch.bfloat16))
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        if staged:
            rc = build.function("cap2det_roi_crop_maxpool_fwd_staged",
                                _FWD_STAGED_ARGTYPES)(*args, stream)
        else:
            rc = build.function("cap2det_roi_crop_maxpool_fwd_generic",
                                _FWD_GENERIC_ARGTYPES)(
                *args, _threads(channels), stream)
    build.check(rc, "roi_crop_maxpool")
    launches += 1
    if staged:
        staged_launches += 1
    else:
        generic_launches += 1
    return out


def _launch_grad(features, boxes, grad, crop_size, pool_kernel, pool_stride):
    global grad_launches, grad_staged_launches, grad_generic_launches
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
    if num_p == 0 or features.numel() == 0:
        return torch.zeros_like(features)
    staged = _staged(crop_size, pool_kernel, pool_stride, features.shape,
                     features.dtype, build.aligned(features, grad))
    # The kernel adds 64-bit fixed-point values (2^-32 units) into an int64
    # map with integer atomics, so dF has the same bits in every run; a
    # second kernel converts it to the features' dtype.
    acc = torch.zeros(features.shape, dtype=torch.int64,
                      device=features.device)
    dfeat = torch.empty_like(features)
    is_bf16 = int(features.dtype == torch.bfloat16)
    shape = (batch, height, width, channels, num_p, crop_size, pool_kernel,
             pool_stride, is_bf16)
    to_float = build.function("cap2det_roi_grad_from_fixed",
                              _FROM_FIXED_ARGTYPES)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        if staged:
            rc = build.function("cap2det_roi_crop_maxpool_bwd_staged",
                                _BWD_STAGED_ARGTYPES)(
                features.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
                acc.data_ptr(), *shape, stream)
        else:
            rc = build.function("cap2det_roi_crop_maxpool_bwd_generic",
                                _BWD_GENERIC_ARGTYPES)(
                features.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
                acc.data_ptr(), *shape, _threads(channels), stream)
        build.check(rc, name)
        rc = to_float(acc.data_ptr(), dfeat.data_ptr(), acc.numel(), is_bf16,
                      stream)
    build.check(rc, name)
    grad_launches += 1
    if staged:
        grad_staged_launches += 1
    else:
        grad_generic_launches += 1
    return dfeat


def _local_slots(crop_size, pool_kernel, pool_stride, shape, dtype):
    """The largest footprint |R| x |C| whose contributions K2 sums in
    shared int64 before its global atomics: the staged kernel's rule (its
    accumulator of 8 bytes per channel reuses the slot budget's bytes),
    0 for the generic kernel, which adds every contribution to dF."""
    if not _staged(crop_size, pool_kernel, pool_stride, shape, dtype):
        return 0
    itemsize = torch.empty((), dtype=dtype).element_size()
    channels_per_tile = TILE_BYTES // itemsize
    return (_slots(crop_size, *shape[1:3]) * TILE_BYTES
            // (channels_per_tile * 8))


def grad_atomic_counts(features, boxes, grad, crop_size, pool_kernel=2,
                       pool_stride=2):
    """K2's global int64 atomics on these inputs, counted by the
    fixed-point oracle with the kernel's rule (nothing is launched):
    {"contributions": nonzero corner contributions, one atomic each in the
    generic kernel, "atomics": the atomics of the kernel the rule picks}."""
    _check_grad_args(features, boxes, grad, crop_size, pool_kernel,
                     pool_stride)
    return roi_ops.crop_resize_maxpool_grad_atomics(
        features, boxes, grad, crop_size, pool_kernel, pool_stride,
        _local_slots(crop_size, pool_kernel, pool_stride, features.shape,
                     features.dtype))


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


def _check_grad_args(features, boxes, grad, crop_size, pool_kernel,
                     pool_stride):
    _check_args("roi_crop_maxpool_grad", features, boxes)
    pooled = _pooled(crop_size, pool_kernel, pool_stride)
    want = tuple(boxes.shape[:2]) + (pooled, pooled, features.shape[-1])
    if tuple(grad.shape) != want:
        raise ValueError("roi_crop_maxpool_grad: grad must be %s, got %s"
                         % (want, tuple(grad.shape)))


def roi_crop_maxpool_grad(features, boxes, grad, crop_size, pool_kernel=2,
                          pool_stride=2):
    """dF of ``roi_crop_maxpool`` (K2): each pooled gradient goes to the
    first maximal crop sample of its window, in row-major order, and
    through that sample's bilinear weights into dF, returned in the
    features' dtype. The kernel sums in 64-bit fixed point (bitwise the
    same in every run; ``ops/roi.crop_resize_maxpool_grad(...,
    fixed_point=True)`` gives its bits), the plain version in float32.

    Args:
      features: [B, H, W, C] float32 or bfloat16.
      boxes: [B, P, 4] float32 normalized [ymin, xmin, ymax, xmax].
      grad: [B, P, S', S', C] in the features' dtype.
    """
    _check_grad_args(features, boxes, grad, crop_size, pool_kernel,
                     pool_stride)
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
