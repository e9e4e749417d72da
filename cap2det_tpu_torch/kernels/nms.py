"""Greedy class-wise non-max suppression (the port's counterpart of the
``lax.fori_loop`` in ``cap2det_tpu/ops/nms.py`` ``_per_image_nms``, which
XLA compiles into the TPU's postprocess program; no Pallas kernel).

``nms_mask`` launches ``csrc/nms.cu`` for CUDA tensors: one launch for
every image and class of a ``batch_multiclass_nms`` call, a block per
(image, class) walking that class's ranks in shared memory. For CPU
tensors it runs ``plain_nms_mask``, ``ops/nms._per_image_nms`` over the
images, which is also the kernel's oracle on the card. On a CUDA tensor
it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from cap2det_tpu_torch.kernels import build

# The kernel's shared memory (csrc/nms.cu): 16 bytes of box and a keep
# byte a rank, within the 227 KB a block may opt in to less a reserve for
# its static shared memory. A larger P is refused on every device.
SMEM_LIMIT = 227 * 1024
SMEM_RESERVE = 1024
BYTES_PER_RANK = 17
MAX_PROPOSALS = (SMEM_LIMIT - SMEM_RESERVE) // BYTES_PER_RANK
# Operations of one IoU and its comparison, as pairwise_iou spells it:
# two sides of the intersection (min, max, subtract, clamp each), its
# product, two areas (two subtracts, two clamps, a product each), the
# union's add and subtract, its test, clamp and the division, and the
# comparison with the threshold.
IOU_FLOPS = 25

# Kernel launches: one per nms_mask call on the card.
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def rank_order(scores):
    """[B, C, P] int64, contiguous: each class's stable descending score
    order, the order ``_per_image_nms`` walks (JAX's ``argsort`` also runs
    outside its loop). The sort keeps its input's transposed strides, so
    the result is made contiguous for the kernel."""
    return torch.argsort(-scores.transpose(1, 2), dim=-1,
                         stable=True).contiguous()


def _check(boxes, scores):
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms: boxes and scores must be float32, got %s and "
                        "%s" % (boxes.dtype, scores.dtype))
    if (boxes.dim() != 3 or scores.dim() != 3 or boxes.shape[-1] != 4
            or boxes.shape[:2] != scores.shape[:2]):
        raise ValueError("nms: boxes [B, P, 4] and scores [B, P, C] "
                         "expected, got %s and %s"
                         % (tuple(boxes.shape), tuple(scores.shape)))
    if boxes.device != scores.device:
        raise ValueError("nms: boxes on %s, scores on %s"
                         % (boxes.device, scores.device))
    if scores.shape[1] > MAX_PROPOSALS:
        raise ValueError(
            "nms: P=%d proposals exceed the kernel's limit of %d (%d bytes "
            "of shared memory a rank within %d)" % (
                scores.shape[1], MAX_PROPOSALS, BYTES_PER_RANK,
                SMEM_LIMIT - SMEM_RESERVE))


def _launch(boxes, scores, order, score_thresh, iou_thresh, max_per_class):
    """The kernel on contiguous CUDA tensors; returns the [B, P, C] mask."""
    global launches
    num_b, num_p, num_c = scores.shape
    if not (boxes.is_contiguous() and scores.is_contiguous()
            and order.is_contiguous()) or order.dtype != torch.int64:
        raise ValueError("nms: the kernel takes contiguous boxes, scores "
                         "and int64 order")
    keep = torch.empty((num_b, num_p, num_c), dtype=torch.bool,
                       device=scores.device)
    if keep.numel() == 0:
        return keep
    # A cap at or above P never binds; clamping keeps it a C int.
    cap = max(min(int(max_per_class), num_p), 0)
    fn = build.function("cap2det_nms", _ARGTYPES)
    with torch.cuda.device(scores.device):
        rc = fn(boxes.data_ptr(), scores.data_ptr(), order.data_ptr(),
                keep.data_ptr(), num_b, num_p, num_c,
                ctypes.c_float(score_thresh), ctypes.c_float(iou_thresh),
                cap, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "nms")
    launches += 1
    return keep


def plain_nms_mask(boxes, scores, score_thresh, iou_thresh, max_per_class):
    """The kernel's plain version: ``_per_image_nms`` on each image."""
    # ops/nms imports this module, so its plain pass is looked up here.
    from cap2det_tpu_torch.ops import nms as nms_ops

    return torch.stack([
        nms_ops._per_image_nms(b, s, iou_thresh, score_thresh, max_per_class)
        for b, s in zip(boxes, scores)])


def nms_mask(boxes, scores, score_thresh, iou_thresh, max_per_class):
    """[B, P, C] bool mask of the (box, class) pairs that survive greedy
    per-class NMS and the per-class cap, from boxes [B, P, 4] and scores
    [B, P, C] float32: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check(boxes, scores)
    if not scores.is_cuda:
        return plain_nms_mask(boxes, scores, score_thresh, iou_thresh,
                              max_per_class)
    boxes, scores = boxes.contiguous(), scores.contiguous()
    return _launch(boxes, scores, rank_order(scores), score_thresh,
                   iou_thresh, max_per_class)


def walk_stats(scores, keep, score_thresh, max_per_class):
    """What the kernel's walk did for each (image, class), from its inputs
    and its mask: the ranks it walked (to the first non-candidate, or to
    the survivor numbered max_per_class), its barrier steps (one per
    survivor before that one; the block adds two of its own) and the IoUs
    those survivors need against the later ranks the walk visits.
    Returns {"ranks": [B, C], "barriers": [B, C], "iou_pairs": int}."""
    order = rank_order(scores)
    candidates = (torch.gather(scores.transpose(1, 2), 2, order)
                  > score_thresh).sum(-1)
    kept = torch.gather(keep.transpose(1, 2), 2, order)  # in rank order
    count = torch.cumsum(kept, dim=-1)
    cap = max(int(max_per_class), 0)
    at_cap = kept & (count == cap)
    rank = torch.arange(scores.shape[1], device=scores.device)
    capped = at_cap.any(-1)
    ranks = torch.where(capped, (at_cap * rank).sum(-1) + 1, candidates)
    if cap == 0:
        ranks = torch.zeros_like(ranks)
    walkers = kept & (count < cap)
    iou_pairs = ((ranks[..., None] - 1 - rank) * walkers).sum()
    return {"ranks": ranks, "barriers": walkers.sum(-1),
            "iou_pairs": int(iou_pairs)}


def nms_bytes(num_b, num_p, num_c):
    """Bytes the kernel must move: boxes (16 a proposal), scores (4 a
    pair) and the order (8 a pair) read once, the mask (1 a pair) written
    once."""
    return num_b * num_p * (16 + 13 * num_c)


def nms_flops(num_b, num_p, num_c, iou_pairs):
    """Operations of the function on these inputs: one comparison per
    score with the threshold, and IOU_FLOPS per IoU the walk needs
    (``walk_stats``)."""
    return num_b * num_p * num_c + IOU_FLOPS * iou_pairs
