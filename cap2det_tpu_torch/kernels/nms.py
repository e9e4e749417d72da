"""Greedy class-wise non-max suppression (the port's counterpart of the
``lax.fori_loop`` in ``cap2det_tpu/ops/nms.py`` ``_per_image_nms``, which
XLA compiles into the TPU's postprocess program; no Pallas kernel).

``nms_mask`` launches ``csrc/nms.cu`` for CUDA tensors: for every image
and class of a ``batch_multiclass_nms`` call, two kernels. The first
builds the call's class-agnostic overlap bitmask ``[B, P, row_words(P)]``
(scratch) over the whole card; the second walks each class's ranks, one
warp per (image, class), 32 ranks at a time, ORing each group's
survivors' mask rows into the class's removed bits. For CPU tensors it runs ``plain_nms_mask``,
``ops/nms._per_image_nms`` over the images, which is also the kernels'
oracle on the card. On a CUDA tensor it launches the kernels or raises;
it never falls back. ``plain_overlap_bits`` and ``plain_walk`` are the two
stages' plain versions, for the tests and ``chip_smoke.py`` only.
"""

from __future__ import annotations

import ctypes

import torch

from cap2det_tpu_torch.kernels import build
from cap2det_tpu_torch.ops import boxes as box_ops
from cap2det_tpu_torch.utils.spans import span

# The walk's shared memory (csrc/nms.cu), a block per class: a mask row of
# removed bits and a ring of at least MIN_STAGES groups of 32 staged mask
# rows, each at a stride of at most 4 words more than a row, within the
# 227 KB a block may opt in to less a reserve. A row holds at most
# MAX_ROW_WORDS words (a multiple of 4), which bounds P. A larger P is
# refused on every device.
SMEM_LIMIT = 227 * 1024
SMEM_RESERVE = 1024
MIN_STAGES = 3
MAX_ROW_WORDS = ((SMEM_LIMIT - SMEM_RESERVE) // 4 - MIN_STAGES * 32 * 4) // (
    1 + MIN_STAGES * 32) // 4 * 4
MAX_PROPOSALS = 32 * MAX_ROW_WORDS
# The mask kernel takes the image from its grid's third dimension.
MAX_IMAGES = 65535
# Operations of one IoU and its comparison, as pairwise_iou spells it:
# two sides of the intersection (min, max, subtract, clamp each), its
# product, two areas (two subtracts, two clamps, a product each), the
# union's add and subtract, its test, clamp and the division, and the
# comparison with the threshold.
IOU_FLOPS = 25

# Kernel launches: one per nms_mask call on the card (both kernels of the
# call, launched by one C call).
launches = 0

# cap2det_nms, and the two stages alone (cap2det_nms_bits,
# cap2det_nms_walk), which only the checks and timings call.
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
_BITS_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                  + [ctypes.c_float, ctypes.c_void_p])
_WALK_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def words(num_p):
    """uint32 words of a mask row that hold its bits: one per proposal."""
    return (num_p + 31) // 32


def row_words(num_p):
    """uint32 words of a mask row as laid out: ``words`` and then zero
    words to a multiple of 4, the 16 bytes of the walk's copies."""
    return (words(num_p) + 3) // 4 * 4


def scratch_bytes(num_b, num_p):
    """Bytes of the overlap mask a call allocates."""
    return num_b * num_p * row_words(num_p) * 4


def pair_tests(num_b, num_p):
    """IoUs the mask kernel computes: every pair of an image's proposals,
    the work the design chose (the function needs ``walk_stats``'
    ``iou_pairs``)."""
    return num_b * num_p * num_p


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
            "nms: P=%d proposals exceed the kernel's limit of %d (a "
            "class's removed bits and %d groups of 32 staged mask rows, at "
            "most %d words a row, within %d bytes of shared memory)" % (
                scores.shape[1], MAX_PROPOSALS, MIN_STAGES, MAX_ROW_WORDS,
                SMEM_LIMIT - SMEM_RESERVE))
    if scores.shape[0] > MAX_IMAGES:
        raise ValueError("nms: B=%d images exceed the kernel's limit of %d"
                         % (scores.shape[0], MAX_IMAGES))


def _empty_bits(boxes):
    num_b, num_p, _ = boxes.shape
    return torch.empty((num_b, num_p, row_words(num_p)), dtype=torch.int32,
                       device=boxes.device)


def _launch(boxes, scores, order, score_thresh, iou_thresh, max_per_class):
    """Both kernels on contiguous CUDA tensors; returns the [B, P, C]
    mask."""
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
    bits = _empty_bits(boxes)
    # A cap at or above P never binds; clamping keeps it a C int.
    cap = max(min(int(max_per_class), num_p), 0)
    fn = build.function("cap2det_nms", _ARGTYPES)
    with torch.cuda.device(scores.device):
        rc = fn(boxes.data_ptr(), scores.data_ptr(), order.data_ptr(),
                bits.data_ptr(), keep.data_ptr(), num_b, num_p, num_c,
                ctypes.c_float(score_thresh), ctypes.c_float(iou_thresh),
                cap, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "nms")
    launches += 1
    return keep


def _launch_bits(boxes, iou_thresh):
    """The mask kernel alone on contiguous CUDA boxes [B, P, 4] (P >= 1):
    the [B, P, row_words(P)] int32 overlap bits. For checks and timings;
    it counts no launch."""
    if not boxes.is_contiguous():
        raise ValueError("nms: the mask kernel takes contiguous boxes")
    bits = _empty_bits(boxes)
    fn = build.function("cap2det_nms_bits", _BITS_ARGTYPES)
    with torch.cuda.device(boxes.device):
        rc = fn(boxes.data_ptr(), bits.data_ptr(), boxes.shape[0],
                boxes.shape[1], ctypes.c_float(iou_thresh),
                torch.cuda.current_stream().cuda_stream)
    build.check(rc, "nms bits")
    return bits


def _launch_walk(bits, scores, order, score_thresh, max_per_class):
    """The walk kernel alone on contiguous CUDA tensors, from the mask
    ``bits`` [B, P, row_words(P)] int32 (16-byte aligned): the [B, P, C]
    mask. For checks and timings; it counts no launch."""
    num_b, num_p, num_c = scores.shape
    if tuple(bits.shape) != (num_b, num_p, row_words(num_p)) or (
            not build.aligned(bits)):
        raise ValueError("nms: bits %s at %d for scores %s" % (
            tuple(bits.shape), bits.data_ptr(), tuple(scores.shape)))
    if not (scores.is_contiguous() and bits.is_contiguous()
            and order.is_contiguous()) or (
                order.dtype != torch.int64 or bits.dtype != torch.int32):
        raise ValueError("nms: the walk kernel takes contiguous scores, "
                         "int64 order and int32 bits")
    keep = torch.empty((num_b, num_p, num_c), dtype=torch.bool,
                       device=scores.device)
    cap = max(min(int(max_per_class), num_p), 0)
    fn = build.function("cap2det_nms_walk", _WALK_ARGTYPES)
    with torch.cuda.device(scores.device):
        rc = fn(scores.data_ptr(), order.data_ptr(), bits.data_ptr(),
                keep.data_ptr(), num_b, num_p, num_c,
                ctypes.c_float(score_thresh), cap,
                torch.cuda.current_stream().cuda_stream)
    build.check(rc, "nms walk")
    return keep


def plain_nms_mask(boxes, scores, score_thresh, iou_thresh, max_per_class):
    """The kernels' plain version: ``_per_image_nms`` on each image."""
    # ops/nms imports this module, so its plain pass is looked up here.
    from cap2det_tpu_torch.ops import nms as nms_ops

    return torch.stack([
        nms_ops._per_image_nms(b, s, iou_thresh, score_thresh, max_per_class)
        for b, s in zip(boxes, scores)])


def plain_overlap_bits(boxes, iou_thresh):
    """The mask kernel's plain version: [B, P, row_words(P)] int32, bit
    j % 32 of word j // 32 of row i set when pairwise_iou(box i, box j) >
    iou_thresh; the bits past P are 0."""
    num_b, num_p, _ = boxes.shape
    over = box_ops.pairwise_iou(boxes, boxes) > iou_thresh  # [B, P, P]
    pad = row_words(num_p) * 32 - num_p
    over = torch.cat([over, over.new_zeros(num_b, num_p, pad)], -1)
    shifts = torch.arange(32, device=boxes.device)
    packed = (over.reshape(num_b, num_p, -1, 32).long() << shifts).sum(-1)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).int()


def plain_walk(bits, order, scores, score_thresh, max_per_class):
    """The walk kernel's plain version: every (image, class) walks its
    ranks in ``order`` [B, C, P] to the first non-candidate or the
    survivor numbered max_per_class, keeping a rank whose box's removed
    bit is clear and ORing that box's row of ``bits`` (the mask kernel's
    [B, P, row_words(P)] int32) into the class's removed bits. Returns the
    [B, P, C] mask."""
    num_b, num_p, num_c = scores.shape
    cap = max(min(int(max_per_class), num_p), 0)
    candidate = torch.gather(scores.transpose(1, 2), 2,
                             order) > score_thresh  # [B, C, P], rank order
    keep = torch.zeros((num_b, num_c, num_p), dtype=torch.bool,
                       device=scores.device)
    removed = torch.zeros((num_b, num_c, bits.shape[-1]), dtype=torch.int32,
                          device=scores.device)
    kept = torch.zeros((num_b, num_c), dtype=torch.int64,
                       device=scores.device)
    walking = torch.full((num_b, num_c), cap > 0, device=scores.device)
    image = torch.arange(num_b, device=scores.device)[:, None]
    for r in range(num_p):
        walking &= candidate[:, :, r]
        if not walking.any():
            break
        box = order[:, :, r]  # [B, C]
        word = torch.gather(removed, 2, (box >> 5)[..., None])[..., 0]
        survivor = walking & ((word >> (box & 31)) & 1).eq(0)
        keep.scatter_(2, box[..., None], survivor[..., None])
        removed |= torch.where(survivor[..., None], bits[image, box], 0)
        kept += survivor
        walking &= kept < cap
    return keep.transpose(1, 2).contiguous()


def nms_mask(boxes, scores, score_thresh, iou_thresh, max_per_class):
    """[B, P, C] bool mask of the (box, class) pairs that survive greedy
    per-class NMS and the per-class cap, from boxes [B, P, 4] and scores
    [B, P, C] float32: the kernels for CUDA tensors, the plain version for
    CPU tensors."""
    _check(boxes, scores)
    with span("cap2det/kernel/nms"):
        if not scores.is_cuda:
            return plain_nms_mask(boxes, scores, score_thresh, iou_thresh,
                                  max_per_class)
        boxes, scores = boxes.contiguous(), scores.contiguous()
        return _launch(boxes, scores, rank_order(scores), score_thresh,
                       iou_thresh, max_per_class)


def walk_stats(scores, keep, score_thresh, max_per_class):
    """What the walk kernel did for each (image, class), from its inputs
    and its mask: the ranks it walked (to the first non-candidate, or to
    the survivor numbered max_per_class), the survivors it found, the
    groups of 32 ranks it walked (the walker's steps, each on its staged
    mask rows), and the IoUs those survivors need against the later
    ranks the walk visits (the function's work, not the mask kernel's).
    Returns {"ranks": [B, C], "survivors": [B, C], "groups":
    [B, C], "iou_pairs": int}."""
    num_p = scores.shape[1]
    order = rank_order(scores)
    candidates = (torch.gather(scores.transpose(1, 2), 2, order)
                  > score_thresh).sum(-1)
    kept = torch.gather(keep.transpose(1, 2), 2, order)  # in rank order
    count = torch.cumsum(kept, dim=-1)
    cap = max(int(max_per_class), 0)
    at_cap = kept & (count == cap)
    rank = torch.arange(num_p, device=scores.device)
    capped = at_cap.any(-1)
    # The rank the walk stops at: the survivor at the cap, else the first
    # non-candidate (P when every rank is one).
    stop = torch.where(capped, (at_cap * rank).sum(-1), candidates)
    ranks = torch.where(capped, stop + 1, candidates)
    groups = torch.clamp(stop // 32 + 1, max=words(num_p))
    if cap == 0:
        ranks, groups = torch.zeros_like(ranks), torch.zeros_like(groups)
    walkers = kept & (count < cap)
    iou_pairs = ((ranks[..., None] - 1 - rank) * walkers).sum()
    return {"ranks": ranks, "survivors": kept.sum(-1), "groups": groups,
            "iou_pairs": int(iou_pairs)}


def nms_bytes(num_b, num_p, num_c):
    """Bytes the function must move: boxes (16 a proposal), scores (4 a
    pair) and the order (8 a pair) read once, the mask (1 a pair) written
    once. The overlap mask is scratch the design chose
    (``scratch_bytes``)."""
    return num_b * num_p * (16 + 13 * num_c)


def nms_flops(num_b, num_p, num_c, iou_pairs):
    """Operations of the function on these inputs: one comparison per
    score with the threshold, and IOU_FLOPS per IoU the walk needs
    (``walk_stats``)."""
    return num_b * num_p * num_c + IOU_FLOPS * iou_pairs
