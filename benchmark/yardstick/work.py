"""Operations and bytes of the function each hand-written kernel
computes, from its arguments' shapes: frozen copies of the program's
formulas (``kernels/roi_pool.py`` ``forward_flops`` / ``backward_flops``,
``kernels/pool_grad.py`` ``*_flops``, ``kernels/fused_optimizer.py``
``update_flops`` / ``update_bytes``, ``kernels/nms.py`` ``nms_bytes`` /
``nms_flops`` / ``walk_stats``) and of ``chip_smoke.py``'s byte counts.
Each input byte is counted read once and each output byte written once.

``WORK[wrapper]`` maps a kernel wrapper's call to (bytes, operations);
the wrapper's bound arguments and its return value are passed in."""

from __future__ import annotations

import torch


def same_pads(size, kernel, stride):
    out = -(-size // stride)
    pad_total = max((out - 1) * stride + kernel - size, 0)
    return out, pad_total // 2, pad_total - pad_total // 2


def in_bounds_taps(h, w, kernel, stride):
    taps = 1
    for size in (h, w):
        out, pad_lo, _ = same_pads(size, kernel, stride)
        taps *= sum(min(o * stride - pad_lo + kernel, size)
                    - max(o * stride - pad_lo, 0) for o in range(out))
    return taps


def pooled_side(crop_size, pool_kernel, pool_stride):
    return (crop_size - pool_kernel) // pool_stride + 1


def roi_forward_flops(batch, num_p, channels, crop_size, pool_kernel=2,
                      pool_stride=2):
    """B * P * C * (9 * S^2 + (k^2 - 1) * S'^2): three lerps of three
    operations per crop sample, k^2 - 1 compares per pooled cell."""
    pooled = pooled_side(crop_size, pool_kernel, pool_stride)
    return (batch * num_p * channels
            * (9 * crop_size ** 2 + (pool_kernel ** 2 - 1) * pooled ** 2))


def roi_backward_flops(batch, num_p, channels, crop_size, pool_kernel=2,
                       pool_stride=2):
    """The forward's again, plus 10 per pooled cell (2 products by the y
    weights, 4 by the x weights, 4 adds into dF)."""
    pooled = pooled_side(crop_size, pool_kernel, pool_stride)
    return (roi_forward_flops(batch, num_p, channels, crop_size, pool_kernel,
                              pool_stride)
            + batch * num_p * channels * 10 * pooled ** 2)


def pool_fwd_flops(shape, kind, kernel, stride):
    """N * C * (in-bounds taps + a divide per output for the average)."""
    n, h, w, c = shape
    out_h, out_w = same_pads(h, kernel, stride)[0], same_pads(w, kernel,
                                                              stride)[0]
    divides = out_h * out_w if kind == "pool_avg" else 0
    return n * c * (in_bounds_taps(h, w, kernel, stride) + divides)


def pool_grad_flops(shape, kernel, stride):
    """N * C * (in-bounds taps + outputs): max-pool and avg-pool alike."""
    n, h, w, c = shape
    out_h, out_w = same_pads(h, kernel, stride)[0], same_pads(w, kernel,
                                                              stride)[0]
    return n * c * (in_bounds_taps(h, w, kernel, stride) + out_h * out_w)


RULE_FLOPS = {"sgd": 2, "adagrad": 7, "adam": 14, "rmsprop": 9,
              "momentum": 4}
RULE_SLOTS = {"sgd": 0, "adagrad": 1, "adam": 2, "rmsprop": 1,
              "momentum": 1}


def update_flops(which, total, scaled_numel, clip, centered=False,
                 momentum=0.0, nesterov=False):
    per = RULE_FLOPS[which]
    if which == "rmsprop":
        per += 5 * bool(centered) + 2 * (momentum > 0)
    elif which == "momentum":
        per += 2 * bool(nesterov)
    return per * total + scaled_numel + 3 * clip * total


def update_bytes(n_slots, numel, grad_bytes=4):
    """The gradient read once; the float32 param and each slot read and
    written once."""
    return (grad_bytes + 8 + 8 * n_slots) * numel


IOU_FLOPS = 25


def nms_bytes(num_b, num_p, num_c):
    """Boxes (16 a proposal), scores (4 a pair), the order (8 a pair) read
    once, the mask (1 a pair) written once."""
    return num_b * num_p * (16 + 13 * num_c)


def walk_iou_pairs(scores, keep, score_thresh, max_per_class):
    """The IoUs greedy NMS needs on these scores, given its result mask
    [B, P, C]: each survivor against the later ranks its class walks."""
    num_p = scores.shape[1]
    order = torch.argsort(-scores.transpose(1, 2), dim=-1, stable=True)
    candidates = (torch.gather(scores.transpose(1, 2), 2, order)
                  > score_thresh).sum(-1)
    kept = torch.gather(keep.transpose(1, 2), 2, order)
    count = torch.cumsum(kept, dim=-1)
    cap = max(int(max_per_class), 0)
    at_cap = kept & (count == cap)
    rank = torch.arange(num_p, device=scores.device)
    capped = at_cap.any(-1)
    stop = torch.where(capped, (at_cap * rank).sum(-1), candidates)
    ranks = torch.where(capped, stop + 1, candidates)
    if cap == 0:
        return 0
    walkers = kept & (count < cap)
    return int(((ranks[..., None] - 1 - rank) * walkers).sum())


def _size(t):
    return t.numel() * t.element_size()


def _roi_fwd(a, out):
    f, boxes = a["features"], a["boxes"]
    nbytes = _size(f) + boxes.numel() * 4 + _size(out)
    return nbytes, roi_forward_flops(boxes.shape[0], boxes.shape[1],
                                     f.shape[-1], a["crop_size"],
                                     a["pool_kernel"], a["pool_stride"])


def _roi_bwd(a, out):
    f, boxes = a["features"], a["boxes"]
    nbytes = 2 * _size(f) + boxes.numel() * 4 + _size(a["grad"])
    return nbytes, roi_backward_flops(boxes.shape[0], boxes.shape[1],
                                      f.shape[-1], a["crop_size"],
                                      a["pool_kernel"], a["pool_stride"])


def _pool_fwd(a, out):
    x = a["x"]
    return (_size(x) + _size(out),
            pool_fwd_flops(tuple(x.shape), a["kind"], a["kernel"],
                           a["stride"]))


def _maxpool_grad(a, out):
    x, g = a["x"], a["g"]
    return (2 * _size(x) + _size(g),
            pool_grad_flops(tuple(x.shape), a["kernel"], a["stride"]))


def _avgpool_grad(a, out):
    g = a["g"]
    numel = 1
    for s in a["x_shape"]:
        numel *= s
    return (numel * g.element_size() + _size(g),
            pool_grad_flops(tuple(a["x_shape"]), a["kernel"], a["stride"]))


def _fused_update(a, out):
    rule, leaf_set = a["rule"], a["leaf_set"]
    which, conf = rule.which, rule.config
    scaled = sum(n for n, m in zip(leaf_set.numels, leaf_set.multipliers)
                 if m != 1.0)
    flops = update_flops(which, leaf_set.total, scaled,
                         a["clip_norm"] is not None,
                         getattr(conf, "centered", False),
                         getattr(conf, "momentum", 0.0),
                         getattr(conf, "use_nesterov", False))
    return update_bytes(RULE_SLOTS[which], leaf_set.total), flops


def _nms(a, keep):
    scores = a["scores"]
    num_b, num_p, num_c = scores.shape
    pairs = walk_iou_pairs(scores, keep, a["score_thresh"],
                           a["max_per_class"])
    return (nms_bytes(num_b, num_p, num_c),
            num_b * num_p * num_c + IOU_FLOPS * pairs)


# wrapper -> (module path, attribute, fn(bound arguments, result) ->
# (bytes, operations), whether fn runs on the device and so waits until
# the trace has ended). The wrappers are the program's entry points to
# its hand-written kernels.
WORK = {
    "roi_crop_maxpool": ("cap2det_tpu_torch.kernels.roi_pool",
                         "roi_crop_maxpool", _roi_fwd, False),
    "pool_fwd": ("cap2det_tpu_torch.kernels.pool_grad", "pool_fwd",
                 _pool_fwd, False),
    "roi_crop_maxpool_grad": ("cap2det_tpu_torch.kernels.roi_pool",
                              "roi_crop_maxpool_grad", _roi_bwd, False),
    "maxpool_grad": ("cap2det_tpu_torch.kernels.pool_grad", "maxpool_grad",
                     _maxpool_grad, False),
    "avgpool_grad": ("cap2det_tpu_torch.kernels.pool_grad", "avgpool_grad",
                     _avgpool_grad, False),
    "fused_optimizer": ("cap2det_tpu_torch.kernels.fused_optimizer",
                        "fused_update", _fused_update, False),
    "nms": ("cap2det_tpu_torch.kernels.nms", "nms_mask", _nms, True),
}
