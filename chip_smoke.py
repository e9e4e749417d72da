#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (cap2det_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):
  1. build the hand-written CUDA kernels from cap2det_tpu_torch/csrc;
  2. hold the ROI crop+pool kernel (K1) against its exact oracle (bit for
     bit) and its plain PyTorch version (within TOL) at the largest serving
     shape, in bfloat16 and float32 (a reversed box included), and in
     bfloat16 at every shape the main path launches it at (the four
     serving scales and the coco17 training map) with the mixed, all-wide
     and all-narrow box sets, each timed beside its bound and gathered
     footprint bytes;
  3. hold the SAME pool kernel (K4) against its plain version at the
     three second-stage shapes, in bfloat16 and float32;
  4. serve 3 seeded images (landscape, portrait, square; 2000 proposals
     each) through MultiScalePredictor.predict at the full width of the
     configs/voc07_inc2.pbtxt model (4 scales, 20 classes, 3 OICR
     iterations) with seeded random weights, check the launch counters
     and the detections, hold the card's canvases to the CPU's bit for
     bit, time 12 images (median and spread) and one image by layer, and
     hold one scale's
     float32 scores on the card against the same scale run on the CPU;
  5. hold the ROI backward kernel (K2) against its fixed-point oracle (bit
     for bit) and its float32 plain version (within GRAD_TOL) at the coco17
     training shape (features [2, 64, 96, 576], P=500), in bfloat16 and
     float32, also on tie-rich quantised features, require two launches on
     the same inputs to give the same bits, and count its global atomics
     with the fixed-point oracle (roi_pool.grad_atomic_counts);
  6. hold the max-pool (K5) and avg-pool (K6) backward kernels against
     their plain versions at the three second-stage training shapes of
     coco17 (N=1000) and voc07 (N=2000), in bfloat16 and float32, K5 also
     on tie-rich input, both bit for bit (the same divisions and float32
     sums in the same order, rounded once); each timed beside its bound
     and PyTorch's pool backward, launched by the host (kernel_ms) and
     replayed from a CUDA graph (device_ms), and all through the tiled
     kernels;
  7. train at configs/coco17_extend_match.pbtxt width (batch 2, 1024x1536
     canvases, P=500, 80 classes, Mixed_4e unfrozen, Adagrad): 3 warm-up
     and 12 timed steps, launch counts per step, finite losses, frozen
     leaves unchanged, a one-step breakdown by span, peak memory;
  8. train under the full first-stage freeze of configs/voc07_inc2.pbtxt
     (batch 1, P=2000, 20 classes): no ROI backward launches;
  9. one float32 training step at 256x384, P=64 on the card and on the
     CPU from the same params and batch: loss, head gradients and updated
     head params agree; dropout's x / 0.7 and the mean over 3 eval scales
     equal the CPU's quotients bit for bit;
 10. train_loop: train() from PNG TFRecords written here, at
     configs/coco17_extend_match.pbtxt as shipped, through all eight
     canvas buckets (1216x1824 ... 416x608, both orientations), launches
     per step K1 1, K4 3, K2 1, K5 2, K6 1, per-bucket step and feed-wait
     medians, peak memory; a second train() restores the final checkpoint
     bit for bit and trains on. Also says whether Pillow imports;
 11. eval_daemon: continuous_evaluation(evaluate_all=True) at
     configs/voc07_inc2.pbtxt width (4 scales, P=2000, 20 classes, 3 OICR
     iterations, bf16) over 8 PNG records and two checkpoints of seeded
     TrainStates: one eval_metrics.jsonl row per checkpoint, oldest first,
     the CSV and HTML reports, promotion of the better final-iteration
     mAP, launches K1 64 and K4 192 (K1 staged) and no backward kernel,
     the second checkpoint's detections not the first's; seconds per
     checkpoint and per image, the NMS share, peak memory; one image's
     postprocess on the CPU equals the card's bit for bit; then
     export_main and evaluate_main --run_once in a subprocess;
 12. overfit_map: tests/test_e2e_map.py's run on the card
     (cap2det_tpu_torch/tools/overfit_map.py): passthrough warm start, 300
     train() steps, the daemon's final mAP >= 0.5 at step 300.

Phases 2 and 5 also hold K1 and K2 at the largest coco17 training bucket
(features [2, 76, 114, 576], P=500).

``python3 chip_smoke.py --profile`` also reads one image's device kernel
time and busy share with torch.profiler, and the training step's busy
share from a trace of train_loop's steps.

The last lines are a {"kernels": [...]} JSON line, the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": ...}.
Exits nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# Per pooled K1 output: 2x2 samples, each two y-lerps and one x-lerp of
# 3 float32 operations, then 3 maxima.
ROI_OPS_PER_OUTPUT = 4 * 3 * 3 + 3
FEATURE_SHAPE = (1, 76, 114, 576)  # Mixed_4e map of the 1216x1824 canvas
NUM_PROPOSALS = 2000
# Every shape the main path launches K1 at: the Mixed_4e maps of the four
# serving canvases (1216x1824, 800x1216, 608x928, 416x608) at P=2000, and
# the coco17 training map at P=500 per image.
K1_SHAPES = [("serve 1216x1824", (1, 76, 114, 576), 2000),
             ("serve 800x1216", (1, 50, 76, 576), 2000),
             ("serve 608x928", (1, 38, 58, 576), 2000),
             ("serve 416x608", (1, 26, 38, 576), 2000),
             ("train coco17", (2, 64, 96, 576), 500),
             ("train coco17 1216x1824", (2, 76, 114, 576), 500)]
BOX_SETS = {"mix": None, "wide": 0, "narrow": 1}  # make_boxes' kinds
POOL_SHAPES = [  # (name, kind, kernel, stride, [N, H, W, C])
    ("Mixed_5a max 3/s2", "pool_max", 3, 2, (2000, 7, 7, 576)),
    ("Mixed_5b avg 3/s1", "pool_avg", 3, 1, (2000, 4, 4, 1024)),
    ("Mixed_5c max 3/s1", "pool_max", 3, 1, (2000, 4, 4, 1024)),
]
# Tolerances. float32: both sides compute float32 lerps/sums in another
# order. bfloat16: both round the same float32 values to bfloat16, so
# they differ by at most one bfloat16 step (PyTorch's bf16 defaults).
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 1e-5)}  # (rtol, atol)
# Card float32 vs CPU float32 scores of one scale: cuDNN and the CPU
# convolutions sum in different orders through ~20 layers.
SCORE_TOL = (1e-3, 1e-5)
TIMED_ROUNDS = 4  # passes over the 3 images: 12 samples per image time
# Training shapes (configs/coco17_extend_match.pbtxt, the 1024x1536 canvas).
TRAIN_FEATURE_SHAPE = (2, 64, 96, 576)
# The Mixed_4e map of the largest coco17 training bucket (1216x1824).
TRAIN_LARGEST_FEATURE_SHAPE = (2, 76, 114, 576)
TRAIN_P = 500
TRAIN_POOL_SHAPES = [  # (name, kind, kernel, stride, [N, H, W, C])
    ("Mixed_5a max 3/s2", "pool_max", 3, 2, (1000, 7, 7, 576)),
    ("Mixed_5b avg 3/s1", "pool_avg", 3, 1, (1000, 4, 4, 1024)),
    ("Mixed_5c max 3/s1", "pool_max", 3, 1, (1000, 4, 4, 1024)),
]
# The same pools at voc07_inc2's B*P = 2000 (batch 1, P=2000).
VOC_POOL_SHAPES = [(name + " N=2000", kind, k, s, (2000,) + shape[1:])
                   for name, kind, k, s, shape in TRAIN_POOL_SHAPES]
# Per pooled K2 cell: 4 samples of 3 lerps (9 float32 operations), 4
# compares, then 2 + 4 products and 4 adds into dF.
ROI_GRAD_OPS_PER_CELL = 4 * 9 + 4 + 6 + 4
# K2 against its plain version: the same terms of size ~1 added into each
# dF value, in 64-bit fixed point on the card and in float32 with
# index_add_ there.
GRAD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1.6e-2, 1e-4)}
KERNELS = ("roi_crop_maxpool", "pool_fwd", "roi_crop_maxpool_grad",
           "maxpool_grad", "avgpool_grad")
# train() steps of the train_loop phase: enough for its seeded stream to
# reach all eight coco17 canvas buckets.
TRAIN_LOOP_STEPS = 40


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=50, replays=4):
    """Mean milliseconds of fn() on the card with no host time between
    launches: `iters` calls captured once in a CUDA graph, whose replays
    are timed by CUDA events. Where the host takes longer to launch a
    kernel than the card to run it, cuda_ms reads the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(torch, got, want, dtype_name, tol=TOL):
    rtol, atol = tol[dtype_name]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return float((got.float() - want.float()).abs().max())


def launch_counts():
    from cap2det_tpu_torch.kernels import pool_grad, roi_pool

    return {"roi_crop_maxpool": roi_pool.launches,
            "pool_fwd": pool_grad.launches,
            "roi_crop_maxpool_grad": roi_pool.grad_launches,
            "maxpool_grad": pool_grad.maxpool_grad_launches,
            "avgpool_grad": pool_grad.avgpool_grad_launches}


POOL_GRAD_PATHS = ("maxpool_grad_tiled_launches",
                   "maxpool_grad_untiled_launches",
                   "avgpool_grad_tiled_launches",
                   "avgpool_grad_untiled_launches")


def reset_launch_counts():
    from cap2det_tpu_torch.kernels import pool_grad, roi_pool

    roi_pool.launches = roi_pool.grad_launches = 0
    roi_pool.staged_launches = roi_pool.generic_launches = 0
    roi_pool.grad_staged_launches = roi_pool.grad_generic_launches = 0
    pool_grad.launches = pool_grad.maxpool_grad_launches = 0
    pool_grad.avgpool_grad_launches = 0
    for name in POOL_GRAD_PATHS:
        setattr(pool_grad, name, 0)


def pool_grad_paths():
    """K5's and K6's launches by kernel (tiled, untiled)."""
    from cap2det_tpu_torch.kernels import pool_grad

    return {name: getattr(pool_grad, name) for name in POOL_GRAD_PATHS}


def check_pool_grad_tiled(where, before):
    """Raises if K5 or K6 took an untiled kernel since `before` (a
    pool_grad_paths() reading); returns the launches since, by kernel."""
    delta = {k: v - before[k] for k, v in pool_grad_paths().items()}
    if delta["maxpool_grad_untiled_launches"] or delta[
            "avgpool_grad_untiled_launches"]:
        raise AssertionError("%s: K5 or K6 took the untiled kernel at the "
                             "model's shapes: %s" % (where, delta))
    return delta


@contextlib.contextmanager
def cuda_spans(torch, targets):
    """Wraps each (owner, attribute, label) so that every call records a
    pair of CUDA events; yields {label: [(start, end), ...]}. Module
    attributes are restored, instance attributes deleted, on exit."""
    spans = {}
    patched = []
    for owner, name, label in targets:
        real = getattr(owner, name)

        def timed(*args, _real=real, _label=label, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _real(*args, **kwargs)
            end.record()
            spans.setdefault(_label, []).append((start, end))
            return out

        setattr(owner, name, timed)
        patched.append((owner, name, real))
    try:
        yield spans
    finally:
        for owner, name, real in patched:
            if isinstance(owner, types.ModuleType):
                setattr(owner, name, real)
            else:
                delattr(owner, name)


@contextlib.contextmanager
def pool_grad_layouts(pool_grad):
    """Wraps pool_grad.pool_same so that each pool's upstream gradient, as
    autograd hands it to the backward, is recorded: yields a list of
    {kind, kernel, stride, shape, contiguous, stride_of_g}."""
    seen = []
    real = pool_grad.pool_same

    def pool_same(x, kind, kernel, stride):
        y = real(x, kind, kernel, stride)
        if y.requires_grad:
            y.register_hook(lambda g: seen.append({
                "kind": kind, "kernel": kernel, "stride": stride,
                "shape": list(g.shape), "contiguous": g.is_contiguous(),
                "stride_of_g": list(g.stride())}))
        return y

    pool_grad.pool_same = pool_same
    try:
        yield seen
    finally:
        pool_grad.pool_same = real


def span_ms(spans):
    return {label: sum(a.elapsed_time(b) for a, b in pairs)
            for label, pairs in spans.items()}


def make_boxes(rng, num_p, num_pad, only=None):
    """Seeded proposals: wide, narrow, partly outside the map (or only the
    kind `only`: 0 wide, 1 narrow), and zero padding boxes at the end."""
    n = num_p - num_pad
    kind = rng.integers(0, 3, n)
    if only is not None:
        kind[:] = only
    cy, cx = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    size = np.where(kind == 0, rng.uniform(0.5, 1.0, n),
                    np.where(kind == 1, rng.uniform(0.02, 0.1, n),
                             rng.uniform(0.2, 0.6, n)))
    aspect = rng.uniform(0.5, 2.0, n)
    hh, hw = size * np.sqrt(aspect) / 2, size / np.sqrt(aspect) / 2
    boxes = np.stack([cy - hh, cx - hw, cy + hh, cx + hw], -1)
    inside = kind != 2
    boxes[inside] = np.clip(boxes[inside], 0.0, 1.0)
    return np.concatenate([boxes, np.zeros((num_pad, 4))]).astype(np.float32)


def phase_build():
    from cap2det_tpu_torch.kernels import build

    build.library()
    info = build.build_info
    log("build: %s in %.1f s (%s, key %s)" % (
        "compiled" if info["built"] else "cached", info["seconds"],
        ", ".join(info["sources"]), info["key"]))
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())


def footprint_positions(torch, boxes, height, width, crop):
    """Sum over proposals of |R| x |C|: the distinct rows and columns its
    crop samples read (each sample's idx and idx+1), the positions the
    staged kernels copy into shared memory."""
    from cap2det_tpu_torch.ops import roi as roi_ops

    y1, x1, y2, x2 = boxes.float().cpu().unbind(-1)

    def distinct(lo, hi, extent):
        idx, _, _ = roi_ops.sample_coords(lo, hi, crop, extent)
        v = torch.sort(torch.cat([idx, idx + 1], -1), -1).values
        return 1 + (v.diff(dim=-1) != 0).sum(-1)

    return int((distinct(y1, y2, height) * distinct(x1, x2, width)).sum())


def phase_roi(torch):
    from cap2det_tpu_torch.kernels import roi_pool
    from cap2det_tpu_torch.ops import roi as roi_ops

    rng = np.random.default_rng(SEED)
    feats32 = torch.from_numpy(
        rng.standard_normal(FEATURE_SHAPE, dtype=np.float32)).cuda()
    result = {}
    for num_p in (NUM_PROPOSALS, NUM_PROPOSALS - 1):
        boxes = torch.from_numpy(
            make_boxes(rng, num_p, num_pad=num_p // 20))[None].cuda()
        boxes[0, 1] = boxes[0, 1, [2, 3, 0, 1]]  # a reversed box
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            feats = feats32.to(dtype)
            got = roi_pool.roi_crop_maxpool(feats, boxes, 14, 2, 2)
            exact = roi_ops.crop_resize_maxpool_exact(feats, boxes, 14, 2, 2)
            want = roi_ops.crop_resize_maxpool(feats, boxes, 14, 2, 2)
            torch.cuda.synchronize()
            exact_err = float((got.float() - exact.float()).abs().max())
            if not torch.equal(got, exact):
                raise AssertionError(
                    "roi_crop_maxpool: not bit-equal to its exact oracle (P=%d"
                    ", %s, max |err| %r)" % (num_p, name, exact_err))
            err = compare(torch, got, want, name)
            line = {"kernel": "roi_crop_maxpool", "P": num_p, "dtype": name,
                    "max_abs_err_exact": exact_err, "max_abs_err": err,
                    "tol(rtol,atol)": TOL[name]}
            if num_p == NUM_PROPOSALS and dtype == torch.bfloat16:
                line["plain_ms"] = cuda_ms(
                    torch, lambda: roi_ops.crop_resize_maxpool(
                        feats, boxes, 14, 2, 2), iters=3, warmup=1)
                result = {"max_abs_err": err, "plain_ms": line["plain_ms"]}
            log(json.dumps(line))

    # Every shape the main path launches K1 at, with three box sets: exact
    # against the oracle, within TOL of the plain version, timed beside its
    # bound; the staged kernel must take each of them.
    first = (roi_pool.staged_launches, roi_pool.generic_launches)
    rng = np.random.default_rng(SEED + 3)
    for label, shape, num_p in K1_SHAPES:
        feats = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda().to(torch.bfloat16)
        for box_set, only in BOX_SETS.items():
            boxes = torch.from_numpy(np.stack([
                make_boxes(rng, num_p, num_pad=num_p // 20, only=only)
                for _ in range(shape[0])])).cuda()
            got = roi_pool.roi_crop_maxpool(feats, boxes, 14, 2, 2)
            exact = roi_ops.crop_resize_maxpool_exact(feats, boxes, 14, 2, 2)
            torch.cuda.synchronize()
            if not torch.equal(got, exact):
                raise AssertionError(
                    "roi_crop_maxpool: not bit-equal to its exact oracle (%s,"
                    " %s boxes, max |err| %r)" % (label, box_set, float(
                        (got.float() - exact.float()).abs().max())))
            err = compare(torch, got, roi_ops.crop_resize_maxpool(
                feats, boxes, 14, 2, 2), "bfloat16")
            result["max_abs_err"] = max(result["max_abs_err"], err)
            nbytes = (feats.numel() * feats.element_size() + boxes.numel() * 4
                      + got.numel() * got.element_size())
            b_ms, b_by = bound_ms(nbytes, ROI_OPS_PER_OUTPUT * got.numel())
            positions = footprint_positions(torch, boxes, *shape[1:3], 14)
            line = {"kernel": "roi_crop_maxpool", "shape": label,
                    "features": list(shape), "P": num_p, "boxes": box_set,
                    "max_abs_err_exact": 0.0, "max_abs_err": err,
                    "kernel_ms": cuda_ms(torch, lambda: roi_pool.
                                         roi_crop_maxpool(feats, boxes, 14,
                                                          2, 2), iters=20),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "footprint_positions_per_proposal":
                        positions / boxes.shape[0] / num_p,
                    "footprint_bytes": positions * shape[-1] * 2}
            line["kernel_over_bound"] = line["kernel_ms"] / b_ms
            log(json.dumps(line))
            if label == K1_SHAPES[0][0] and box_set == "mix":
                result.update({k: line[k] for k in (
                    "kernel_ms", "bound_ms", "bound_by")})
    staged = roi_pool.staged_launches - first[0]
    generic = roi_pool.generic_launches - first[1]
    if generic or not staged:
        raise AssertionError("roi_crop_maxpool: the model's shapes took the "
                             "generic kernel (%d staged, %d generic launches)"
                             % (staged, generic))
    log("roi_crop_maxpool: %d staged launches, %d generic, at the model's "
        "shapes" % (staged, generic))
    return result


def _pool_ops(shape, kernel, stride):
    """In-bounds taps summed over all outputs of a SAME pool."""
    from cap2det_tpu_torch.kernels.pool_grad import same_pads

    n, h, w, c = shape
    taps = 1
    for size in (h, w):
        out, pad_lo, _ = same_pads(size, kernel, stride)
        taps *= sum(min(o * stride - pad_lo + kernel, size)
                    - max(o * stride - pad_lo, 0) for o in range(out))
    return n * c * taps


def phase_pool(torch):
    import torch.nn.functional as F

    from cap2det_tpu_torch.kernels import pool_grad

    rng = np.random.default_rng(SEED + 1)
    total = {"max_abs_err": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "bound_ms": 0.0, "bound_by": set()}
    for label, kind, k, s, shape in POOL_SHAPES:
        x32 = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            got = pool_grad.pool_fwd(x, kind, k, s)
            want = pool_grad.pool_same_plain(x, kind, k, s)
            torch.cuda.synchronize()
            err = compare(torch, got, want, name)
            line = {"kernel": "pool_fwd", "shape": label, "dtype": name,
                    "max_abs_err": err, "tol(rtol,atol)": TOL[name]}
            if dtype == torch.bfloat16:
                x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view
                if kind == "pool_max":
                    lib = lambda: F.max_pool2d(x_cl, k, s, padding=1)  # noqa: E731
                else:
                    lib = lambda: F.avg_pool2d(  # noqa: E731
                        x_cl, k, s, padding=1, count_include_pad=False)
                torch.testing.assert_close(
                    lib().permute(0, 2, 3, 1).float(), want.float(),
                    rtol=TOL[name][0], atol=TOL[name][1])
                nbytes = (x.numel() + got.numel()) * x.element_size()
                ops = _pool_ops(shape, k, s) + (
                    got.numel() if kind == "pool_avg" else 0)
                b_ms, b_by = bound_ms(nbytes, ops)
                line.update(
                    kernel_ms=cuda_ms(torch, lambda: pool_grad.pool_fwd(
                        x, kind, k, s), iters=50),
                    plain_ms=cuda_ms(torch, lambda: pool_grad.pool_same_plain(
                        x, kind, k, s), iters=20),
                    library_ms=cuda_ms(torch, lib, iters=50),
                    bound_ms=b_ms, bound_by=b_by)
                line["kernel_over_bound"] = line["kernel_ms"] / b_ms
                total["max_abs_err"] = max(total["max_abs_err"], err)
                for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms"):
                    total[key] += line[key]
                total["bound_by"].add(b_by)
            log(json.dumps(line))
    # One launch of each shape per scale: the sums are per scale.
    total["bound_by"] = "/".join(sorted(total["bound_by"]))
    return total


def smooth_image(rng, h, w):
    """Seeded uint8 image: low-frequency color fields plus noise."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([np.sin(6 * yy + p) * np.cos(4 * xx - p)
                     for p in rng.uniform(0, 6, 3)], -1)
    image = np.clip(127 + 80 * base + rng.normal(0, 20, (h, w, 3)), 0, 255)
    return image.astype(np.uint8)


def _synthetic_example(rng, hw, image_id):
    boxes = make_boxes(rng, NUM_PROPOSALS, num_pad=0)
    return {"image": smooth_image(rng, *hw), "image_id": image_id,
            "proposals": np.clip(boxes, 0.0, 1.0)}


def phase_breakdown(torch, model, predictor, example, profile):
    """Where one image's time goes: CUDA events around the first stage,
    the ROI kernel, the second stage (the pool kernel inside it apart)
    and the postprocess (NMS), all four scales summed; "other" is the
    rest of the host-clock wall time (resize, preprocess, heads, copies,
    launch gaps). With ``profile``, torch.profiler also reads the device
    kernel time of one more image, whose share of the wall time is the
    device's busy share."""
    from cap2det_tpu_torch.kernels import pool_grad, roi_pool
    from cap2det_tpu_torch.models import inception_v2

    targets = [
        (inception_v2, "first_stage", "first_stage"),
        (roi_pool, "roi_crop_maxpool", "roi_crop_maxpool"),
        (inception_v2, "second_stage", "second_stage"),
        (pool_grad, "pool_fwd", "pool_fwd (inside second_stage)"),
        (model, "postprocess", "postprocess (NMS)"),
    ]
    with cuda_spans(torch, targets) as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict(example)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = span_ms(spans)
    ms["other"] = wall_ms - sum(v for k, v in ms.items() if "inside" not in k)
    ms["wall"] = wall_ms
    log("breakdown (ms, one image, all scales): %s" % json.dumps(ms))

    if not profile:
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(example)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(t for _, t in by_name.values())
    log("profile: wall %.3f ms, device kernels %.3f ms, busy share %s, "
        "%d launches" % (wall_ms, busy_ms,
                         "%.4f" % (busy_ms / wall_ms) if by_name
                         else "not measured",
                         sum(n for n, _ in by_name.values())))
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log("profile: %9.3f ms %6d x %s" % (t, n, name[:110]))


def phase_serve(torch, profile=False):
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.eval import evaluator
    from cap2det_tpu_torch.kernels import pool_grad, roi_pool
    from cap2det_tpu_torch.models import registry
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    cfg = schema.load_pipeline(os.path.join("configs", "voc07_inc2.pbtxt"))
    reader = cfg.eval_reader.cap2det_reader
    opts = cfg.model.cap2det_model
    model = registry.build(cfg.model, compute_dtype=torch.bfloat16)
    tree = model.init_jax_numpy(SEED)
    params = params_lib.from_jax_numpy(tree, "cuda")
    predictor = evaluator.MultiScalePredictor(model, params, reader)
    rng = np.random.default_rng(SEED + 2)
    examples = [_synthetic_example(rng, hw, i) for i, hw in
                enumerate([(375, 500), (500, 333), (400, 400)])]
    num_scales = len(opts.eval_min_dimension)
    log("serve: voc07_inc2, %d scales %s, P=%d, %d classes, %d OICR "
        "iterations, bf16" % (num_scales, list(opts.eval_min_dimension),
                              reader.max_num_proposals, model.num_classes,
                              opts.oicr_iterations))

    # The canvases of the largest scale, resized on the card, equal the
    # CPU's bit for bit (which the CPU tests hold to cv2's).
    short, long = pipeline_lib.compute_canvas(max(opts.eval_min_dimension))
    for ex in examples:
        h, w = ex["image"].shape[:2]
        hw = (short, long) if w >= h else (long, short)
        card, _ = pipeline_lib.fit_image_to_canvas(
            torch.from_numpy(ex["image"]).cuda(), hw)
        host, _ = pipeline_lib.fit_image_to_canvas(ex["image"], hw)
        if not torch.equal(card.cpu(), host):
            raise AssertionError("card canvas %s differs from the CPU's"
                                 % (hw,))
    log("serve: canvases at scale %d equal the CPU's bit for bit"
        % max(opts.eval_min_dimension))

    for ex in examples:  # warm-up (cuDNN plans of both orientations)
        predictor.predict(ex)
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [predictor.predict(ex) for ex in examples]
    torch.cuda.synchronize()
    launches = launch_counts()
    log("serve: launches %s" % json.dumps(launches))
    want = dict.fromkeys(KERNELS, 0)
    want.update(roi_crop_maxpool=num_scales * len(examples),
                pool_fwd=3 * num_scales * len(examples))
    if launches != want:
        raise AssertionError("launch counts %s, expected %s" % (launches, want))
    if roi_pool.staged_launches != launches["roi_crop_maxpool"]:
        raise AssertionError(
            "serve: K1 took the generic kernel (%d of %d launches staged)"
            % (roi_pool.staged_launches, launches["roi_crop_maxpool"]))

    for out in outs:
        for it in range(1 + opts.oicr_iterations):
            n = int(out["num_detections_at_%d" % it])
            cls = out["detection_classes_at_%d" % it]
            for key in ("boxes", "scores", "classes"):
                v = out["detection_%s_at_%d" % (key, it)]
                if not np.all(np.isfinite(v)):
                    raise AssertionError("non-finite detection_%s" % key)
            if n < 1 or not (np.all((cls[:n] >= 1) & (cls[:n] <= 20))
                             and np.all(cls[n:] == 0)):
                raise AssertionError("bad detections at iteration %d: n=%d"
                                     % (it, n))
    log("serve: detections at iteration 3: %s" % json.dumps(
        [int(o["num_detections_at_3"]) for o in outs]))

    # Host-clock seconds per image over TIMED_ROUNDS passes of the three
    # images; after each image, its postprocess (NMS) alone on the same
    # scores, a separate measurement and not a share of that image.
    times, nms_times = [], []
    for _ in range(TIMED_ROUNDS):
        for ex, out in zip(examples, outs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.predict(ex)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            props = torch.from_numpy(out["proposals"])[None].cuda()
            num = torch.tensor([out["num_proposals"]]).cuda()
            scores = {k: torch.from_numpy(v).cuda()
                      for k, v in out["proposal_scores"].items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.postprocess(scores, props, num)
            torch.cuda.synchronize()
            nms_times.append(time.perf_counter() - t0)
    for label, samples in (("seconds per image", times),
                           ("postprocess (NMS) alone, seconds", nms_times)):
        log("serve: %s over %d images: median %r, min %r, max %r; "
            "samples %s" % (label, len(samples), float(np.median(samples)),
                            min(samples), max(samples), json.dumps(samples)))
    phase_breakdown(torch, model, predictor, examples[0], profile)

    # One scale (the smallest canvas) of the first image: card float32
    # against the plain path on the CPU in float32, on the same canvas.
    ex = examples[0]
    short, long = pipeline_lib.compute_canvas(min(opts.eval_min_dimension))
    canvas, (nh, nw) = pipeline_lib.fit_image_to_canvas(ex["image"],
                                                        (short, long))
    scale = np.array([nh / short, nw / long] * 2, np.float32)
    batch = {"image": canvas[None].numpy(),
             "proposals": (ex["proposals"] * scale)[None],
             "num_proposals": np.array([NUM_PROPOSALS], np.int32)}
    scores = {}
    for device in ("cuda", "cpu"):
        m = registry.build(cfg.model, compute_dtype=torch.float32,
                           device=device)
        p = m.prepare(params_lib.from_jax_numpy(tree, device))
        t0 = time.perf_counter()
        with torch.inference_mode():
            preds = m.predictions(p, batch)
        scores[device] = {k: preds[k].cpu() for k in m.score_keys()}
        log("serve: float32 scale %dx%d on %s in %.2f s" % (
            short, long, device, time.perf_counter() - t0))
    errs = {}
    for k in scores["cpu"]:
        got, want = scores["cuda"][k], scores["cpu"][k]
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite scores %s" % k)
        torch.testing.assert_close(got, want, rtol=SCORE_TOL[0],
                                   atol=SCORE_TOL[1])
        errs[k] = float((got - want).abs().max() / want.abs().max())
    log("serve: card vs CPU float32 max|err|/max|ref| %s (rtol %g, atol %g)"
        % (json.dumps(errs), *SCORE_TOL))
    return launches


def phase_roi_grad(torch):
    """K2 against its plain version at the coco17 training shape."""
    from cap2det_tpu_torch.kernels import roi_pool
    from cap2det_tpu_torch.ops import roi as roi_ops

    rng = np.random.default_rng(SEED + 4)
    batch = TRAIN_FEATURE_SHAPE[0]
    normal = torch.from_numpy(rng.standard_normal(
        TRAIN_FEATURE_SHAPE, dtype=np.float32)).cuda()
    ties = torch.from_numpy(rng.integers(0, 3, TRAIN_FEATURE_SHAPE).astype(
        np.float32)).cuda()
    boxes = torch.from_numpy(np.stack([
        make_boxes(rng, TRAIN_P, num_pad=TRAIN_P // 20)
        for _ in range(batch)])).cuda()
    grad32 = torch.from_numpy(rng.standard_normal(
        (batch, TRAIN_P, 7, 7, TRAIN_FEATURE_SHAPE[-1]),
        dtype=np.float32)).cuda()
    result = {"max_abs_err": 0.0}
    first = roi_pool.grad_launches
    first_generic = roi_pool.grad_generic_launches
    for case, base in (("normal", normal), ("ties {0,1,2}", ties)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            feats, grad = base.to(dtype), grad32.to(dtype)
            got = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2, 2)
            exact = roi_ops.crop_resize_maxpool_grad(
                feats, boxes, grad, 14, 2, 2, fixed_point=True)
            want = roi_ops.crop_resize_maxpool_grad(feats, boxes, grad, 14,
                                                    2, 2)
            again = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2,
                                                   2)
            torch.cuda.synchronize()
            exact_err = float((got.float() - exact.float()).abs().max())
            if not torch.equal(got, exact):
                raise AssertionError(
                    "roi_crop_maxpool_grad: not bit-equal to its fixed-point "
                    "oracle (%s %s, max |err| %r)" % (case, name, exact_err))
            err = compare(torch, got, want, name, GRAD_TOL)
            run_to_run = float((got.float() - again.float()).abs().max())
            if not torch.equal(got, again):
                raise AssertionError(
                    "roi_crop_maxpool_grad: two launches differ (%s %s, max "
                    "|diff| %r)" % (case, name, run_to_run))
            result["max_abs_err"] = max(result["max_abs_err"], err)
            line = {"kernel": "roi_crop_maxpool_grad", "case": case,
                    "dtype": name, "max_abs_err_exact": exact_err,
                    "max_abs_err": err,
                    "tol(rtol,atol)": GRAD_TOL[name],
                    "max_abs_dF": float(want.float().abs().max()),
                    "run_to_run_max_abs_diff": run_to_run}
            if case == "normal" and dtype == torch.bfloat16:
                nbytes = (2 * feats.numel() * feats.element_size()
                          + boxes.numel() * 4
                          + grad.numel() * grad.element_size())
                b_ms, b_by = bound_ms(nbytes,
                                      ROI_GRAD_OPS_PER_CELL * grad.numel())
                line.update(
                    kernel_ms=cuda_ms(torch, lambda: roi_pool.
                                      roi_crop_maxpool_grad(
                                          feats, boxes, grad, 14, 2, 2),
                                      iters=20),
                    plain_ms=cuda_ms(torch, lambda: roi_ops.
                                     crop_resize_maxpool_grad(
                                         feats, boxes, grad, 14, 2, 2),
                                     iters=2, warmup=1),
                    bound_ms=b_ms, bound_by=b_by)
                line["kernel_over_bound"] = line["kernel_ms"] / b_ms
                # Global int64 atomics, from the oracle with the kernel's
                # rule: the generic kernel issues one per nonzero
                # contribution; the staged one adds small footprints in
                # shared memory first.
                line.update(roi_pool.grad_atomic_counts(feats, boxes, grad,
                                                        14, 2, 2))
                result.update({k: line[k] for k in (
                    "kernel_ms", "plain_ms", "bound_ms", "bound_by")})
            log(json.dumps(line))

    # The same shape with all-wide and all-narrow boxes.
    feats, grad = normal.to(torch.bfloat16), grad32.to(torch.bfloat16)
    for box_set in ("wide", "narrow"):
        boxes = torch.from_numpy(np.stack([
            make_boxes(rng, TRAIN_P, num_pad=TRAIN_P // 20,
                       only=BOX_SETS[box_set]) for _ in range(batch)])).cuda()
        line = {"kernel": "roi_crop_maxpool_grad", "boxes": box_set,
                "dtype": "bfloat16",
                "kernel_ms": cuda_ms(torch, lambda: roi_pool.
                                     roi_crop_maxpool_grad(
                                         feats, boxes, grad, 14, 2, 2),
                                     iters=20)}
        line.update(roi_pool.grad_atomic_counts(feats, boxes, grad, 14, 2, 2))
        log(json.dumps(line))
    # The largest coco17 training bucket: exact, within GRAD_TOL of the
    # plain version, the same bits twice, timed beside its bound.
    feats32 = torch.from_numpy(rng.standard_normal(
        TRAIN_LARGEST_FEATURE_SHAPE, dtype=np.float32)).cuda()
    boxes = torch.from_numpy(np.stack([
        make_boxes(rng, TRAIN_P, num_pad=TRAIN_P // 20)
        for _ in range(batch)])).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        feats, grad = feats32.to(dtype), grad32.to(dtype)
        got = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2, 2)
        exact = roi_ops.crop_resize_maxpool_grad(
            feats, boxes, grad, 14, 2, 2, fixed_point=True)
        again = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2, 2)
        torch.cuda.synchronize()
        if not (torch.equal(got, exact) and torch.equal(got, again)):
            raise AssertionError(
                "roi_crop_maxpool_grad: %s at %s differs from its fixed-point "
                "oracle or between launches" % (name,
                                                TRAIN_LARGEST_FEATURE_SHAPE))
        err = compare(torch, got, roi_ops.crop_resize_maxpool_grad(
            feats, boxes, grad, 14, 2, 2), name, GRAD_TOL)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        line = {"kernel": "roi_crop_maxpool_grad",
                "shape": "train coco17 1216x1824",
                "features": list(TRAIN_LARGEST_FEATURE_SHAPE), "P": TRAIN_P,
                "dtype": name, "max_abs_err_exact": 0.0, "max_abs_err": err,
                "tol(rtol,atol)": GRAD_TOL[name],
                "run_to_run_max_abs_diff": 0.0}
        if dtype == torch.bfloat16:
            nbytes = (2 * feats.numel() * feats.element_size()
                      + boxes.numel() * 4 + grad.numel() * grad.element_size())
            b_ms, b_by = bound_ms(nbytes, ROI_GRAD_OPS_PER_CELL * grad.numel())
            line.update(
                kernel_ms=cuda_ms(torch, lambda: roi_pool.
                                  roi_crop_maxpool_grad(
                                      feats, boxes, grad, 14, 2, 2),
                                  iters=20),
                plain_ms=cuda_ms(torch, lambda: roi_ops.
                                 crop_resize_maxpool_grad(
                                     feats, boxes, grad, 14, 2, 2),
                                 iters=2, warmup=1),
                bound_ms=b_ms, bound_by=b_by)
            line["kernel_over_bound"] = line["kernel_ms"] / b_ms
            line.update(roi_pool.grad_atomic_counts(feats, boxes, grad, 14,
                                                    2, 2))
        log(json.dumps(line))
    if roi_pool.grad_generic_launches != first_generic:
        raise AssertionError("roi_crop_maxpool_grad: a coco17 shape took "
                             "the generic kernel")
    log("roi_crop_maxpool_grad: %d launches in this phase (checks and "
        "timing), all staged" % (roi_pool.grad_launches - first))
    return result


def phase_pool_grad(torch):
    """K5 and K6 against their plain versions at the training shapes.
    Returns the coco17 (N=1000) totals of each: the kernels line's rows."""
    import torch.nn.functional as F

    from cap2det_tpu_torch.kernels import pool_grad

    rng = np.random.default_rng(SEED + 5)
    first = (pool_grad.maxpool_grad_launches, pool_grad.avgpool_grad_launches)
    paths = pool_grad_paths()
    totals = {}
    for label, kind, k, s, shape in TRAIN_POOL_SHAPES + VOC_POOL_SHAPES:
        name_k = "maxpool_grad" if kind == "pool_max" else "avgpool_grad"
        coco = (label, kind, k, s, shape) in TRAIN_POOL_SHAPES
        total = totals.setdefault(name_k, {
            "max_abs_err": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bound_ms": 0.0, "bound_by": set()})
        out_shape = (shape[0], -(-shape[1] // s), -(-shape[2] // s),
                     shape[3])
        x32 = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda()
        g32 = torch.from_numpy(rng.standard_normal(
            out_shape, dtype=np.float32)).cuda()
        xq = torch.from_numpy(rng.integers(0, 3, shape).astype(
            np.float32)).cuda()
        cases = [("normal", x32)] + ([("ties {0,1,2}", xq)]
                                     if kind == "pool_max" else [])
        for case, base in cases:
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[-1]
                x, g = base.to(dtype), g32.to(dtype)
                if kind == "pool_max":
                    run = lambda: pool_grad.maxpool_grad(x, g, k, s)  # noqa: E731
                    plain = lambda: pool_grad.maxpool_grad_plain(  # noqa: E731
                        x, g, k, s)
                else:
                    run = lambda: pool_grad.avgpool_grad(  # noqa: E731
                        x.shape, dtype, g, k, s)
                    plain = lambda: pool_grad.avgpool_grad_plain(  # noqa: E731
                        x.shape, dtype, g, k, s)
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(
                        "%s: %s not bit-equal to its plain version (%s, %s, "
                        "max |err| %r)" % (name_k, name, label, case, err))
                line = {"kernel": name_k, "shape": label, "case": case,
                        "dtype": name, "max_abs_err": err}
                if coco:
                    total["max_abs_err"] = max(total["max_abs_err"], err)
                if case == "normal" and dtype == torch.bfloat16:
                    x_cl = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
                    if kind == "pool_max":
                        y = F.max_pool2d(x_cl, k, s, padding=1)
                    else:
                        y = F.avg_pool2d(x_cl, k, s, padding=1,
                                         count_include_pad=False)
                    g_cl = g.permute(0, 3, 1, 2)
                    lib = lambda: torch.autograd.grad(  # noqa: E731
                        y, x_cl, g_cl, retain_graph=True)
                    reads_x = kind == "pool_max"
                    nbytes = ((2 * x.numel() if reads_x else x.numel())
                              + g.numel()) * x.element_size()
                    ops = _pool_ops(shape, k, s) + g.numel()
                    b_ms, b_by = bound_ms(nbytes, ops)
                    line.update(
                        kernel_ms=cuda_ms(torch, run, iters=50),
                        device_ms=device_ms(torch, run),
                        plain_ms=cuda_ms(torch, plain, iters=10),
                        library_ms=cuda_ms(torch, lib, iters=50),
                        bound_ms=b_ms, bound_by=b_by)
                    line["kernel_over_bound"] = line["kernel_ms"] / b_ms
                    line["device_over_bound"] = line["device_ms"] / b_ms
                    if coco:
                        for key in ("kernel_ms", "plain_ms", "library_ms",
                                    "bound_ms"):
                            total[key] += line[key]
                        total["bound_by"].add(b_by)
                log(json.dumps(line))
    for total in totals.values():
        total["bound_by"] = "/".join(sorted(total["bound_by"]))
    tiled = check_pool_grad_tiled("pool_grad", paths)
    log("maxpool_grad, avgpool_grad: %d and %d launches in this phase "
        "(checks and timing), all tiled (%d, %d)" % (
            pool_grad.maxpool_grad_launches - first[0],
            pool_grad.avgpool_grad_launches - first[1],
            tiled["maxpool_grad_tiled_launches"],
            tiled["avgpool_grad_tiled_launches"]))
    return totals["maxpool_grad"], totals["avgpool_grad"]


def train_batch(rng, batch, hw, num_p, num_classes, pad):
    """A seeded host training batch: uint8 canvases, proposals inside the
    image (the second image's last `pad` slots are zero padding), and
    multi-hot labels with at least one positive per image."""
    proposals = np.stack([
        np.clip(make_boxes(rng, num_p, num_pad=pad if i else 0), 0.0, 1.0)
        for i in range(batch)])
    labels = (rng.uniform(size=(batch, num_classes)) < 0.05).astype(
        np.float32)
    labels[np.arange(batch), rng.integers(0, num_classes, batch)] = 1.0
    return {
        "image": np.stack([smooth_image(rng, *hw) for _ in range(batch)]),
        "proposals": proposals,
        "number_of_proposals": np.array(
            [num_p] + [num_p - pad] * (batch - 1), np.int32),
        "pseudo_labels": labels,
    }


def phase_train(torch, config, batch_size, num_p, warmup, timed, want,
                breakdown):
    """Training steps at a config's full width with seeded He weights:
    launch counts per step, finite losses, frozen leaves unchanged,
    trainable weights moved, seconds per step, peak memory, and with
    `breakdown` one more step timed by span."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.kernels import pool_grad, roi_pool
    from cap2det_tpu_torch.models import inception_v2, registry
    from cap2det_tpu_torch.train import optimizers, trainer
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    cfg = schema.load_pipeline(os.path.join("configs", config))
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.bfloat16)
    state, opt, schedule, mask = trainer.TrainState.create(
        model, cfg.train_config, SEED)
    step = trainer.make_train_step(model, opt, cfg.train_config, mask)
    rng = np.random.default_rng(SEED + 6)
    batch = model.device_batch(train_batch(
        rng, batch_size, (1024, 1536), num_p, model.num_classes,
        pad=num_p // 10))
    flat_mask = dict(optimizers.flatten_params(mask))
    initial = {path: leaf.detach().clone() for path, leaf
               in optimizers.flatten_params(state["params"])}
    tag = config.split(".")[0]
    log("train %s: batch %d, 1024x1536, P=%d, %d classes, %d trainable of "
        "%d leaves, lr %g, bf16 convolutions" % (
            tag, batch_size, num_p, model.num_classes,
            sum(flat_mask.values()), len(flat_mask), schedule(0)))

    losses = []
    for _ in range(warmup):
        state, logs = step(state, batch, SEED)
        losses.append(float(logs["loss/total_loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    paths = pool_grad_paths()
    times = []
    for _ in range(timed):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logs = step(state, batch, SEED)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in KERNELS}
        if delta != want:
            raise AssertionError("train %s: launches per step %s, expected "
                                 "%s" % (tag, delta, want))
        losses.append(float(logs["loss/total_loss"]))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if roi_pool.generic_launches or roi_pool.grad_generic_launches:
        raise AssertionError("train %s: K1 or K2 took the generic kernel"
                             % tag)
    tiled = check_pool_grad_tiled("train " + tag, paths)
    if (tiled["maxpool_grad_tiled_launches"] != launches["maxpool_grad"]
            or tiled["avgpool_grad_tiled_launches"]
            != launches["avgpool_grad"]):
        raise AssertionError("train %s: K5/K6 launches %s, by kernel %s"
                             % (tag, launches, tiled))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("train %s: non-finite loss %s" % (tag, losses))
    log("train %s: launches over %d steps %s (per step %s); K5, K6 all "
        "tiled" % (tag, timed, json.dumps(launches), json.dumps(want)))
    log("train %s: total loss per step %s; last step %s" % (
        tag, json.dumps(losses),
        json.dumps({k: float(v) for k, v in logs.items()})))

    frozen_changed, trainable_weights, moved = [], 0, {}
    for path, leaf in optimizers.flatten_params(state["params"]):
        same = torch.equal(leaf.detach(), initial[path])
        if not flat_mask[path]:
            if not same:
                frozen_changed.append(path)
        elif path.endswith("weights"):
            trainable_weights += 1
            if not same:
                scope = ("Mixed_4e" if "/Mixed_4e/" in path
                         else path.split("/")[0])
                moved[scope] = moved.get(scope, 0) + 1
    if frozen_changed:
        raise AssertionError("train %s: frozen leaves changed: %s"
                             % (tag, frozen_changed[:5]))
    if sum(moved.values()) != trainable_weights:
        raise AssertionError("train %s: only %d of %d trainable weights "
                             "moved: %s" % (tag, sum(moved.values()),
                                            trainable_weights, moved))
    log("train %s: frozen leaves bitwise unchanged (%d); trainable weights "
        "moved by scope %s" % (tag, len(flat_mask) - sum(flat_mask.values()),
                               json.dumps(moved)))
    log("train %s: seconds per step over %d steps: median %r, min %r, "
        "max %r; samples %s; peak memory %d bytes" % (
            tag, timed, float(np.median(times)), min(times), max(times),
            json.dumps(times), peak))
    result = {"launches": launches, "median_s": float(np.median(times)),
              "peak_bytes": peak}
    if breakdown:
        targets = [
            (model, "loss", "forward (loss)"),
            (model, "prepare", "BN fold (inside forward)"),
            (inception_v2, "first_stage", "first stage (inside forward)"),
            (roi_pool, "roi_crop_maxpool", "K1 (inside forward)"),
            (inception_v2, "second_stage",
             "second-stage forward (inside forward)"),
            (roi_pool, "roi_crop_maxpool_grad", "K2 (inside backward)"),
            (pool_grad, "maxpool_grad", "K5 (inside backward)"),
            (pool_grad, "avgpool_grad", "K6 (inside backward)"),
            (opt, "apply", "optimizer"),
        ]
        with cuda_spans(torch, targets) as spans, \
                pool_grad_layouts(pool_grad) as layouts:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            state, logs = step(state, batch, SEED)
            end.record()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ms = span_ms(spans)
        ms["step (events)"] = start.elapsed_time(end)
        ms["heads and loss (inside forward)"] = ms["forward (loss)"] - sum(
            ms[k] for k in ("BN fold (inside forward)",
                            "first stage (inside forward)",
                            "K1 (inside forward)",
                            "second-stage forward (inside forward)"))
        ms["backward and step glue"] = (ms["step (events)"]
                                        - ms["forward (loss)"]
                                        - ms["optimizer"])
        ms["wall (host)"] = wall_ms
        log("train %s: breakdown of one step (ms): %s" % (tag, json.dumps(ms)))
        log("train %s: upstream gradients of the second-stage pools as "
            "they reach the backward (a non-contiguous one is copied): %s"
            % (tag, json.dumps(layouts)))
    return result


def phase_card_vs_cpu(torch):
    """One float32 step at 256x384, P=64 with the coco17 options and
    dropout off, from the same params and batch on the card and the CPU."""
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.models import registry
    from cap2det_tpu_torch.train import optimizers, trainer
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    cfg = schema.load_pipeline(os.path.join("configs",
                                            "coco17_extend_match.pbtxt"))
    cfg.model.cap2det_model.frcnn_options.dropout_keep_prob = 1.0
    rng = np.random.default_rng(SEED + 7)
    tree, host, got = None, None, {}
    for device in ("cuda", "cpu"):
        model = registry.build(cfg.model, is_training=True,
                               compute_dtype=torch.float32, device=device)
        if tree is None:
            tree = model.init_jax_numpy(SEED)
            host = train_batch(rng, 2, (256, 384), 64, model.num_classes,
                               pad=8)
        params = params_lib.from_jax_numpy(tree, device)
        opt, mask, _ = optimizers.build_optimizer(
            cfg.train_config, params, model.non_trainable_paths,
            model.non_trainable_substrings)
        trainer.set_trainable(params, mask)
        batch = model.device_batch(host)
        heads = [(p, leaf) for p, leaf in optimizers.flatten_params(params)
                 if p.startswith(("midn/", "oicr/"))]
        t0 = time.perf_counter()
        total, _ = model.loss(params, batch)
        grads = torch.autograd.grad(total, [leaf for _, leaf in heads])
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        state, logs = trainer.make_train_step(
            model, opt, cfg.train_config, mask)(state, batch, SEED)
        loss = float(total.detach())
        step_loss = float(logs["loss/total_loss"])
        got[device] = (loss, step_loss,
                       {p: g.cpu() for (p, _), g in zip(heads, grads)},
                       {p: leaf.detach().cpu() for p, leaf in heads})
        log("card vs CPU: %s loss %r, step loss %r, %.2f s" % (
            device, loss, step_loss, time.perf_counter() - t0))
    (loss_c, step_c, grads_c, heads_c) = got["cuda"]
    (loss_h, step_h, grads_h, heads_h) = got["cpu"]
    # float32 through ~20 layers, cuDNN (TF32 off) against the CPU's
    # convolutions, and K2's fixed-point sums against index_add_.
    np.testing.assert_allclose([loss_c, step_c], [loss_h, step_h],
                               rtol=1e-4)
    scale = max(float(g.abs().max()) for g in grads_h.values())
    grad_err, param_err = 0.0, 0.0
    for path in grads_h:
        torch.testing.assert_close(
            grads_c[path], grads_h[path], rtol=1e-3,
            atol=1e-3 * float(grads_h[path].abs().max()) + 1e-6 * scale)
        grad_err = max(grad_err, float(
            (grads_c[path] - grads_h[path]).abs().max()) / scale)
        # An Adagrad step moves a param by up to lr = 0.01: 1e-5 is 0.1%.
        torch.testing.assert_close(heads_c[path], heads_h[path], rtol=1e-4,
                                   atol=1e-5)
        param_err = max(param_err, float(
            (heads_c[path] - heads_h[path]).abs().max()))
    log("card vs CPU: loss rel err %r; head grads max|err|/max|grad| %r "
        "(rtol 1e-3, atol 1e-3 of the leaf's max); updated head params "
        "max|err| %r (rtol 1e-4, atol 1e-5)" % (
            abs(loss_c - loss_h) / abs(loss_h), grad_err, param_err))
    divisions_card_vs_cpu(torch)


def divisions_card_vs_cpu(torch):
    """The two divisions by a count or probability that is no power of two
    give the CPU's IEEE quotient on the card, bit for bit: the dropout's
    x / keep_prob at keep_prob 0.7, and MultiScalePredictor's mean over 3
    scales (the model's scores fixed per scale, so only the mean runs)."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.eval import evaluator
    from cap2det_tpu_torch.models import frcnn, registry

    rng = np.random.default_rng(SEED + 8)
    x = torch.from_numpy(rng.uniform(0.5, 2.0, 1 << 20).astype(np.float32))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    got = frcnn.dropout(x.cuda(), 0.7, gen).cpu()
    kept = got != 0
    want = torch.where(kept, x / torch.tensor(0.7), torch.zeros_like(x))
    dropout_diff = int((got != want).sum())

    model_cfg = schema.load_pipeline(os.path.join(
        "configs", "coco17_extend_match.pbtxt")).model
    model_cfg.cap2det_model.eval_min_dimension = [96, 64, 48]
    num_p, num_c = 500, 80
    scales = [{"oicr_proposal_scores_at_%d" % i: rng.standard_normal(
        (1, num_p, num_c + (i > 0))).astype(np.float32)
        for i in range(1 + model_cfg.cap2det_model.oicr_iterations)}
        for _ in range(3)]
    example = {"image": smooth_image(rng, 50, 70),
               "proposals": np.clip(make_boxes(rng, num_p, 0), 0.0, 1.0)}
    means = {}
    for device in ("cuda", "cpu"):
        model = registry.build(model_cfg, compute_dtype=torch.float32,
                               device=device)
        calls = iter(scales)
        model.predictions = lambda prepared, batch, _dev=device: {
            k: torch.from_numpy(v).to(_dev) for k, v in next(calls).items()}
        predictor = evaluator.MultiScalePredictor(
            model, model.init_params(SEED), schema.Cap2DetReader.from_dict(
                {"max_num_proposals": num_p}))
        means[device] = predictor.predict(example)["proposal_scores"]
    mean_diff = sum(int((means["cuda"][k] != v).sum())
                    for k, v in means["cpu"].items())
    log("card vs CPU divisions: dropout x / 0.7 over %d values, %d kept, %d "
        "differ; mean of 3 scales over %d scores, %d differ" % (
            x.numel(), int(kept.sum()), dropout_diff,
            sum(v.size for v in means["cpu"].values()), mean_diff))
    if dropout_diff or mean_diff:
        raise AssertionError("a division on the card differs from the CPU's")


def snapshot(torch, state):
    """CPU copies of a training state's params, optimizer slots, count and
    step (the live tensors change in place as training goes on)."""
    from cap2det_tpu_torch.train import optimizers

    return {
        "params": {p: leaf.detach().cpu().clone() for p, leaf in
                   optimizers.flatten_params(state["params"])},
        "slots": {(p, k): v.detach().cpu().clone() for p, slots in
                  state["opt_state"]["slots"].items()
                  for k, v in slots.items()},
        "count": state["opt_state"]["count"], "step": state["step"]}


def busy_share(trace_path):
    """(device busy ms, window ms) of a torch.profiler chrome trace: the
    union of the card's kernel, copy and set intervals, and the span of
    all events."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for a, b in device:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    return busy / 1e3, window / 1e3


def write_train_records(directory, num_examples, image_hw, seed):
    """Seeded PNG records at coco17's shape in both orientations: smooth
    images, 500 proposals, captions naming coco classes (the extend-match
    table's class names)."""
    from cap2det_tpu_torch.data import synthetic
    from cap2det_tpu_torch.text import vocab

    classes, _ = vocab.load_synonym_table(
        os.path.join("data", "coco_label_synonyms.txt"))
    h, w = image_hw
    for i, (name, hw) in enumerate((("landscape", (h, w)),
                                    ("portrait", (w, h)))):
        synthetic.write_synthetic_dataset(
            os.path.join(directory, "train-%s.record" % name),
            num_examples=num_examples, seed=seed + i, classes=classes,
            image_hw=hw, num_proposals=TRAIN_P, smooth=True)
    return os.path.join(directory, "train-*.record")


PER_STEP = {"roi_crop_maxpool": 1, "pool_fwd": 3, "roi_crop_maxpool_grad": 1,
            "maxpool_grad": 2, "avgpool_grad": 1}


def run_train(torch, trainer, cfg, model_dir, steps, profile_steps=None):
    """trainer.train() on the card with a hook that records, per step, a
    CUDA event and the host clock at its end, the loop's wait on the
    input pipeline, its pinning and queuing of the batches' copies, the
    canvas and the kernel launches. Returns (state, records,
    start event, host start, wall seconds)."""
    records = []
    previous = [launch_counts()]

    def hook(step, state, logs):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        now = launch_counts()
        records.append({
            "step": step, "host": time.perf_counter(), "event": end,
            "wait": logs["input/wait_sec"],
            "place": logs["input/place_sec"],
            "canvas": (int(logs["input/canvas_height"]),
                       int(logs["input/canvas_width"])),
            "launches": {k: now[k] - previous[0][k] for k in KERNELS}})
        previous[0] = now

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t_start = time.perf_counter()
    state = trainer.train(cfg, model_dir=model_dir, max_steps=steps,
                          hooks=[hook], profile_steps=profile_steps)
    torch.cuda.synchronize()
    return state, records, start, t_start, time.perf_counter() - t_start


def report_steps(tag, records, start, t_start, train_config):
    """Logs, per canvas bucket, the step's time on the card's timeline
    (event to event) and on the host clock (hook to hook), the loop's
    wait on the input pipeline and its time placing batches. A bucket's first step, and the steps that wrote
    metrics or a checkpoint, are reported apart. Returns the medians over
    the other steps."""
    def side(r):
        return (r["step"] % train_config.save_checkpoints_steps == 0
                or r["step"] % train_config.log_step_count_steps == 0)

    per_bucket = {}
    for prev, r in zip([None] + records[:-1], records):
        r["event_ms"] = (prev["event"] if prev else start).elapsed_time(
            r["event"])
        r["host_s"] = r["host"] - (prev["host"] if prev else t_start)
        b = per_bucket.setdefault(r["canvas"], {"first": None, "steps": []})
        if b["first"] is None:
            b["first"] = r
        elif not side(r):
            b["steps"].append(r)
    for canvas in sorted(per_bucket):
        b = per_bucket[canvas]
        first = b["first"]
        line = {"run": tag, "bucket": "%dx%d" % canvas,
                "steps": 1 + len(b["steps"]),
                "first_step": {"step": first["step"],
                               "event_ms": first["event_ms"],
                               "host_s": first["host_s"],
                               "wait_s": first["wait"],
                               "place_s": first["place"]}}
        if b["steps"]:
            line.update({
                "median_event_ms": float(np.median(
                    [r["event_ms"] for r in b["steps"]])),
                "median_host_s": float(np.median(
                    [r["host_s"] for r in b["steps"]])),
                "median_wait_s": float(np.median(
                    [r["wait"] for r in b["steps"]])),
                "median_place_s": float(np.median(
                    [r["place"] for r in b["steps"]])),
                "samples_event_ms": [r["event_ms"] for r in b["steps"]]})
        log("train_loop: " + json.dumps(line))
    log("train_loop: %s: steps that wrote metrics or a checkpoint: %s" % (
        tag, json.dumps([{"step": r["step"], "event_ms": r["event_ms"],
                          "host_s": r["host_s"], "wait_s": r["wait"],
                          "place_s": r["place"]}
                         for r in records if side(r)])))
    firsts = {id(b["first"]) for b in per_bucket.values()}
    steady = [r for r in records if id(r) not in firsts and not side(r)]
    medians = {"event_ms": float(np.median([r["event_ms"] for r in steady])),
               "host_s": float(np.median([r["host_s"] for r in steady])),
               "wait_s": float(np.median([r["wait"] for r in steady])),
               "place_s": float(np.median([r["place"] for r in steady]))}
    log("train_loop: %s: over %d steps (no bucket's first, none that wrote),"
        " median event_ms %r, host_s %r, wait_s %r, place_s %r; wait share "
        "of host time %r" % (tag, len(steady), medians["event_ms"],
                             medians["host_s"], medians["wait_s"],
                             medians["place_s"],
                             sum(r["wait"] for r in steady)
                             / sum(r["host_s"] for r in steady)))
    return medians


def phase_train_loop(torch, profile, steps=TRAIN_LOOP_STEPS,
                     image_hw=(480, 640), examples_per_file=8):
    """train() from TFRecords at configs/coco17_extend_match.pbtxt as
    shipped (batch 2, P=500, scales 1.2/0.8/0.6/0.4, flip 0.5, Mixed_4e
    trainable, Adagrad, dropout 0.5), its input pattern and model_dir in a
    temporary directory, logging and saving every few steps: every canvas
    bucket feeds a step, each step launches K1 1, K4 3, K2 1, K5 2, K6 1
    (K1 and K2 staged), per-bucket step and feed-wait medians, peak
    memory. The same steps again, fed from the same batches made
    beforehand, say what the feed's thread adds to a step. Then a second
    train() restores the final checkpoint bit for bit and trains on from
    its step. With `profile`, steps of the first run are traced and the
    device's busy share printed.

    Returns the launches of the first run (counts set to 0 just before)."""
    import glob
    import importlib.util
    import tempfile

    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.kernels import roi_pool
    from cap2det_tpu_torch.text import extractors
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib
    from cap2det_tpu_torch.train import trainer

    log("train_loop: Pillow (PIL) %s on this machine" % (
        "imports" if importlib.util.find_spec("PIL") else "does not import"))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        pattern = write_train_records(tmp.name, examples_per_file, image_hw,
                                      SEED + 9)
        sizes = [os.path.getsize(f) for f in glob.glob(pattern)]
        log("train_loop: wrote %d PNG records (%s, both orientations, P=%d) "
            "in %.1f s, %d bytes" % (2 * examples_per_file, image_hw, TRAIN_P,
                                     time.perf_counter() - t0, sum(sizes)))
        cfg = schema.load_pipeline(os.path.join("configs",
                                                "coco17_extend_match.pbtxt"))
        reader = cfg.train_reader.cap2det_reader
        reader.input_pattern = [pattern]
        cfg.train_config.save_checkpoints_steps = 10
        cfg.train_config.log_step_count_steps = 5
        model_dir = os.path.join(tmp.name, "model")
        buckets = set()
        for scale in reader.batch_resize_scale_value:
            short, long = pipeline_lib.compute_canvas(
                reader.image_resizer.keep_aspect_ratio_resizer.min_dimension,
                scale)
            buckets |= {(short, long), (long, short)}

        profile_steps = (steps - 4, steps - 1) if profile else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state, records, start, t_start, wall = run_train(
            torch, trainer, cfg, model_dir, steps, profile_steps)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()

        bad = [r for r in records if r["launches"] != PER_STEP]
        if bad:
            raise AssertionError("train_loop: launches per step %s at steps "
                                 "%s, expected %s" % (
                                     bad[0]["launches"],
                                     [r["step"] for r in bad], PER_STEP))
        if (roi_pool.generic_launches or roi_pool.grad_generic_launches
                or roi_pool.staged_launches != launches["roi_crop_maxpool"]
                or roi_pool.grad_staged_launches
                != launches["roi_crop_maxpool_grad"]):
            raise AssertionError("train_loop: K1 or K2 took the generic "
                                 "kernel")
        seen = {r["canvas"] for r in records}
        if seen != buckets or [r["step"] for r in records] != list(
                range(1, steps + 1)):
            raise AssertionError("train_loop: canvases %s of %s, steps %s" % (
                sorted(seen), sorted(buckets), [r["step"] for r in records]))
        log("train_loop: %d steps in %.2f s through all %d canvas buckets; "
            "launches %s (per step %s, K1 and K2 staged); peak memory %d "
            "bytes" % (steps, wall, len(buckets), json.dumps(launches),
                       json.dumps(PER_STEP), peak))
        fed = report_steps("feed", records, start, t_start, cfg.train_config)
        if profile:
            busy, window = busy_share(os.path.join(model_dir, "profile",
                                                   "trace.json"))
            log("train_loop: profile of steps %d-%d: device busy %.3f ms of "
                "a %.3f ms window, busy share %.4f" % (
                    profile_steps[0] + 1, profile_steps[1], busy, window,
                    busy / window))

        # The same run fed from the same batches, made beforehand: no
        # worker process decodes or resizes while the steps run.
        pipe = pipeline_lib.build_input_pipeline(
            cfg.train_reader, seed=0, label_extractor=(
                extractors.build_label_extractor(
                    cfg.model.cap2det_model.label_extractor)))
        it = iter(pipe)
        try:
            made = [next(it) for _ in range(steps + 2)]
        finally:
            it.close()
        real = (pipeline_lib.build_input_pipeline,
                pipeline_lib.in_worker_process)
        pipeline_lib.build_input_pipeline = lambda *a, **k: made
        pipeline_lib.in_worker_process = lambda pipe, device: pipe
        try:
            _, made_records, start, t_start, _ = run_train(
                torch, trainer, cfg, os.path.join(tmp.name, "made"), steps)
        finally:
            (pipeline_lib.build_input_pipeline,
             pipeline_lib.in_worker_process) = real
        if [r["canvas"] for r in made_records] != [r["canvas"]
                                                   for r in records]:
            raise AssertionError("train_loop: the batches made beforehand "
                                 "are not the feed's")
        made = report_steps("made beforehand", made_records, start, t_start,
                            cfg.train_config)
        log("train_loop: median step on the card's timeline with the feed "
            "%.3f ms, from batches made beforehand %.3f ms (one pair, in "
            "that order)" % (fed["event_ms"], made["event_ms"]))

        saved = snapshot(torch, state)
        del state
        losses = []
        restored = {}
        real_restore = ckpt_lib.CheckpointManager.restore

        def spy(self, state_like=None, step=None):
            out = real_restore(self, state_like, step)
            if out is not None and state_like is not None:
                restored.update(snapshot(torch, out))
            return out

        ckpt_lib.CheckpointManager.restore = spy
        try:
            trainer.train(cfg, model_dir=model_dir, max_steps=steps + 2,
                          hooks=[lambda step, st, logs: losses.append(
                              (step, float(logs["loss/total_loss"])))])
        finally:
            ckpt_lib.CheckpointManager.restore = real_restore
        if restored.get("step") != steps or restored["count"] != steps:
            raise AssertionError("train_loop: restored step %s, expected %d"
                                 % (restored.get("step"), steps))
        for part in ("params", "slots"):
            if restored[part].keys() != saved[part].keys() or not all(
                    torch.equal(v, saved[part][k])
                    for k, v in restored[part].items()):
                raise AssertionError("train_loop: restored %s differ from "
                                     "the saved ones" % part)
        if [s for s, _ in losses] != [steps + 1, steps + 2] or not np.all(
                np.isfinite([v for _, v in losses])):
            raise AssertionError("train_loop: resumed steps %s" % losses)
        log("train_loop: checkpoint at step %d restored bit for bit (%d "
            "params, %d optimizer slots); resumed steps %s; checkpoints %s"
            % (steps, len(saved["params"]), len(saved["slots"]),
               json.dumps(losses),
               [s for s, _ in ckpt_lib.list_checkpoints(model_dir)]))
    finally:
        tmp.cleanup()
    return launches


EVAL_RECORDS = 8
EVAL_SIZES = [(375, 500), (500, 333), (400, 400)]
EVAL_STEPS = (2000, 4000)  # voc07_inc2's save_checkpoints_steps cadence
VOC_TEST_PATTERN = '"output/records/VOC2007_test.record*"'


def write_eval_inputs(directory):
    """Seeded PNG records for the voc07_inc2 eval reader (375x500, 500x333
    and 400x400 images, 2000 proposals, ground-truth texts that are VOC
    class names) and a copy of configs/voc07_inc2.pbtxt reading them.
    Returns the config's path."""
    from cap2det_tpu_torch.data import synthetic, tfrecord

    record = os.path.join(directory, "eval.record")
    rng = np.random.default_rng(SEED + 11)
    with tfrecord.TFRecordWriter(record) as w:
        for i in range(EVAL_RECORDS):
            w.write(synthetic.make_example(
                rng, "eval-%05d" % i, image_hw=EVAL_SIZES[i % 3],
                num_proposals=NUM_PROPOSALS, smooth=True))
    with open(os.path.join("configs", "voc07_inc2.pbtxt")) as f:
        text = f.read()
    if VOC_TEST_PATTERN not in text:
        raise AssertionError("voc07_inc2.pbtxt reads no %s" % VOC_TEST_PATTERN)
    proto = os.path.join(directory, "voc07_inc2_eval.pbtxt")
    with open(proto, "w") as f:
        f.write(text.replace(VOC_TEST_PATTERN, '"%s"' % record))
    return proto


def phase_eval_daemon(torch):
    """The eval daemon at configs/voc07_inc2.pbtxt width (4 scales, P=2000,
    20 classes, 3 OICR iterations, bf16) over two checkpoints written by
    CheckpointManager.save of two seeded TrainStates: one row per
    checkpoint, reports, promotion, launches K1 4x8x2 and K4 12x8x2 with
    no backward kernel, each checkpoint's detections its own; seconds per
    checkpoint and per image, the NMS share and peak memory per
    checkpoint; one image's postprocess card vs CPU bit for bit; then the
    export and evaluate CLIs in a subprocess on the same model_dir.

    Returns the daemon's launches (counts set to 0 just before it)."""
    import tempfile

    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.eval import evaluator
    from cap2det_tpu_torch.kernels import roi_pool
    from cap2det_tpu_torch.models import cap2det, registry
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib
    from cap2det_tpu_torch.train import trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")
    try:
        proto = write_eval_inputs(tmp.name)
        cfg = schema.load_pipeline(proto)
        opts = cfg.model.cap2det_model
        num_scales = len(opts.eval_min_dimension)
        iterations = 1 + opts.oicr_iterations
        model_dir = os.path.join(tmp.name, "model")
        train_model = registry.build(cfg.model, is_training=True)
        manager = ckpt_lib.CheckpointManager(model_dir)
        for seed, step in enumerate(EVAL_STEPS):
            state, _, _, _ = trainer.TrainState.create(
                train_model, cfg.train_config, seed)
            manager.save(step, state)
        del state, train_model
        torch.cuda.empty_cache()
        log("eval_daemon: voc07_inc2, %d scales %s, P=%d, %d OICR "
            "iterations, bf16; %d PNG records %s; checkpoints %s" % (
                num_scales, list(opts.eval_min_dimension),
                cfg.eval_reader.cap2det_reader.max_num_proposals,
                opts.oicr_iterations, EVAL_RECORDS, EVAL_SIZES,
                [s for s, _ in ckpt_lib.list_checkpoints(model_dir)]))

        # Per checkpoint (one run_evaluation each): peak memory; per image:
        # the host-clock time of predict and of its postprocess (NMS),
        # each between synchronisations, and the detections.
        runs = []
        real_run = evaluator.run_evaluation
        real_predict = evaluator.MultiScalePredictor.predict
        real_post = cap2det.Cap2DetModel.postprocess

        def run_evaluation(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runs.append({"images": []})
            out = real_run(*args, **kwargs)
            torch.cuda.synchronize()
            runs[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
            return out

        def predict(self, example):
            runs[-1]["images"].append({"post_s": 0.0})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_predict(self, example)
            torch.cuda.synchronize()
            runs[-1]["images"][-1].update(s=time.perf_counter() - t0, out=out)
            return out

        def postprocess(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_post(self, *args, **kwargs)
            torch.cuda.synchronize()
            runs[-1]["images"][-1]["post_s"] += time.perf_counter() - t0
            return out

        evaluator.run_evaluation = run_evaluation
        evaluator.MultiScalePredictor.predict = predict
        cap2det.Cap2DetModel.postprocess = postprocess
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            best = evaluator.continuous_evaluation(
                cfg, model_dir=model_dir, evaluate_all=True,
                max_idle_polls=0, poll_interval_secs=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
        finally:
            evaluator.run_evaluation = real_run
            evaluator.MultiScalePredictor.predict = real_predict
            cap2det.Cap2DetModel.postprocess = real_post

        want = dict.fromkeys(KERNELS, 0)
        per_run = EVAL_RECORDS * len(EVAL_STEPS)
        want.update(roi_crop_maxpool=num_scales * per_run,
                    pool_fwd=3 * num_scales * per_run)
        if launches != want:
            raise AssertionError("eval_daemon: launches %s, expected %s"
                                 % (launches, want))
        if roi_pool.staged_launches != launches["roi_crop_maxpool"]:
            raise AssertionError("eval_daemon: K1 took the generic kernel "
                                 "(%d of %d launches staged)" % (
                                     roi_pool.staged_launches,
                                     launches["roi_crop_maxpool"]))
        with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if [r["step"] for r in rows] != list(EVAL_STEPS) or len(runs) != 2:
            raise AssertionError("eval_daemon: rows for steps %s"
                                 % [r["step"] for r in rows])
        for step in EVAL_STEPS:
            for ext in ("csv", "html"):
                path = os.path.join(model_dir, "eval_report_%d.%s"
                                    % (step, ext))
                if not os.path.getsize(path):
                    raise AssertionError("eval_daemon: %s is empty" % path)
        key = "iter%d/PascalBoxes_Precision/mAP@0.5IOU" % opts.oicr_iterations
        maps = [r[key] for r in rows]
        winner = EVAL_STEPS[1] if maps[1] > maps[0] else EVAL_STEPS[0]
        with open(os.path.join(model_dir, "saved_ckpts",
                               "saved_info.txt")) as f:
            saved_step = int(f.read().split("\t")[0])
        if saved_step != winner or best[0] not in EVAL_STEPS:
            raise AssertionError("eval_daemon: saved_info names step %d, "
                                 "final-iteration mAPs %s" % (saved_step,
                                                              maps))
        for a, b in zip(runs[0]["images"], runs[1]["images"]):
            for it in range(iterations):
                out = a["out"]
                n = int(out["num_detections_at_%d" % it])
                cls = out["detection_classes_at_%d" % it]
                if n < 1 or not np.all((cls[:n] >= 1) & (cls[:n] <= 20)):
                    raise AssertionError("eval_daemon: bad detections")
            if all(np.array_equal(a["out"][k], b["out"][k])
                   for k in a["out"] if k.startswith("detection_")):
                raise AssertionError("eval_daemon: checkpoint %d detects as "
                                     "checkpoint %d on %s" % (
                                         EVAL_STEPS[1], EVAL_STEPS[0],
                                         a["out"]["image_id"]))
        for r in rows:
            if not r["num_examples"] == EVAL_RECORDS or np.isnan(r[key]):
                raise AssertionError("eval_daemon: row %s" % r)
        for step, row, run in zip(EVAL_STEPS, rows, runs):
            image_s = [i["s"] for i in run["images"]]
            post_s = [i["post_s"] for i in run["images"]]
            log("eval_daemon: " + json.dumps({
                "step": step,
                "seconds_per_checkpoint": row["eval/seconds_per_checkpoint"],
                "median_seconds_per_image": float(np.median(image_s)),
                "median_postprocess_s": float(np.median(post_s)),
                "postprocess_share": sum(post_s) / sum(image_s),
                "peak_memory_bytes": run["peak_bytes"],
                "mAP_per_iteration": [
                    row["iter%d/PascalBoxes_Precision/mAP@0.5IOU" % i]
                    for i in range(iterations)],
                "samples_s": image_s}))
        log("eval_daemon: %d checkpoints in %.2f s; launches %s (K1 staged); "
            "promoted step %d; best %s" % (len(rows), wall,
                                           json.dumps(launches), saved_step,
                                           json.dumps(best)))

        # The CLIs, each in its own process on the card.
        export_json = os.path.join(tmp.name, "detections.json")
        for argv in (["cap2det_tpu_torch.cli.export_main",
                      "--output_json", export_json],
                     ["cap2det_tpu_torch.cli.evaluate_main", "--run_once"]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", argv[0], "--pipeline_proto", proto,
                 "--model_dir", model_dir] + argv[1:],
                capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise AssertionError("eval_daemon: %s exited %d:\n%s" % (
                    argv[0], proc.returncode, proc.stderr[-4000:]))
            log("eval_daemon: %s ran in %.1f s" % (
                argv[0], time.perf_counter() - t0))
        with open(export_json) as f:
            exported = json.load(f)
        if len(exported) != EVAL_RECORDS or any(
                set(v) != {"detection_boxes", "detection_scores",
                           "detection_classes"} for v in exported.values()):
            raise AssertionError("eval_daemon: export wrote %s" % (
                {k: sorted(v) for k, v in exported.items()}))
        with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f]
        if steps != list(EVAL_STEPS) + [EVAL_STEPS[-1]]:
            raise AssertionError("eval_daemon: after --run_once, rows for "
                                 "steps %s" % steps)
        log("eval_daemon: export_main wrote %d images' detections; "
            "evaluate_main --run_once evaluated step %d" % (
                len(exported), steps[-1]))
        # One image: the card's averaged scores, postprocessed on the CPU,
        # give the card's detections bit for bit.
        out = runs[0]["images"][0]["out"]
        cpu_model = registry.build(cfg.model, device="cpu")
        host = cpu_model.postprocess(
            {k: torch.from_numpy(v) for k, v in out["proposal_scores"].items()},
            torch.from_numpy(out["proposals"])[None],
            torch.tensor([out["num_proposals"]], dtype=torch.int32))
        differ = {}
        for k, v in host.items():
            diff = np.abs(v[0].numpy().astype(np.float64)
                          - out[k].astype(np.float64))
            if (diff > 0).any():
                differ[k] = {"values": int((diff > 0).sum()),
                             "of": diff.size, "max_abs": float(diff.max())}
        if differ:
            raise AssertionError("eval_daemon: the postprocess on the CPU "
                                 "differs from the card's: %s"
                                 % json.dumps(differ))
        log("eval_daemon: postprocess of %s on the CPU equals the card's bit "
            "for bit (%s)" % (out["image_id"], json.dumps(
                {k: int(out[k]) for k in out if k.startswith("num_det")})))
    finally:
        tmp.cleanup()
    return launches


def phase_overfit_map(torch):
    """tests/test_e2e_map.py's overfit run on the card
    (cap2det_tpu_torch/tools/overfit_map.py): passthrough warm start,
    train() for 300 steps at batch 8, then the daemon's mAP >= 0.5 at
    step 300. Prints the launches of training and of evaluation (both
    backbone scopes train with multiplier 0)."""
    import tempfile

    from cap2det_tpu_torch.kernels import roi_pool
    from cap2det_tpu_torch.tools import overfit_map

    trained = {}

    def hook(step, state, logs):
        if step == overfit_map.STEPS:
            trained.update(launch_counts())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_overfit_") as tmp:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = overfit_map.run(tmp, device="cuda", hooks=[hook])
        wall = time.perf_counter() - t0
        launches = launch_counts()
    overfit_map.check(result)
    evaluated = {k: launches[k] - trained[k] for k in KERNELS}
    log("overfit_map: " + json.dumps({
        "steps": len(result["losses"]), "first_loss": result["losses"][0],
        "last_loss": result["losses"][-1], "best": result["best"],
        "mAP_per_iteration": result["map_per_iter"],
        "train_s": result["train_s"], "eval_s": result["eval_s"],
        "wall_s": wall, "train_launches": trained,
        "eval_launches": evaluated,
        "K1_staged": roi_pool.staged_launches,
        "K1_generic": roi_pool.generic_launches}))
    log("overfit_map: K2 %s in training" % (
        "launched %d times" % trained["roi_crop_maxpool_grad"]
        if trained["roi_crop_maxpool_grad"] else "did not launch"))
    if min(evaluated["roi_crop_maxpool"], evaluated["pool_fwd"]) < 1:
        raise AssertionError("overfit_map: the daemon launched %s"
                             % evaluated)


def main(argv):
    import torch

    profile = "--profile" in argv

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    # float32 comparisons on the card run in full float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))

    t0 = time.perf_counter()
    phase_build()
    k1 = phase_roi(torch)
    k4 = phase_pool(torch)
    phase_serve(torch, profile)
    k2 = phase_roi_grad(torch)
    k5, k6 = phase_pool_grad(torch)
    coco = phase_train(
        torch, "coco17_extend_match.pbtxt", batch_size=2, num_p=TRAIN_P,
        warmup=3, timed=12, breakdown=True,
        want={"roi_crop_maxpool": 1, "pool_fwd": 3,
              "roi_crop_maxpool_grad": 1, "maxpool_grad": 2,
              "avgpool_grad": 1})
    torch.cuda.empty_cache()
    # Full first-stage freeze: the ROIs need no gradient, so neither K2
    # nor Mixed_5a's pool backward runs.
    phase_train(
        torch, "voc07_inc2.pbtxt", batch_size=1, num_p=2000, warmup=2,
        timed=5, breakdown=False,
        want={"roi_crop_maxpool": 1, "pool_fwd": 3,
              "roi_crop_maxpool_grad": 0, "maxpool_grad": 1,
              "avgpool_grad": 1})
    torch.cuda.empty_cache()
    phase_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    launches = phase_train_loop(torch, profile)
    torch.cuda.empty_cache()
    eval_launches = phase_eval_daemon(torch)
    torch.cuda.empty_cache()
    phase_overfit_map(torch)
    log("chip_smoke: all phases passed in %.1f s" % (time.perf_counter() - t0))
    log("chip_smoke: the eval daemon's launches (two checkpoints) %s"
        % json.dumps(eval_launches))

    # Launches: the train() run of the train_loop phase, the main path,
    # which runs all five (the coco17 step phase does too).
    if min(launches.values()) < 1 or min(coco["launches"].values()) < 1:
        raise AssertionError("a kernel did not run in training: %s, %s"
                             % (launches, coco["launches"]))
    rows = [
        ("roi_crop_maxpool", "roi_pool.cu", "roi_pool.py:1213", k1),
        ("pool_fwd", "pool.cu", "pool_grad.py:350", k4),
        ("roi_crop_maxpool_grad", "roi_pool_bwd.cu", "roi_pool.py:1458", k2),
        ("maxpool_grad", "pool_grad.cu", "pool_grad.py:418", k5),
        ("avgpool_grad", "pool_grad.cu", "pool_grad.py:235", k6),
    ]
    kernels = [
        {"name": name, "route": "cuda",
         "source": "cap2det_tpu_torch/csrc/" + source,
         "replaces": "cap2det_tpu/kernels/" + replaces,
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms")}
        for name, source, replaces, r in rows
    ]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
