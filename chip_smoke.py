#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (cap2det_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):
  1. build the hand-written CUDA kernels from cap2det_tpu_torch/csrc;
  2. hold the ROI crop+pool kernel (K1) against its plain PyTorch version
     at the serving shapes, in bfloat16 and float32;
  3. hold the SAME pool kernel (K4) against its plain version at the
     three second-stage shapes, in bfloat16 and float32;
  4. serve 3 seeded images (landscape, portrait, square; 2000 proposals
     each) through MultiScalePredictor.predict at the full width of the
     configs/voc07_inc2.pbtxt model (4 scales, 20 classes, 3 OICR
     iterations) with seeded random weights, check the launch counters
     and the detections, time 12 images (median and spread) and one image
     by layer, and hold one scale's
     float32 scores on the card against the same scale run on the CPU;
  5. hold the ROI backward kernel (K2) against its plain version at the
     coco17 training shape (features [2, 64, 96, 576], P=500), in
     bfloat16 and float32, also on tie-rich quantised features, and
     measure its run-to-run difference (float32 atomics);
  6. hold the max-pool (K5) and avg-pool (K6) backward kernels against
     their plain versions at the three second-stage training shapes
     (N=1000), in bfloat16 and float32, K5 also on tie-rich input;
  7. train at configs/coco17_extend_match.pbtxt width (batch 2, 1024x1536
     canvases, P=500, 80 classes, Mixed_4e unfrozen, Adagrad): 3 warm-up
     and 12 timed steps, launch counts per step, finite losses, frozen
     leaves unchanged, a one-step breakdown by span, peak memory;
  8. train under the full first-stage freeze of configs/voc07_inc2.pbtxt
     (batch 1, P=2000, 20 classes): no ROI backward launches;
  9. one float32 training step at 256x384, P=64 on the card and on the
     CPU from the same params and batch: loss, head gradients and updated
     head params agree.

``python3 chip_smoke.py --profile`` also reads one image's device kernel
time and busy share with torch.profiler.

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
TRAIN_P = 500
TRAIN_POOL_SHAPES = [  # (name, kind, kernel, stride, [N, H, W, C])
    ("Mixed_5a max 3/s2", "pool_max", 3, 2, (1000, 7, 7, 576)),
    ("Mixed_5b avg 3/s1", "pool_avg", 3, 1, (1000, 4, 4, 1024)),
    ("Mixed_5c max 3/s1", "pool_max", 3, 1, (1000, 4, 4, 1024)),
]
# Per pooled K2 cell: 4 samples of 3 lerps (9 float32 operations), 4
# compares, then 2 + 4 products and 4 adds into dF.
ROI_GRAD_OPS_PER_CELL = 4 * 9 + 4 + 6 + 4
# K2 against its plain version: the same terms of size ~1 added into each
# dF value in another order (atomics on the card, index_add_ there).
GRAD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1.6e-2, 1e-4)}
KERNELS = ("roi_crop_maxpool", "pool_fwd", "roi_crop_maxpool_grad",
           "maxpool_grad", "avgpool_grad")


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


def reset_launch_counts():
    from cap2det_tpu_torch.kernels import pool_grad, roi_pool

    roi_pool.launches = roi_pool.grad_launches = 0
    pool_grad.launches = pool_grad.maxpool_grad_launches = 0
    pool_grad.avgpool_grad_launches = 0


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


def span_ms(spans):
    return {label: sum(a.elapsed_time(b) for a, b in pairs)
            for label, pairs in spans.items()}


def make_boxes(rng, num_p, num_pad):
    """Seeded proposals: wide, narrow, partly outside the map, and zero
    padding boxes at the end."""
    n = num_p - num_pad
    kind = rng.integers(0, 3, n)
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
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            feats = feats32.to(dtype)
            got = roi_pool.roi_crop_maxpool(feats, boxes, 14, 2, 2)
            want = roi_ops.crop_resize_maxpool(feats, boxes, 14, 2, 2)
            torch.cuda.synchronize()
            err = compare(torch, got, want, name)
            line = {"kernel": "roi_crop_maxpool", "P": num_p, "dtype": name,
                    "max_abs_err": err, "tol(rtol,atol)": TOL[name]}
            if num_p == NUM_PROPOSALS:
                nbytes = (feats.numel() * feats.element_size()
                          + boxes.numel() * 4
                          + got.numel() * got.element_size())
                b_ms, b_by = bound_ms(nbytes, ROI_OPS_PER_OUTPUT * got.numel())
                line.update(
                    kernel_ms=cuda_ms(torch, lambda: roi_pool.roi_crop_maxpool(
                        feats, boxes, 14, 2, 2), iters=20),
                    plain_ms=cuda_ms(torch, lambda: roi_ops.crop_resize_maxpool(
                        feats, boxes, 14, 2, 2), iters=3, warmup=1),
                    bound_ms=b_ms, bound_by=b_by)
                if dtype == torch.bfloat16:
                    result = line
            log(json.dumps(line))
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
    result = {"max_abs_err": 0.0, "run_to_run": {}}
    first = roi_pool.grad_launches
    for case, base in (("normal", normal), ("ties {0,1,2}", ties)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            feats, grad = base.to(dtype), grad32.to(dtype)
            got = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2, 2)
            want = roi_ops.crop_resize_maxpool_grad(feats, boxes, grad, 14,
                                                    2, 2)
            again = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2,
                                                   2)
            torch.cuda.synchronize()
            err = compare(torch, got, want, name, GRAD_TOL)
            run_to_run = float((got.float() - again.float()).abs().max())
            result["max_abs_err"] = max(result["max_abs_err"], err)
            result["run_to_run"]["%s %s" % (case, name)] = run_to_run
            line = {"kernel": "roi_crop_maxpool_grad", "case": case,
                    "dtype": name, "max_abs_err": err,
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
                result.update({k: line[k] for k in (
                    "kernel_ms", "plain_ms", "bound_ms", "bound_by")})
            log(json.dumps(line))
    log("roi_crop_maxpool_grad: %d launches in this phase (checks and "
        "timing)" % (roi_pool.grad_launches - first))
    return result


def phase_pool_grad(torch):
    """K5 and K6 against their plain versions at the training shapes."""
    import torch.nn.functional as F

    from cap2det_tpu_torch.kernels import pool_grad

    rng = np.random.default_rng(SEED + 5)
    first = (pool_grad.maxpool_grad_launches, pool_grad.avgpool_grad_launches)
    totals = {}
    for label, kind, k, s, shape in TRAIN_POOL_SHAPES:
        name_k = "maxpool_grad" if kind == "pool_max" else "avgpool_grad"
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
                err = compare(torch, got, want, name)
                line = {"kernel": name_k, "shape": label, "case": case,
                        "dtype": name, "max_abs_err": err,
                        "tol(rtol,atol)": TOL[name]}
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
                        plain_ms=cuda_ms(torch, plain, iters=10),
                        library_ms=cuda_ms(torch, lib, iters=50),
                        bound_ms=b_ms, bound_by=b_by)
                    for key in ("kernel_ms", "plain_ms", "library_ms",
                                "bound_ms"):
                        total[key] += line[key]
                    total["bound_by"].add(b_by)
                log(json.dumps(line))
    for total in totals.values():
        total["bound_by"] = "/".join(sorted(total["bound_by"]))
    log("maxpool_grad, avgpool_grad: %d and %d launches in this phase "
        "(checks and timing)" % (pool_grad.maxpool_grad_launches - first[0],
                                 pool_grad.avgpool_grad_launches - first[1]))
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
    if not np.all(np.isfinite(losses)):
        raise AssertionError("train %s: non-finite loss %s" % (tag, losses))
    log("train %s: launches over %d steps %s (per step %s)" % (
        tag, timed, json.dumps(launches), json.dumps(want)))
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
        with cuda_spans(torch, targets) as spans:
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
    # convolutions, and K2's atomics against index_add_.
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
    log("chip_smoke: all phases passed in %.1f s" % (time.perf_counter() - t0))

    # Launches: the coco17 training run (12 steps), which runs all five.
    launches = coco["launches"]
    if min(launches.values()) < 1:
        raise AssertionError("a kernel did not run in training: %s"
                             % launches)
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
