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
     float32 scores on the card against the same scale run on the CPU.

``python3 chip_smoke.py --profile`` also reads one image's device kernel
time and busy share with torch.profiler.

The last lines are a {"kernels": [...]} JSON line, the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": ...}.
Exits nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def compare(torch, got, want, dtype_name):
    rtol, atol = TOL[dtype_name]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return float((got.float() - want.float()).abs().max())


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


def _synthetic_example(rng, hw, image_id):
    h, w = hw
    # Smooth seeded image: low-frequency color fields plus noise.
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([np.sin(6 * yy + p) * np.cos(4 * xx - p)
                     for p in rng.uniform(0, 6, 3)], -1)
    image = np.clip(127 + 80 * base + rng.normal(0, 20, (h, w, 3)), 0, 255)
    boxes = make_boxes(rng, NUM_PROPOSALS, num_pad=0)
    return {"image": image.astype(np.uint8), "image_id": image_id,
            "proposals": np.clip(boxes, 0.0, 1.0)}


def phase_breakdown(torch, model, predictor, example, profile):
    """Where one image's time goes: CUDA events around the first stage,
    the ROI kernel, the second stage (the pool kernel inside it apart)
    and the postprocess (NMS), all four scales summed; "other" is the
    rest of the host-clock wall time (resize, preprocess, heads, copies,
    launch gaps). With ``profile``, torch.profiler also reads the device
    kernel time of one more image, whose share of the wall time is the
    device's busy share."""
    import types

    from cap2det_tpu_torch.kernels import pool_grad, roi_pool
    from cap2det_tpu_torch.models import inception_v2

    spans = {}

    def wrap(owner, name, label):
        real = getattr(owner, name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kwargs)
            end.record()
            spans.setdefault(label, []).append((start, end))
            return out

        setattr(owner, name, timed)
        return owner, name, real

    patched = [
        wrap(inception_v2, "first_stage", "first_stage"),
        wrap(roi_pool, "roi_crop_maxpool", "roi_crop_maxpool"),
        wrap(inception_v2, "second_stage", "second_stage"),
        wrap(pool_grad, "pool_fwd", "pool_fwd (inside second_stage)"),
        wrap(model, "postprocess", "postprocess (NMS)"),
    ]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict(example)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, name, real in patched:
            if isinstance(owner, types.ModuleType):
                setattr(owner, name, real)
            else:
                delattr(owner, name)
    ms = {label: sum(a.elapsed_time(b) for a, b in pairs)
          for label, pairs in spans.items()}
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
    roi_pool.launches = 0
    pool_grad.launches = 0
    outs = [predictor.predict(ex) for ex in examples]
    torch.cuda.synchronize()
    launches = {"roi_crop_maxpool": roi_pool.launches,
                "pool_fwd": pool_grad.launches}
    log("serve: launches %s" % json.dumps(launches))
    want = {"roi_crop_maxpool": num_scales * len(examples),
            "pool_fwd": 3 * num_scales * len(examples)}
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
    launches = phase_serve(torch, profile)
    log("chip_smoke: all phases passed in %.1f s" % (time.perf_counter() - t0))

    kernels = [
        {"name": "roi_crop_maxpool", "route": "cuda",
         "source": "cap2det_tpu_torch/csrc/roi_pool.cu",
         "replaces": "cap2det_tpu/kernels/roi_pool.py:1213",
         "launches": launches["roi_crop_maxpool"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "pool_fwd", "route": "cuda",
         "source": "cap2det_tpu_torch/csrc/pool.cu",
         "replaces": "cap2det_tpu/kernels/pool_grad.py:350",
         "launches": launches["pool_fwd"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["kernel_ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": k4["library_ms"]},
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
