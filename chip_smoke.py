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
     (4 NMS launches an image, one per iteration) and the detections,
     hold the card's canvases to the CPU's bit for bit, time 12 images
     (median and spread) and one image by layer, and hold one scale's
     float32 scores on the card against the same scale run on the CPU;
 4a. nms: hold the NMS kernels (csrc/nms.cu, one call per
     batch_multiclass_nms call for every image and class: the overlap
     bits, then a warp per (image, class) walking them) against their
     plain version (ops/nms._per_image_nms) on the card, bit for bit on
     the mask and on all four outputs: voc07's [1, 2000, 20] with 1500
     valid proposals, coco17's eval [1, 500, 80] and B=2, under both
     shipped threshold pairs (MIDN iou 0.4, OICR 0.3), a binding cap, no
     candidate, tied scores, and the serve phase's real scores (every
     iteration of its three images); each stage alone against its plain
     version (the overlap bits against plain_overlap_bits, the walk over
     them against plain_walk); each case's walk (ranks walked,
     survivors and groups of 32 ranks, mean and largest over classes)
     and the mask's scratch bytes and pair tests; the kernels from a CUDA
     graph (both, and each stage alone), host-launched, through their
     wrapper and the plain version timed by CUDA events beside the
     bound, and one image's postprocess with the kernels and with the
     plain version, each with its time and the memory it needs;
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
  6a. fused_optimizer: hold the fused optimizer kernel
     (csrc/fused_optimizer.cu, one launch over every trainable leaf, two
     with per-leaf clipping) against its plain flat version at the
     trainable sets of coco17_extend_match (62 leaves, 7,417,427 params)
     and voc07_inc2 (48, 6,002,951), its gradients channels-last where a
     convolution's are, for sgd, adagrad, adam, rmsprop (plain, centered
     with momentum), momentum and nesterov, with and without clipping,
     over 10 chained updates: bit for bit without clipping, within
     FUSED_CLIP_ULPS of each leaf's scale with it (the norm's sum order);
     the shipped update (Adagrad) timed from a CUDA graph and from the
     host beside its byte bound, the plain flat version and the per-leaf
     chain;
  6b. bn_fold: hold the BN fold kernels (csrc/bn_fold.cu: one launch
     folds every convolution of both stages into its bf16 or float32
     weight and bias, one more gives the trainable leaves' gradients)
     against the per-convolution chain (bn_fold.fold_reference and
     autograd through it) at the trees and trainable sets of
     coco17_extend_match, voc07_inc2 and the benchmark's
     coco17_resnet101 (104 convolutions with gammas, epsilon 1e-5;
     the gammas' gradients too) with seeded BN statistics, bit
     for bit with the same strides, one launch each; two steps of each
     InceptionV2 regime with the kernels against the chain under
     deterministic cuDNN, bit for bit; each set's fold and its backward
     timed from a CUDA graph and from the host beside the byte bound and
     the chain;
  7. train at configs/coco17_extend_match.pbtxt width (batch 2, 1024x1536
     canvases, P=500, 80 classes, Mixed_4e unfrozen, Adagrad): 3 warm-up
     and 12 timed steps, launch counts per step, finite losses, frozen
     leaves unchanged, a one-step breakdown by span, peak memory;
  8. train under the full first-stage freeze of configs/voc07_inc2.pbtxt
     (batch 1, P=2000, 20 classes): no ROI backward launches;
 8a. train ResNet-101 at the benchmark's coco17_resnet101 (batch 2,
     1024x1536, P=500, 80 classes, block3 and block4 trainable; the
     root's and each conv3's gammas scaled down, scale_resnet_gammas): per
     step K1 1, K2 1, the fold 1 each way, the fused optimizer 4 (250
     trainable leaves) and no pool kernel;
  9. bench: the measuring tools on the card, each a process of its own
     (python -m cap2det_tpu_torch.bench --shape bench, --shape inc2,
     --e2e; tools.bench_eval --examples 8; tools.profile_step --steps
     8 --convs; tools.bench_components; tools.bench_backbone_parts;
     tools.bench_opt_ab --variant both, the fused optimizer against the
     per-leaf chain in turns),
     their JSON lines printed and checked: every number finite, mfu in
     (0, 1], the launches per step of phases 7 and 8 (and of train()
     under --e2e), the card's name and power limit on every line,
     bench's step_ms against phase 7's median (within both spreads,
     or the difference printed with them), profile_step's device ms
     per step at most bench's step_ms, its busy share and longest idle
     gaps (each with the host operations around it) and its conv
     table, and bench_eval's NMS share of predict in (0, 1);
  9a. second_stage_remat: the bench's step (cap2det_tpu_torch.bench.
     BenchStep) with the second stage recomputed in the backward
     (second_stage_remat=True) against kept, at the bench shape (batch 2,
     P=500, Mixed_4e trainable), inc2 (batch 1, P=2000, full freeze) and
     inc2 at batch 8, under deterministic cuDNN: a second plain arm
     first (its loss, gradients and updated params equal the plain
     arm's, bit for bit), then remat against plain, bit for bit; each
     arm's launches in its first step are bench.LAUNCHES's; each arm's
     peak memory over one step, lower with remat at inc2 batch 8; the
     step in 4 alternating turns of 8 (CUDA events); each arm's device
     ms a step (torch.profiler over 4 steps; a trace without device
     events fails the run);
 10. one float32 training step at 256x384, P=64 on the card and on the
     CPU from the same params and batch: loss, head gradients and updated
     head params agree; dropout's x / 0.7 and the mean over 3 eval scales
     equal the CPU's quotients bit for bit;
 11. train_loop: train() from PNG TFRecords written here, at
     configs/coco17_extend_match.pbtxt as shipped, through all eight
     canvas buckets (1216x1824 ... 416x608, both orientations), launches
     per step K1 1, K4 3, K2 1, K5 2, K6 1 and the fused optimizer 1,
     per-bucket step and feed-wait medians, the feed's record reader (the
     host library's) and its first step's wait, peak memory; a second train() restores the final checkpoint
     bit for bit and trains on. Also says whether Pillow imports;
 12. eval_daemon: continuous_evaluation(evaluate_all=True) at
     configs/voc07_inc2.pbtxt width (4 scales, P=2000, 20 classes, 3 OICR
     iterations, bf16) over 8 PNG records and two checkpoints of seeded
     TrainStates: one eval_metrics.jsonl row per checkpoint, oldest first,
     the CSV and HTML reports, promotion of the better final-iteration
     mAP, launches K1 64, K4 192, NMS 64 (K1 staged) and the BN fold 2 (one
     a checkpoint) and no backward kernel,
     the second checkpoint's detections not the first's; seconds per
     checkpoint and per image, the NMS share, peak memory; one image's
     postprocess on the CPU equals the card's bit for bit; then
     export_main and evaluate_main --run_once in a subprocess;
 13. overfit_map: tests/test_e2e_map.py's run on the card
     (cap2det_tpu_torch/tools/overfit_map.py): passthrough warm start, 300
     train() steps, the daemon's final mAP >= 0.5 at step 300;
 14. text_model: configs/coco17_text.pbtxt as shipped (data/
     coco_open_vocab.txt with a seeded [7379, 300] stand-in for its GloVe
     table, hidden 400, 80 classes, batch 20, dropout 0.5) over 400 seeded
     text-only records: train() for 300 steps, three checkpoints, then
     continuous_evaluation over them; no kernel launches but the fused
     optimizer's, one a step; step times, the
     feed's wait, peak memory, the loss falling, P/R and seconds per
     checkpoint; card vs CPU float32 logits of one batch, and the
     dropout's division by 0.5 and 0.7 bit for bit;
 15. text_cap2det: Cap2Det train() at
     configs/coco17_text_classifier_match.pbtxt as shipped, its text
     classifier warm-started from phase 14's model_dir, over train_loop's
     records plus records whose captions name only synonyms: launches per
     step K1 1, K4 3, K2 1, K5 2, K6 1, the fused optimizer 1, through at
     least two canvas
     buckets, step medians, peak memory, the images labelled beyond an
     exact match, the extractor's labels on the card against the CPU's
     (every flip with its margin); then a few steps of
     configs/coco17_word_vector_match.pbtxt;
 16. data_parallel: coco17_extend_match at full width on two ranks of a
     torch.distributed group on the one card (gloo), each a spawned
     process: (a) one float32 step, dropout off, on each rank's half of a
     seeded global batch of 4 against this process's step on the whole
     batch (params, Adagrad accumulators, loss), launches per rank K1 1,
     K4 3, K2 1, K5 2, K6 1, the fused optimizer 1, the kernels built by
     both ranks at once from
     a clean directory, step times with and without the all-reduce and
     its bytes; (b) a group of one in NCCL steps as no group, bit for
     bit; (c) train() over train_loop's records on two ranks: launches
     per step, step medians, checkpoints and metrics from rank 0 only,
     peak memory.

 17. dataset_build: the README's quick start from cap2det_tpu_torch
     alone: 12 seeded 480x640 rich scenes as JPEG
     (tools/make_rich_synthetic_dataset.py) in a COCO layout naming COCO
     classes; selective search in two processes
     (tools/create_selective_search_data.py over the host C++ library
     built from csrc/host/), one image run again for the same bytes,
     seconds per image on the host, proposals and recall@0.5 of the top
     500 and 2000; COCO TFRecords in 2 shards read back; the vocabulary
     over a stand-in GloVe file; the passthrough backbone; the committed
     TensorFlow V1 and V2 fixtures converted with no tensorflow imported;
     train() at configs/coco17_extend_match.pbtxt for 12 steps over those
     records from the passthrough backbone (launches per step K1 1, K4 3,
     K2 1, K5 2, K6 1, the fused optimizer 1, step medians, peak memory);
     one COCO evaluation of
     its last checkpoint; then the three dataset builders
     (python -m cap2det_tpu_torch.scripts.build_{coco,voc,flickr30k}_dataset,
     two selective-search processes each, each from a working directory
     of its own) over layouts of those scenes (COCO with a val2017 beside
     train2017, VOC2007 and Flickr30k of 4 scenes each): their .npy files
     and vocabularies byte for byte, and their records as a multiset of
     record bytes, against the tools run by hand with the shell scripts'
     flags; each builder's wall time and seconds per image on the host;
 18. configs: the four configs no other phase steps
     (coco17_exact_match, coco17_groundtruth, voc07_groundtruth,
     flickr30k_text_classifier_match, the last with a stand-in table and
     a text classifier checkpoint written here) take two steps each at
     their shipped widths from a seeded batch; each keeps Mixed_4e
     trainable, so every step launches K1 1, K4 3, K2 1, K5 2, K6 1 and
     the fused optimizer 1;
     losses, step times, peak memory;
 19. scripts: python -m cap2det_tpu_torch.scripts.quality_run at a cut
     size (24 scenes, 500 steps, selective search in 4 processes) on the
     card, its curve finite at steps 250 and 500 and its trainer's
     launches those of the full first-stage freeze every step; then
     scripts.train (the trainer and the eval daemon side by side on the
     card) over the same records, 600 steps, a checkpoint every 50 and
     3 kept: exit code 0, the checkpoints the daemon evaluated (at least
     one begun while the trainer stepped) and its lag behind the newest
     in steps and seconds, and no process of either left behind.

Phases 2 and 5 also hold K1 and K2 at the largest coco17 training bucket
(features [2, 76, 114, 576], P=500) and at ResNet-101's 1024-channel
block3 maps of the 1024x1536 and 1216x1824 canvases.

``python3 chip_smoke.py --profile`` also reads one image's device kernel
time and busy share with torch.profiler, and the training step's busy
share from a trace of train_loop's steps.

The kernels line's bn_fold and bn_fold_grad rows give coco17's fold and
its backward replayed from a CUDA graph as "ms", the training step's
launches of each; bn_fold.resnet101 and bn_fold_grad.resnet101 give
ResNet-101's, with phase 8a's launches a step.

The kernels line's fused_optimizer row gives the kernel's time replayed
from a CUDA graph as "ms" (launched from the host, the wrapper's Python
checks of 62 leaves take longer than the kernel; both are printed). Its
nms row gives one call's two kernels at the serve shape replayed from a
CUDA graph, the mean of an image's four (the order made beforehand; the
host-launched time is printed beside), and the serve phase's launches; a
training step launches no NMS, which the training checks require.

The last lines are a {"kernels": [...]} JSON line, the card's name and
power limit as nvidia-smi reports them, and {"ok": true, "device": ...}.
Exits nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

from cap2det_tpu_torch.tools.benchlib import (
    busy_share, card_name_and_limit, cuda_ms, device_ms, host_cpu)

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
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
             ("train coco17 1216x1824", (2, 76, 114, 576), 500),
             # ResNet-101's block3 maps, 1024 channels.
             ("train resnet101", (2, 64, 96, 1024), 500),
             ("train resnet101 1216x1824", (2, 76, 114, 1024), 500)]
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
# K2's further training maps, each held like the largest coco17 one:
# (label, features).
K2_MORE_SHAPES = [
    ("train coco17 1216x1824", TRAIN_LARGEST_FEATURE_SHAPE),
    ("train resnet101", (2, 64, 96, 1024)),  # ResNet-101's block3 maps
    ("train resnet101 1216x1824", (2, 76, 114, 1024)),
]
# coco17_resnet101, the benchmark's configuration (ResNet-101 at the
# coco17_extend_match shape: block3 and block4 trainable, no pools in the
# second stage), and its launches per training step.
RESNET_CONFIG = os.path.join("benchmark", "configs", "coco17_resnet101.json")
RESNET_PER_STEP = {"roi_crop_maxpool": 1, "pool_fwd": 0,
                   "roi_crop_maxpool_grad": 1, "maxpool_grad": 0,
                   "avgpool_grad": 0, "fused_optimizer": 4, "nms": 0,
                   "bn_fold": 1, "bn_fold_grad": 1}  # 250 trainable leaves
TRAIN_P = 500
TRAIN_POOL_SHAPES = [  # (name, kind, kernel, stride, [N, H, W, C])
    ("Mixed_5a max 3/s2", "pool_max", 3, 2, (1000, 7, 7, 576)),
    ("Mixed_5b avg 3/s1", "pool_avg", 3, 1, (1000, 4, 4, 1024)),
    ("Mixed_5c max 3/s1", "pool_max", 3, 1, (1000, 4, 4, 1024)),
]
# The same pools at voc07_inc2's B*P = 2000 (batch 1, P=2000).
VOC_POOL_SHAPES = [(name + " N=2000", kind, k, s, (2000,) + shape[1:])
                   for name, kind, k, s, shape in TRAIN_POOL_SHAPES]
# K2 against its plain version: the same terms of size ~1 added into each
# dF value, in 64-bit fixed point on the card and in float32 with
# index_add_ there.
GRAD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1.6e-2, 1e-4)}
KERNELS = ("roi_crop_maxpool", "pool_fwd", "roi_crop_maxpool_grad",
           "maxpool_grad", "avgpool_grad", "fused_optimizer", "nms",
           "bn_fold", "bn_fold_grad")
# train() steps of the train_loop phase: enough for its seeded stream to
# reach all eight coco17 canvas buckets.
TRAIN_LOOP_STEPS = 40


def log(msg):
    print(msg, flush=True)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(torch, got, want, dtype_name, tol=TOL):
    rtol, atol = tol[dtype_name]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return float((got.float() - want.float()).abs().max())


def launch_counts():
    from cap2det_tpu_torch import kernels

    return kernels.launch_counts()


POOL_GRAD_PATHS = ("maxpool_grad_tiled_launches",
                   "maxpool_grad_untiled_launches",
                   "avgpool_grad_tiled_launches",
                   "avgpool_grad_untiled_launches")


def reset_launch_counts():
    from cap2det_tpu_torch.kernels import (bn_fold, fused_optimizer, nms,
                                           pool_grad, roi_pool)

    fused_optimizer.launches = nms.launches = 0
    bn_fold.launches = bn_fold.grad_launches = 0
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
                    lambda: roi_ops.crop_resize_maxpool(
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
            b_ms, b_by = bound_ms(nbytes, roi_pool.forward_flops(
                *boxes.shape[:2], shape[-1], 14, 2, 2))
            positions = footprint_positions(torch, boxes, *shape[1:3], 14)
            line = {"kernel": "roi_crop_maxpool", "shape": label,
                    "features": list(shape), "P": num_p, "boxes": box_set,
                    "max_abs_err_exact": 0.0, "max_abs_err": err,
                    "kernel_ms": cuda_ms(lambda: roi_pool.
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
                b_ms, b_by = bound_ms(nbytes, pool_grad.pool_fwd_flops(
                    shape, kind, k, s))
                line.update(
                    kernel_ms=cuda_ms(lambda: pool_grad.pool_fwd(
                        x, kind, k, s), iters=50),
                    plain_ms=cuda_ms(lambda: pool_grad.pool_same_plain(
                        x, kind, k, s), iters=20),
                    library_ms=cuda_ms(lib, iters=50),
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
                pool_fwd=3 * num_scales * len(examples),
                nms=(1 + opts.oicr_iterations) * len(examples))
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
    return launches, model, outs


NMS_OUTPUTS = ("num_detections", "detection_boxes", "detection_scores",
               "detection_classes")
NMS_TIMED = 50  # kernel launches per timing
NMS_PLAIN_TIMED = 2  # plain passes per timing (a Python loop over P ranks)
NMS_POST_TIMED = 10  # postprocess calls per timing with the kernel


def nms_inputs(torch, rng, valid, num_p, num_c, tied=False, zero=False):
    """Seeded boxes [B, P, 4] (make_boxes' kinds, zero padding after each
    image's `valid` proposals) and scores [B, P, C] on the card: per class
    a permutation spread log-uniformly over [1e-7, 1] (no ties; some under
    the shipped score_thresh of 1e-5), or four levels (`tied`), or all 0
    (`zero`: no candidate); the padded rows' scores 0, as postprocess
    masks them."""
    boxes = np.stack([np.clip(make_boxes(rng, num_p, num_p - n), 0.0, 1.0)
                      for n in valid])
    scores = np.zeros((len(valid), num_p, num_c), np.float32)
    for b, n in enumerate(valid):
        if tied:
            scores[b, :n] = np.ceil(rng.random((n, num_c)) * 4) / 4
        elif not zero:
            rank = np.argsort(rng.random((n, num_c)), axis=0)
            scores[b, :n] = 10.0 ** (-7.0 + 7.0 * (rank + 1) / (n + 1))
    return torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda()


def check_nms_case(torch, label, boxes, scores, opts):
    """The kernels against _per_image_nms on the card, bit for bit on the
    mask and on all four outputs of batch_multiclass_nms, and each stage
    alone against its plain version (the overlap bits, and the walk over
    the plain bits); returns the case's line with what the walk did
    (kernels/nms.walk_stats)."""
    from cap2det_tpu_torch.kernels import nms as nms_kernel
    from cap2det_tpu_torch.ops import nms as nms_ops

    score_thresh, iou_thresh, cap, total = opts
    got = nms_kernel.nms_mask(boxes, scores, score_thresh, iou_thresh, cap)
    want = nms_kernel.plain_nms_mask(boxes, scores, score_thresh,
                                     iou_thresh, cap)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("nms: %s: the kernel's mask differs from the "
                             "plain version's at %d of %d pairs" % (
                                 label, int((got != want).sum()),
                                 got.numel()))
    outs = nms_ops.batch_multiclass_nms(
        boxes, scores, score_thresh=score_thresh, iou_thresh=iou_thresh,
        max_size_per_class=cap, max_total_size=total)
    plain = nms_ops.merge_detections(boxes, scores, want, total)
    for name, a, b in zip(NMS_OUTPUTS, outs, plain):
        if not torch.equal(a, b):
            raise AssertionError("nms: %s: %s differs from the plain "
                                 "version's" % (label, name))
    bits = nms_kernel.plain_overlap_bits(boxes, iou_thresh)
    order = nms_kernel.rank_order(scores)
    if not torch.equal(nms_kernel._launch_bits(boxes, iou_thresh), bits):
        raise AssertionError("nms: %s: the mask kernel's bits differ from "
                             "plain_overlap_bits'" % label)
    if not torch.equal(
            nms_kernel._launch_walk(bits, scores, order, score_thresh, cap),
            nms_kernel.plain_walk(bits, order, scores, score_thresh, cap)):
        raise AssertionError("nms: %s: the walk kernel differs from "
                             "plain_walk" % label)
    stats = nms_kernel.walk_stats(scores, got, score_thresh, cap)
    ranks = stats["ranks"].float()
    num_b, num_p, _ = scores.shape
    return {"case": label, "shape": list(scores.shape),
            "score_thresh": score_thresh, "iou_thresh": iou_thresh,
            "cap": cap, "candidates": int((scores > score_thresh).sum()),
            "survivors": int(got.sum()),
            "classes_at_cap": int((got.sum(1) == cap).sum()),
            "num_detections": outs[0].tolist(),
            "ranks_walked_mean": float(ranks.mean()),
            "ranks_walked_max": int(ranks.max()),
            "survivors_per_class_mean": float(
                stats["survivors"].float().mean()),
            "survivors_per_class_max": int(stats["survivors"].max()),
            "groups_mean": float(stats["groups"].float().mean()),
            "groups_max": int(stats["groups"].max()),
            "iou_pairs": stats["iou_pairs"],
            "mask_pair_tests": nms_kernel.pair_tests(num_b, num_p),
            "scratch_bytes": nms_kernel.scratch_bytes(num_b, num_p)}


def time_nms(torch, line, boxes, scores, opts):
    """Adds to a case's line the kernels' time (both stages through
    _launch, the order made once) host-launched and replayed from a CUDA
    graph, each stage's alone from a graph, the wrapper's (argsort and
    kernels) and the plain version's, all by CUDA events, and the bound
    of this launch's work."""
    from cap2det_tpu_torch.kernels import nms as nms_kernel

    score_thresh, iou_thresh, cap, _ = opts
    order = nms_kernel.rank_order(scores)
    bits = nms_kernel._launch_bits(boxes, iou_thresh)
    num_b, num_p, num_c = scores.shape
    b_ms, b_by = bound_ms(
        nms_kernel.nms_bytes(num_b, num_p, num_c),
        nms_kernel.nms_flops(num_b, num_p, num_c, line["iou_pairs"]))

    def kernels():
        return nms_kernel._launch(boxes, scores, order, score_thresh,
                                  iou_thresh, cap)

    line.update(
        kernel_ms=device_ms(kernels),
        host_launched_ms=cuda_ms(kernels, NMS_TIMED),
        bits_ms=device_ms(lambda: nms_kernel._launch_bits(boxes,
                                                          iou_thresh)),
        walk_ms=device_ms(lambda: nms_kernel._launch_walk(
            bits, scores, order, score_thresh, cap)),
        wrapper_ms=cuda_ms(lambda: nms_kernel.nms_mask(
            boxes, scores, score_thresh, iou_thresh, cap), NMS_TIMED),
        plain_ms=cuda_ms(lambda: nms_kernel.plain_nms_mask(
            boxes, scores, score_thresh, iou_thresh, cap), NMS_PLAIN_TIMED,
            warmup=1),
        bound_ms=b_ms, bound_by=b_by)
    line["kernel_over_bound"] = line["kernel_ms"] / b_ms
    return line


def postprocess_cost(torch, model, args, calls):
    """(CUDA-event ms a call, host-clock ms a call, bytes the call needs
    beyond what was allocated before it) of model.postprocess(*args)."""
    model.postprocess(*args)
    ms = cuda_ms(lambda: model.postprocess(*args), calls, warmup=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.postprocess(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.postprocess(*args)
    torch.cuda.synchronize()
    return ms, host_ms, torch.cuda.max_memory_allocated() - base


def phase_nms(torch, model, outs):
    """The NMS kernels (csrc/nms.cu: the overlap mask, then the walk)
    against their plain version on the card, bit for bit, and each stage
    against its own, at the shipped shapes and edge cases and on the serve
    phase's real scores; their time beside their bound and the plain
    version's; one image's postprocess with the kernels and with the plain
    version, each with its time and the memory it needs."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.kernels import nms as nms_kernel
    from cap2det_tpu_torch.ops import nms as nms_ops

    cfg = schema.load_pipeline(os.path.join("configs", "voc07_inc2.pbtxt"))
    options = cfg.model.cap2det_model
    shipped = {name: (p.score_thresh, p.iou_thresh, p.max_size_per_class,
                      p.max_total_size) for name, p in (
                          ("midn", options.midn_post_processor),
                          ("oicr", options.oicr_post_processor))}
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    cases = []
    for name, opts in shipped.items():
        cases += [("voc07 %s [1,2000,20], 1500 valid" % name,
                   nms_inputs(torch, rng, [1500], 2000, 20), opts),
                  ("coco17 %s [1,500,80]" % name,
                   nms_inputs(torch, rng, [500], 500, 80), opts),
                  ("B=2 %s [2,2000,20], 1500 and 1800 valid" % name,
                   nms_inputs(torch, rng, [1500, 1800], 2000, 20), opts)]
    oicr = shipped["oicr"]
    cases += [("cap 5 binds", nms_inputs(torch, rng, [1500], 2000, 20),
               oicr[:2] + (5,) + oicr[3:]),
              ("no candidate", nms_inputs(torch, rng, [1500], 2000, 20,
                                          zero=True), oicr),
              ("tied scores", nms_inputs(torch, rng, [1500], 2000, 20,
                                         tied=True), oicr)]
    lines = []
    for label, (boxes, scores), opts in cases:
        line = check_nms_case(torch, label, boxes, scores, opts)
        if label.startswith("coco17"):
            time_nms(torch, line, boxes, scores, opts)
        log("nms: " + json.dumps(line))
        lines.append(line)
    if lines[-3]["classes_at_cap"] < 1 or lines[-2]["survivors"]:
        raise AssertionError("nms: the cap never bound, or a survivor "
                             "without a candidate: %s, %s" % (
                                 lines[-3], lines[-2]))

    # The serve phase's real scores, as postprocess hands them to
    # batch_multiclass_nms: the four iterations of each image.
    real_bmn, real_mask = nms_ops.batch_multiclass_nms, nms_kernel.nms_mask
    calls = []

    def record(boxes, scores, **kw):
        calls.append((boxes, scores.clone(), kw))
        return real_bmn(boxes, scores, **kw)

    post_args = []
    for out in outs:
        post_args.append((
            {k: torch.from_numpy(v).cuda()
             for k, v in out["proposal_scores"].items()},
            torch.from_numpy(out["proposals"])[None].cuda(),
            torch.tensor([out["num_proposals"]]).cuda()))
        nms_ops.batch_multiclass_nms = record
        try:
            model.postprocess(*post_args[-1])
        finally:
            nms_ops.batch_multiclass_nms = real_bmn
    per_image = len(calls) // len(outs)
    row = {"max_abs_err": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
           "library_ms": None}
    parts = dict.fromkeys(("host_launched_ms", "bits_ms", "walk_ms",
                           "wrapper_ms"), 0.0)
    nbytes = flops = 0
    for i, (boxes, scores, kw) in enumerate(calls):
        opts = (kw["score_thresh"], kw["iou_thresh"],
                kw["max_size_per_class"], kw["max_total_size"])
        label = "serve image %d iteration %d" % (i // per_image,
                                                 i % per_image)
        line = check_nms_case(torch, label, boxes, scores, opts)
        if i < per_image:  # the first image's four launches, timed
            time_nms(torch, line, boxes, scores, opts)
            row["kernel_ms"] += line["kernel_ms"] / per_image
            row["plain_ms"] += line["plain_ms"] / per_image
            for key in parts:
                parts[key] += line[key] / per_image
            num_b, num_p, num_c = scores.shape
            nbytes += nms_kernel.nms_bytes(num_b, num_p, num_c)
            flops += nms_kernel.nms_flops(num_b, num_p, num_c,
                                          line["iou_pairs"])
        log("nms: " + json.dumps(line))
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes / per_image,
                                                flops / per_image)

    # One image's postprocess (softmax, mask, four NMS calls and merges)
    # with the kernel and, for comparison, with the plain version.
    kernel_cost = postprocess_cost(torch, model, post_args[0],
                                   NMS_POST_TIMED)
    # The NMS before the kernel, for its time and memory only.
    nms_kernel.nms_mask = nms_kernel.plain_nms_mask
    try:
        plain_cost = postprocess_cost(torch, model, post_args[0], 1)
    finally:
        nms_kernel.nms_mask = real_mask
    for label, (ms, host_ms, peak) in (("kernel", kernel_cost),
                                       ("plain", plain_cost)):
        log("nms: postprocess of one image with the %s NMS: %.4f ms (CUDA "
            "events), %.4f ms (host clock), needs %d bytes beyond what was "
            "allocated (max_memory_allocated)" % (label, ms, host_ms, peak))
    log("nms: per call at the serve shape, mean of an image's %d: kernels "
        "%.4f ms from a CUDA graph (mask %.4f + walk %.4f), host-launched "
        "%.4f, through the wrapper %.4f, plain %.4f, bound %.6f (%s); "
        "phase %.1f s" % (
            per_image, row["kernel_ms"], parts["bits_ms"], parts["walk_ms"],
            parts["host_launched_ms"], parts["wrapper_ms"], row["plain_ms"],
            row["bound_ms"], row["bound_by"], time.perf_counter() - t0))
    return row


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
                b_ms, b_by = bound_ms(nbytes, roi_pool.backward_flops(
                    *boxes.shape[:2], feats.shape[-1], 14, 2, 2))
                line.update(
                    kernel_ms=cuda_ms(lambda: roi_pool.
                                      roi_crop_maxpool_grad(
                                          feats, boxes, grad, 14, 2, 2),
                                      iters=20),
                    plain_ms=cuda_ms(lambda: roi_ops.
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
                "kernel_ms": cuda_ms(lambda: roi_pool.
                                     roi_crop_maxpool_grad(
                                         feats, boxes, grad, 14, 2, 2),
                                     iters=20)}
        line.update(roi_pool.grad_atomic_counts(feats, boxes, grad, 14, 2, 2))
        log(json.dumps(line))
    # The largest coco17 training bucket and ResNet-101's maps: exact,
    # within GRAD_TOL of the plain version, the same bits twice, timed
    # beside its bound.
    for label, shape in K2_MORE_SHAPES:
        feats32 = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda()
        boxes = torch.from_numpy(np.stack([
            make_boxes(rng, TRAIN_P, num_pad=TRAIN_P // 20)
            for _ in range(batch)])).cuda()
        grads32 = grad32 if shape[-1] == grad32.shape[-1] else \
            torch.from_numpy(rng.standard_normal(
                (batch, TRAIN_P, 7, 7, shape[-1]), dtype=np.float32)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            feats, grad = feats32.to(dtype), grads32.to(dtype)
            got = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14, 2,
                                                 2)
            exact = roi_ops.crop_resize_maxpool_grad(
                feats, boxes, grad, 14, 2, 2, fixed_point=True)
            again = roi_pool.roi_crop_maxpool_grad(feats, boxes, grad, 14,
                                                   2, 2)
            torch.cuda.synchronize()
            if not (torch.equal(got, exact) and torch.equal(got, again)):
                raise AssertionError(
                    "roi_crop_maxpool_grad: %s at %s differs from its "
                    "fixed-point oracle or between launches" % (name, shape))
            err = compare(torch, got, roi_ops.crop_resize_maxpool_grad(
                feats, boxes, grad, 14, 2, 2), name, GRAD_TOL)
            result["max_abs_err"] = max(result["max_abs_err"], err)
            line = {"kernel": "roi_crop_maxpool_grad", "shape": label,
                    "features": list(shape), "P": TRAIN_P,
                    "dtype": name, "max_abs_err_exact": 0.0,
                    "max_abs_err": err, "tol(rtol,atol)": GRAD_TOL[name],
                    "run_to_run_max_abs_diff": 0.0}
            if dtype == torch.bfloat16:
                nbytes = (2 * feats.numel() * feats.element_size()
                          + boxes.numel() * 4
                          + grad.numel() * grad.element_size())
                b_ms, b_by = bound_ms(nbytes, roi_pool.backward_flops(
                    *boxes.shape[:2], feats.shape[-1], 14, 2, 2))
                line.update(
                    kernel_ms=cuda_ms(lambda: roi_pool.
                                      roi_crop_maxpool_grad(
                                          feats, boxes, grad, 14, 2, 2),
                                      iters=20),
                    plain_ms=cuda_ms(lambda: roi_ops.
                                     crop_resize_maxpool_grad(
                                         feats, boxes, grad, 14, 2, 2),
                                     iters=2, warmup=1),
                    bound_ms=b_ms, bound_by=b_by)
                line["kernel_over_bound"] = line["kernel_ms"] / b_ms
                line.update(roi_pool.grad_atomic_counts(feats, boxes, grad,
                                                        14, 2, 2))
            log(json.dumps(line))
    if roi_pool.grad_generic_launches != first_generic:
        raise AssertionError("roi_crop_maxpool_grad: a training shape "
                             "took the generic kernel")
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
                    b_ms, b_by = bound_ms(nbytes, (
                        pool_grad.maxpool_grad_flops if reads_x
                        else pool_grad.avgpool_grad_flops)(shape, k, s))
                    line.update(
                        kernel_ms=cuda_ms(run, iters=50),
                        device_ms=device_ms(run),
                        plain_ms=cuda_ms(plain, iters=10),
                        library_ms=cuda_ms(lib, iters=50),
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


# Phase 6a: the fused optimizer at the trainable sets of the two training
# regimes the main path runs (62 leaves of coco17_extend_match with
# Mixed_4e, 48 of voc07_inc2's full freeze), every optimizer kind with and
# without per-leaf clipping, FUSED_UPDATES chained updates.
FUSED_SETS = [  # (tag, config, trainable leaves, parameters)
    ("coco17", "coco17_extend_match.pbtxt", 62, 7417427),
    ("inc2", "voc07_inc2.pbtxt", 48, 6002951),
]
FUSED_OPTIMIZERS = {
    "sgd": "sgd {}",
    "adagrad": "adagrad { initial_accumulator_value: 0.1 }",
    "adam": "adam { beta1: 0.8 beta2: 0.99 epsilon: 0.001 }",
    "rmsprop": "rmsprop { decay: 0.9 epsilon: 0.01 }",
    "rmsprop_centered_momentum": ("rmsprop { decay: 0.9 epsilon: 0.01 "
                                  "centered: true momentum: 0.5 }"),
    "momentum": "momentum { momentum: 0.9 }",
    "nesterov": "momentum { momentum: 0.9 use_nesterov: true }",
}
FUSED_UPDATES = 10
FUSED_CLIP = 0.5  # most leaves' gradient norms exceed it
# Every kind equals its plain version bit for bit without clipping. With
# it, a leaf's norm is summed in another order than torch.sum's, so the
# factor may differ in its last bits: params and slots within this many
# ulps of each leaf's largest magnitude.
FUSED_CLIP_ULPS = 8.0


def fused_gradients(torch, leaf_set, generator):
    """Seeded float32 gradients of the leaf set, those of kernels wider
    than 1x1 channels-last, as cuDNN returns a convolution's weight
    gradient."""
    out = []
    for shape in leaf_set.shapes:
        g = torch.randn(shape, generator=generator, device="cuda")
        if len(shape) == 4 and shape[2] * shape[3] > 1:
            g = g.contiguous(memory_format=torch.channels_last)
        out.append(g)
    return out


def phase_fused_optimizer(torch):
    """The fused optimizer kernel (csrc/fused_optimizer.cu) against its
    plain version (fused_update_reference) at both trainable sets, for all
    seven kinds with and without clipping over FUSED_UPDATES chained
    updates; then the shipped update (Adagrad, no clipping) timed: the
    kernel replayed from a CUDA graph (its time on the card) and launched
    from the host (what a step pays), the plain flat version and the
    per-leaf chain, beside the bound. Returns coco17's row of the kernels
    line."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.kernels import fused_optimizer
    from cap2det_tpu_torch.models import registry
    from cap2det_tpu_torch.train import optimizers
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    rows = {}
    max_err = 0.0
    for tag, config, want_leaves, want_params in FUSED_SETS:
        cfg = schema.load_pipeline(os.path.join("configs", config))
        model = registry.build(cfg.model, is_training=True,
                               compute_dtype=torch.bfloat16)
        params = model.init_params(SEED)
        shipped, _, _ = optimizers.build_optimizer(
            cfg.train_config, params, model.non_trainable_paths,
            getattr(model, "non_trainable_substrings", ()))
        ls = shipped.leaf_set
        if (len(ls.paths), ls.total) != (want_leaves, want_params):
            raise AssertionError("fused_optimizer: %s has %d trainable "
                                 "leaves, %d params; expected %d, %d" % (
                                     tag, len(ls.paths), ls.total,
                                     want_leaves, want_params))
        leaves = dict(optimizers.flatten_params(params))
        init = [leaves[p].detach().clone() for p in ls.paths]
        del model, params, leaves
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        grads = [fused_gradients(torch, ls, gen)
                 for _ in range(FUSED_UPDATES)]
        log("fused_optimizer: %s: %d leaves, %d params, %d launch "
            "group(s), %d chunks of at most %d; %d of %d gradients "
            "channels-last" % (
                tag, len(ls.paths), ls.total, len(ls.groups),
                sum(len(g[2]) for g in ls.groups), fused_optimizer.CHUNK,
                sum(not g.is_contiguous() for g in grads[0]), len(ls.paths)))
        for kind, text in FUSED_OPTIMIZERS.items():
            rule = optimizers.build_base_optimizer(schema.loads_pipeline(
                "train_config { optimizer { %s } }" % text
            ).train_config.optimizer)
            for clip in (None, FUSED_CLIP):
                runs = []
                for fn in (fused_optimizer.fused_update,
                           fused_optimizer.fused_update_reference):
                    ps = [p.clone() for p in init]
                    slots = rule.init(torch.empty(ls.total, device="cuda"))
                    before = fused_optimizer.launches
                    for count, g in enumerate(grads):
                        fn(rule, ls, ps, g, slots, 0.01 * 0.5 ** (count // 4),
                           count, clip)
                    torch.cuda.synchronize()
                    runs.append((ps, slots,
                                 fused_optimizer.launches - before))
                (got, got_slots, launched), (want, want_slots, _) = runs
                if launched != FUSED_UPDATES * (1 + (clip is not None)):
                    raise AssertionError("fused_optimizer: %d launches for "
                                         "%d updates" % (launched,
                                                         FUSED_UPDATES))
                gaps = [fused_optimizer.ulp_gap(a, b)
                        for a, b in zip(got, want)]
                slot_gaps = [fused_optimizer.ulp_gap(
                    got_slots[name][off:off + n],
                    want_slots[name][off:off + n])
                    for name in want_slots
                    for off, n in zip(ls.offsets, ls.numels)]
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                max_err = max(max_err, err)
                limit = 0.0 if clip is None else FUSED_CLIP_ULPS
                line = {"kernel": "fused_optimizer", "set": tag,
                        "kind": kind, "clip": clip,
                        "updates": FUSED_UPDATES,
                        "max_ulp_gap_params": max(gaps),
                        "max_ulp_gap_slots": max(slot_gaps, default=0.0),
                        "leaves_not_bit_equal": sum(g > 0 for g in gaps),
                        "max_abs_err": err, "limit_ulps": limit}
                log(json.dumps(line))
                if max(gaps + slot_gaps) > limit:
                    raise AssertionError(
                        "fused_optimizer: %s %s clip %s: params or slots "
                        "%r ulps from the plain version, limit %r" % (
                            tag, kind, clip, max(gaps + slot_gaps), limit))

        # The shipped update timed: Adagrad, no clipping.
        rule = shipped.rule
        ps = [p.clone() for p in init]
        slots = rule.init(torch.empty(ls.total, device="cuda"))
        g = grads[0]
        chain = optimizers.Optimizer(rule, lambda count: 0.01,
                                     dict(zip(ls.paths, ls.multipliers)),
                                     None)
        chain_params = dict(zip(ls.paths, [p.clone() for p in init]))
        chain_grads = dict(zip(ls.paths, g))
        chain_state = chain.init(chain_params)

        def kernel():
            fused_optimizer.fused_update(rule, ls, ps, g, slots, 0.01, 0)

        def plain():
            fused_optimizer.fused_update_reference(rule, ls, ps, g, slots,
                                                   0.01, 0, None)

        def per_leaf():
            chain.apply(chain_params, chain_grads, chain_state)

        nbytes = fused_optimizer.update_bytes(len(rule.slot_names()),
                                              ls.total)
        b_ms, b_by = bound_ms(nbytes, fused_optimizer.update_flops(
            rule, ls, False))
        row = {"kernel": "fused_optimizer", "set": tag,
               "kernel_ms": device_ms(kernel, iters=20),
               "host_launched_ms": cuda_ms(kernel, iters=50),
               "plain_ms": cuda_ms(plain, iters=20),
               "per_leaf_ms": cuda_ms(per_leaf, iters=20),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "max_abs_err": max_err}
        row["kernel_over_bound"] = row["kernel_ms"] / b_ms
        log(json.dumps(row))
        rows[tag] = row
        del grads, init, ps, slots, chain_params, chain_state
        torch.cuda.empty_cache()
    return dict(rows["coco17"], max_abs_err=max_err)


BN_FOLD_SETS = [  # (tag, config, convolutions, weights, trainable ones)
    ("coco17", "coco17_extend_match.pbtxt", 69, 10150080, 6999040),
    ("inc2", "voc07_inc2.pbtxt", 69, 10150080, 5893120),
    # Every convolution with a gamma, epsilon 1e-5, block3 and block4
    # trainable.
    ("resnet101", RESNET_CONFIG, 104, 42394816, 40960000),
]
BN_FOLD_STEP_HW = (256, 384)  # the step held bit for bit, plain against kernel


def load_config(schema, config):
    """A config under configs/ by file name, or a benchmark
    configuration's pipeline text by its JSON file's path."""
    if config.endswith(".json"):
        with open(config) as f:
            return schema.loads_pipeline(json.load(f)["pbtxt"])
    return schema.load_pipeline(os.path.join("configs", config))


def bn_fold_inputs(torch, config):
    """A config's model with seeded weights and BN statistics (and gammas,
    where its BatchNorms have them) drawn away from the init's (so every
    inv, scale, bias and product is a real one): (the convolutions as
    ``bn_fold.fold`` takes them, (weights, beta, mean, var, gamma or
    None), their trainable leaves as the optimizer's mask sets them, the
    backbone's epsilon)."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.kernels import bn_fold
    from cap2det_tpu_torch.models import frcnn, registry
    from cap2det_tpu_torch.train import optimizers, trainer
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    cfg = load_config(schema, config)
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.bfloat16)
    params = model.init_params(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    with torch.no_grad():
        for path, leaf in optimizers.flatten_params(params):
            if path.endswith("moving_variance"):
                leaf.copy_(torch.rand(leaf.shape, generator=gen,
                                      device="cuda") * 2 + 0.01)
            elif path.endswith(("moving_mean", "BatchNorm/beta",
                                "BatchNorm/gamma")):
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device="cuda"))
    _, mask, _ = optimizers.build_optimizer(
        cfg.train_config, params, model.non_trainable_paths,
        getattr(model, "non_trainable_substrings", ()))
    trainer.set_trainable(params, mask)
    slots = []
    for scope in (frcnn.FIRST_SCOPE, frcnn.SECOND_SCOPE):
        bn_fold.gather(params[scope], slots)
    convs = [(w, bn["beta"], bn["moving_mean"], bn["moving_variance"],
              bn.get("gamma")) for _, _, w, bn in slots]
    leaves = [t for c in convs for t in (c[0], c[1], c[4])
              if t is not None and t.requires_grad]
    eps = frcnn.NETS[next(iter(params[frcnn.FIRST_SCOPE]))].BN_EPSILON
    return convs, leaves, eps


def bn_fold_upstream(torch, outputs, gen):
    """Seeded gradients of the fold's differentiable outputs, each weight's
    in the layout cuDNN returns (channels-last beyond 1x1)."""
    grads = []
    for t in outputs:
        g = torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype)
        if t.dim() == 4 and t.shape[-1] > 1:
            g = g.contiguous(memory_format=torch.channels_last)
        grads.append(g)
    return grads


def fold_plain(convs, dtype, eps=None):
    """bn_fold.fold's plain version, with its arguments: the
    per-convolution chain (each conv (weights, beta, mean, var[,
    gamma]))."""
    from cap2det_tpu_torch.kernels import bn_fold

    eps = bn_fold.BN_EPSILON if eps is None else eps
    return [bn_fold.fold_reference(*c[:4], dtype, *c[4:], eps=eps)
            for c in convs]


def fold_grad_inputs(torch, bn_fold, convs, eps):
    """A fold of `convs` kept for its backward, as ``bn_fold.fold`` makes
    it while autograd records: (the plan, the scale buffer, the
    arguments of each convolution's gamma gradient, seeded upstream
    gradients of its weights and biases)."""
    ws = [c[0] for c in convs]
    gammas = [c[4] is not None for c in convs]
    grad_g = [c[4] is not None and c[4].requires_grad for c in convs]
    plan = bn_fold.plan(ws, [w.requires_grad for w in ws],
                        [c[1].requires_grad for c in convs], gammas, grad_g)
    out, scale = bn_fold._fold(plan, convs, torch.bfloat16, eps, True)
    aux = [(c[0], c[2]) if g else None for c, g in zip(convs, grad_g)]
    gen = torch.Generator(device=out.device).manual_seed(SEED + 23)
    ups = bn_fold_upstream(torch, plan.outputs(out), gen)
    return plan, scale, aux, ups[0::2], ups[1::2]


def phase_bn_fold(torch):
    """The BN fold kernels (csrc/bn_fold.cu: one launch folds every
    convolution of both stages, one more gives the trainable leaves'
    gradients) against their plain version (the per-convolution chain,
    bn_fold.fold_reference, and autograd through it) on the card, at the
    trees and trainable sets of coco17_extend_match, voc07_inc2 and
    coco17_resnet101 (104 convolutions, each with a gamma, epsilon 1e-5),
    with seeded BN statistics and gammas: outputs in bfloat16 and float32
    bit for bit with the same strides, the gradients of the weights,
    betas and gammas bit for bit from seeded upstream gradients
    (channels-last where cuDNN gives them so), one launch each; then two
    training steps of each InceptionV2 regime (bench.BenchStep at
    BN_FOLD_STEP_HW, bf16, dropout on) with the fold's kernels against
    the plain chain under deterministic cuDNN: losses and params bit for
    bit. Timed, each set: the fold and its backward replayed from a CUDA
    graph and launched from the host, the plain chain forward and
    backward, beside the byte bound. Returns {set: the kernels line's two
    rows}."""
    from cap2det_tpu_torch import bench
    from cap2det_tpu_torch.kernels import bn_fold
    from cap2det_tpu_torch.train import optimizers

    rows = {}
    max_err = 0.0
    for tag, config, want_convs, want_weights, want_trainable in BN_FOLD_SETS:
        convs, leaves, eps = bn_fold_inputs(torch, config)
        weights = sum(c[0].numel() for c in convs)
        trainable = sum(c[0].numel() for c in convs if c[0].requires_grad)
        if (len(convs), weights, trainable) != (want_convs, want_weights,
                                                want_trainable):
            raise AssertionError("bn_fold: %s has %d convolutions, %d "
                                 "weights, %d trainable; expected %d, %d, "
                                 "%d" % (tag, len(convs), weights, trainable,
                                         want_convs, want_weights,
                                         want_trainable))
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
            runs = []
            for fn in (bn_fold.fold, fold_plain):
                before = (bn_fold.launches, bn_fold.grad_launches)
                outs = [t for pair in fn(convs, dtype, eps) for t in pair]
                diff = [t for t in outs if t.requires_grad]
                gen.manual_seed(SEED + 22)
                grads = torch.autograd.grad(
                    diff, leaves, bn_fold_upstream(torch, diff, gen))
                torch.cuda.synchronize()
                runs.append((outs, grads, (
                    bn_fold.launches - before[0],
                    bn_fold.grad_launches - before[1])))
            (got, got_g, launched), (want, want_g, _) = runs
            if launched != (1, 1):
                raise AssertionError("bn_fold: %s: launches %s, expected "
                                     "one fold and one backward"
                                     % (tag, launched))
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if a.stride() != b.stride() or not torch.equal(a, b)]
            bad_g = [i for i, (a, b) in enumerate(zip(got_g, want_g))
                     if not torch.equal(a, b)]
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got + list(got_g), want + list(want_g)))
            max_err = max(max_err, err)
            log(json.dumps({"kernel": "bn_fold", "set": tag,
                            "dtype": str(dtype), "outputs": len(got),
                            "gradients": len(got_g),
                            "outputs_not_equal": len(bad),
                            "gradients_not_equal": len(bad_g),
                            "max_abs_err": err}))
            if bad or bad_g:
                raise AssertionError("bn_fold: %s %s: outputs %s, gradients "
                                     "%s differ from the plain version"
                                     % (tag, dtype, bad[:8], bad_g[:8]))

        # Timed in bf16: the fold alone (as update_params runs it), its
        # backward alone, and the plain chain's forward and backward.
        with torch.no_grad():
            def kernel():
                bn_fold.fold(convs, torch.bfloat16, eps)

            def plain():
                fold_plain(convs, torch.bfloat16, eps)

            kernel_ms = device_ms(kernel, iters=20)
            host_ms = cuda_ms(kernel, iters=50)
            plain_ms = cuda_ms(plain, iters=20)
        plan, scale, aux, g_w, g_b = fold_grad_inputs(torch, bn_fold, convs,
                                                      eps)

        def grad_kernel():
            bn_fold._fold_grad(plan, g_w, g_b, aux, scale, torch.bfloat16)

        def grad_plain():
            for i, row in enumerate(plan.table):
                if plan.grad_w[i] or plan.grad_b[i] or plan.grad_g[i]:
                    at, o = int(row["scale"]), len(g_b[i])
                    bn_fold.fold_grad_reference(
                        g_w[i] if plan.grad_w[i] else None,
                        g_b[i] if plan.grad_b[i] else None,
                        scale[at:at + o], *(aux[i] or ()),
                        *((scale[int(row["inv"]):][:o],) if aux[i]
                          else ()))

        grad_ms = device_ms(grad_kernel, iters=20)
        grad_host_ms = cuda_ms(grad_kernel, iters=50)
        grad_plain_ms = cuda_ms(grad_plain, iters=20)
        gammas = sum(c[0].numel() for c in convs
                     if c[4] is not None and c[4].requires_grad)
        nbytes = bn_fold.fold_bytes(weights)
        grad_bytes = bn_fold.fold_grad_bytes(trainable, gamma_numel=gammas)
        b_ms, b_by = bound_ms(nbytes, 3 * weights)
        gb_ms, gb_by = bound_ms(grad_bytes, bn_fold.fold_grad_flops(
            trainable, gammas))
        rows[tag] = (
            {"kernel": "bn_fold", "set": tag, "kernel_ms": kernel_ms,
             "host_launched_ms": host_ms, "plain_ms": plain_ms,
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             "bytes": nbytes, "kernel_over_bound": kernel_ms / b_ms},
            {"kernel": "bn_fold_grad", "set": tag, "kernel_ms": grad_ms,
             "host_launched_ms": grad_host_ms, "plain_ms": grad_plain_ms,
             "library_ms": None, "bound_ms": gb_ms, "bound_by": gb_by,
             "bytes": grad_bytes, "kernel_over_bound": grad_ms / gb_ms})
        for row in rows[tag]:
            log(json.dumps(row))
        del convs, leaves, plan, scale, aux, g_w, g_b
        torch.cuda.empty_cache()

    # Whole steps, the fold's kernels against the plain chain.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    real_fold = bn_fold.fold
    try:
        for full_freeze in (False, True):
            shape = dict(bench.SHAPES["inc2" if full_freeze else "bench"],
                         canvas_hw=BN_FOLD_STEP_HW)
            runs = []
            for fn in (real_fold, fold_plain):
                bn_fold.fold = fn
                step = bench.BenchStep(shape, "cuda")
                losses = [step.run()["loss/total_loss"] for _ in range(2)]
                runs.append((losses, optimizers.flatten_params(
                    step.state["params"])))
                del step
            bn_fold.fold = real_fold
            (losses, params), (plain_losses, plain) = runs
            bad = [p for (p, a), (_, b) in zip(params, plain)
                   if not torch.equal(a, b)]
            same = all(map(torch.equal, losses, plain_losses))
            log("bn_fold: %s step x2 at %dx%d, kernels against the plain "
                "chain under deterministic cuDNN: losses %s / %s, %d of %d "
                "leaves differ" % (
                    "inc2" if full_freeze else "bench", *BN_FOLD_STEP_HW,
                    [float(l) for l in losses],
                    [float(l) for l in plain_losses], len(bad), len(params)))
            if bad or not same:
                raise AssertionError("bn_fold: the step with the kernels "
                                     "differs from the plain chain's: %s"
                                     % bad[:8])
            torch.cuda.empty_cache()
    finally:
        bn_fold.fold = real_fold
        torch.use_deterministic_algorithms(was_deterministic)
        torch.backends.cudnn.deterministic = False
    return {tag: tuple(dict(row, max_abs_err=max_err) for row in pair)
            for tag, pair in rows.items()}


def scale_resnet_gammas(torch, params):
    """ResNet-101's gammas at TF's initial ones, with frozen statistics,
    grow the activations through 33 stacked units until the loss
    overflows in the second step (a checkpoint's statistics keep them in
    range): the root's gammas scaled by 0.02 and each unit's conv3's by
    0.2, the means of the benchmark's seeding."""
    from cap2det_tpu_torch.train import optimizers

    with torch.no_grad():
        for path, leaf in optimizers.flatten_params(params):
            if path.endswith("resnet_v1_101/conv1/BatchNorm/gamma"):
                leaf.mul_(0.02)
            elif path.endswith("/conv3/BatchNorm/gamma"):
                leaf.mul_(0.2)


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
                breakdown, text=None, init=None):
    """Training steps at a config's full width with seeded He weights:
    launch counts per step, finite losses, frozen leaves unchanged,
    trainable weights moved, seconds per step, peak memory, and with
    `breakdown` one more step timed by span. `text`, where given, is the
    config's text with its data files retargeted; `init`, where given,
    changes the seeded params in place before the first step."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.kernels import fused_optimizer, pool_grad, roi_pool
    from cap2det_tpu_torch.models import inception_v2, registry
    from cap2det_tpu_torch.train import optimizers, trainer
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    cfg = (schema.loads_pipeline(text) if text is not None
           else load_config(schema, config))
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.bfloat16)
    state, opt, schedule, mask = trainer.TrainState.create(
        model, cfg.train_config, SEED)
    if init is not None:
        init(torch, state["params"])
    step = trainer.make_train_step(model, opt, cfg.train_config, mask)
    rng = np.random.default_rng(SEED + 6)
    batch = model.device_batch(train_batch(
        rng, batch_size, (1024, 1536), num_p, model.num_classes,
        pad=num_p // 10))
    flat_mask = dict(optimizers.flatten_params(mask))
    initial = {path: leaf.detach().clone() for path, leaf
               in optimizers.flatten_params(state["params"])}
    tag = os.path.basename(config).split(".")[0]
    log("train %s: batch %d, 1024x1536, P=%d, %d classes, %d trainable of "
        "%d leaves, lr %g, bf16 convolutions" % (
            tag, batch_size, num_p, model.num_classes,
            sum(flat_mask.values()), len(flat_mask), schedule(0)))

    # The layouts of the gradients the fused optimizer takes, read in the
    # first warm-up step (untimed).
    grad_layouts = {}
    real_flags = fused_optimizer._grad_flags

    def grad_flags(path, g, shape):
        flags = real_flags(path, g, shape)
        key = "channels-last" if flags[0] else "contiguous"
        grad_layouts[key] = grad_layouts.get(key, 0) + 1
        return flags

    losses = []
    for i in range(warmup):
        fused_optimizer._grad_flags = grad_flags if i == 0 else real_flags
        try:
            state, logs = step(state, batch, SEED)
        finally:
            fused_optimizer._grad_flags = real_flags
        losses.append(float(logs["loss/total_loss"]))
    log("train %s: the trainable leaves' float32 gradients as the fused "
        "optimizer takes them: %s" % (tag, json.dumps(grad_layouts)))
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
              "peak_bytes": peak, "losses": losses, "step_s": times}
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
            (fused_optimizer, "fused_update",
             "fused update (inside optimizer)"),
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


BENCH_TIMEOUT = 300.0  # seconds for one tool's process
BENCH_TOOLS = [  # (label, module, arguments)
    ("bench", "cap2det_tpu_torch.bench", ["--shape", "bench"]),
    ("bench inc2", "cap2det_tpu_torch.bench", ["--shape", "inc2"]),
    ("bench e2e", "cap2det_tpu_torch.bench", ["--e2e"]),
    ("bench_eval", "cap2det_tpu_torch.tools.bench_eval", ["--examples", "8"]),
    ("profile_step", "cap2det_tpu_torch.tools.profile_step",
     ["--steps", "8", "--convs"]),
    ("bench_components", "cap2det_tpu_torch.tools.bench_components",
     ["--steps", "4"]),
    ("bench_backbone_parts", "cap2det_tpu_torch.tools.bench_backbone_parts",
     ["--steps", "4"]),
    ("bench_opt_ab", "cap2det_tpu_torch.tools.bench_opt_ab",
     ["--variant", "both"]),
]


def run_tool(label, module, args):
    """Runs ``python -m module args`` from the repository root; returns its
    JSON lines (each printed), or raises on a nonzero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module] + args,
                          capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    if proc.returncode:
        raise AssertionError("bench: %s exited %d:\n%s" % (
            label, proc.returncode, proc.stderr[-4000:]))
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    for line in lines:
        log("bench: %s %s" % (label, json.dumps(line)))
    log("bench: %s took %.1f s" % (label, time.perf_counter() - t0))
    if not lines:
        raise AssertionError("bench: %s printed no JSON line" % label)
    return lines


def check_finite(label, value, path=""):
    """Raises if a number anywhere in a tool's line is not finite."""
    if isinstance(value, dict):
        for k, v in value.items():
            check_finite(label, v, path + "/" + str(k))
    elif isinstance(value, list):
        for i, v in enumerate(value):
            check_finite(label, v, "%s[%d]" % (path, i))
    elif isinstance(value, float) and not np.isfinite(value):
        raise AssertionError("bench: %s: %s is %r" % (label, path, value))


def phase_bench(torch, coco, coco_want, voc_want):
    """The measuring tools on the card, each in a process of its own; their
    lines checked against each other and against phase 7."""
    name = torch.cuda.get_device_name(0)
    out = {}
    for label, module, args in BENCH_TOOLS:
        lines = run_tool(label, module, args)
        for line in lines:
            check_finite(label, line)
            if line.get("device") != name or not line.get("power_limit"):
                raise AssertionError("bench: %s: a line without the card's "
                                     "name and power limit: %s" % (label,
                                                                   line))
        out[label] = lines

    for label, want in (("bench", coco_want), ("bench inc2", voc_want)):
        (line,) = out[label]
        if not 0.0 < line["mfu"] <= 1.0 or not (
                0.0 < line["mfu_lower_bound"] <= line["mfu"]):
            raise AssertionError("bench: %s: mfu %r, lower bound %r" % (
                label, line["mfu"], line["mfu_lower_bound"]))
        if line["launches"] != want:
            raise AssertionError("bench: %s: launches per step %s, expected "
                                 "%s" % (label, line["launches"], want))
    bench = out["bench"][0]
    (e2e,) = out["bench e2e"]
    if e2e["launches"] != {k: float(v) for k, v in coco_want.items()}:
        raise AssertionError("bench: e2e launches per step %s" % e2e[
            "launches"])

    # The same step as phase 7's: its median within both spreads, or the
    # difference printed with them.
    ms = [t * 1e3 for t in coco["step_s"]]
    phase7 = (float(np.median(ms)), min(ms), max(ms))
    agree = (bench["step_ms_min"] <= phase7[2]
             and phase7[1] <= bench["step_ms_max"])
    log("bench: step_ms %.4f (rounds %.4f-%.4f, CUDA events) against phase "
        "7's median %.4f (steps %.4f-%.4f, host clock): %s" % (
            bench["step_ms"], bench["step_ms_min"], bench["step_ms_max"],
            phase7[0], phase7[1], phase7[2],
            "the spreads overlap" if agree else "apart by %.4f ms" % (
                bench["step_ms"] - phase7[0])))

    profile = out["profile_step"]
    device_ms = profile[0]["total_device_ms_per_step"]
    if profile[0]["launches"] != {k: float(v) for k, v in coco_want.items()}:
        raise AssertionError("bench: profile_step launches %s"
                             % profile[0]["launches"])
    if not 0.0 < profile[0]["busy_share_untraced"] <= 1.0:
        raise AssertionError("bench: profile_step's untraced busy share %r"
                             % profile[0]["busy_share_untraced"])
    if not device_ms <= bench["step_ms"]:
        raise AssertionError("bench: profile_step's device time %.4f ms a "
                             "step exceeds bench's step_ms %.4f" % (
                                 device_ms, bench["step_ms"]))
    busy = [line for line in profile if "busy_share" in line]
    gaps = [line for line in profile if "longest_gaps" in line]
    if len(busy) != 1 or not 0.0 < busy[0]["busy_share"] <= 1.0 or len(
            gaps) != 1 or not gaps[0]["longest_gaps"]:
        raise AssertionError("bench: profile_step's busy share or gaps "
                             "missing: %s %s" % (busy, gaps))
    if not any(line.get("conv_total_ms", 0) > 0 for line in profile):
        raise AssertionError("bench: profile_step's conv table is empty")

    metrics = {line["metric"]: line for line in out["bench_eval"]}
    share = metrics["eval_seconds_per_example_multiscale"]["nms_share"]
    if set(metrics) != {"eval_seconds_per_example_multiscale",
                        "eval_seconds_per_checkpoint_voc07_test_extrapolated",
                        "eval_device_forward_seconds_per_scale"} or not (
                            0.0 < share < 1.0):
        raise AssertionError("bench: bench_eval lines %s, NMS share %r"
                             % (sorted(metrics), share))
    if e2e["record_reader"] != "native.read_records_native" or not (
            e2e["host_pipeline_python_reader_images_per_sec"] > 0):
        raise AssertionError("bench: e2e's feed: %s" % e2e)
    log("bench: e2e's feed alone %.3f images/s through the host library's "
        "reader, %.3f through the Python reader (in turns %s); the first "
        "step waited %.3f s" % (
            e2e["host_pipeline_images_per_sec"],
            e2e["host_pipeline_python_reader_images_per_sec"],
            json.dumps(e2e["host_pipeline_turns"]), e2e["first_step_wait_s"]))
    *turns, ab = out["bench_opt_ab"]
    ab_keys = ("opt_fused", "opt_unfused", "step_fused", "step_unfused")
    if not all(ab.get(k, 0) > 0 for k in ab_keys) or len(turns) != 2 * ab[
            "turns"]:
        raise AssertionError("bench: bench_opt_ab printed %s" % ab)
    log("bench: bench_opt_ab (medians of %d turns each, CUDA events): "
        "optimizer %.4f ms fused, %.4f per leaf; step %.4f ms fused, %.4f "
        "per leaf" % (ab["turns"], ab["opt_fused"], ab["opt_unfused"],
                      ab["step_fused"], ab["step_unfused"]))
    summary = [line for line in out["bench_components"] if "summary" in line]
    parts = {line["part"] for line in out["bench_backbone_parts"]}
    if len(summary) != 1 or len(summary[0]["summary"]) != 16 or len(
            parts) != 18:
        raise AssertionError("bench: components %s, parts %s" % (
            summary, sorted(parts)))
    log("bench: %.2f images/s at the bench shape, %.2f at inc2, %.2f end to "
        "end; mfu %.4f; profile_step %.4f device ms a step, busy share "
        "%.4f traced, %.4f untraced; NMS %.4f of predict" % (
            bench["value"], out["bench inc2"][0]["value"], e2e["value"],
            bench["mfu"], device_ms, busy[0]["busy_share"],
            profile[0]["busy_share_untraced"], share))
    return out


REMAT_SHAPES = (  # (label, bench shape, batch: None for the shape's)
    ("bench", "bench", None), ("inc2", "inc2", None),
    ("inc2 batch 8", "inc2", 8))
REMAT_TURNS = 4  # turns per arm, alternating
REMAT_STEPS = 8  # steps per turn
REMAT_PEAK_SHAPE = "inc2 batch 8"  # where remat must lower the peak
REMAT_PROFILED_STEPS = 4


def profiled_device_ms(torch, fn, steps):
    """Milliseconds of card time per call of fn(): the sum of the card's
    event times in a torch.profiler trace of `steps` calls (profile_step's
    ``total_device_ms_per_step``). A trace without them raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if not us:
        raise AssertionError("the trace holds no device events")
    return us / 1e3 / steps


def remat_arm(bench, shape, batch, remat):
    """A bench step whose optimizer keeps the gradients it is handed until
    ``del arm.tx.apply``."""
    arm = bench.BenchStep(shape, "cuda", batch_size=batch,
                          second_stage_remat=remat)
    apply = arm.tx.apply

    def capture(params, grads, state):
        arm.grads = dict(grads)
        return apply(params, grads, state)

    arm.tx.apply = capture
    return arm


def differing(torch, a, b):
    """Names of the loss, gradients and params whose bits differ."""
    out = [] if torch.equal(a["loss"], b["loss"]) else ["loss"]
    for kind in ("grads", "params"):
        if a[kind].keys() != b[kind].keys():
            out.append(kind + ": other leaves")
            continue
        out += ["%s %s" % (kind, k) for k in a[kind]
                if not torch.equal(a[kind][k], b[kind][k])]
    return out


def phase_second_stage_remat(torch):
    """The second stage recomputed in the backward against kept, on the
    bench's step at three shapes (see the module's docstring, 9a)."""
    from cap2det_tpu_torch import bench
    from cap2det_tpu_torch.tools import benchlib
    from cap2det_tpu_torch.train import optimizers

    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    cudnn.benchmark, cudnn.deterministic = False, True
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    out = {}
    try:
        for label, shape_name, batch in REMAT_SHAPES:
            shape = bench.SHAPES[shape_name]
            arms = {name: remat_arm(bench, shape, batch, name == "remat")
                    for name in ("plain", "control", "remat")}
            seen = {}
            for name, arm in arms.items():
                want = bench.LAUNCHES[(shape["full_freeze"],
                                       name == "remat")]
                reset_launch_counts()
                arm.run()
                torch.cuda.synchronize()
                launches = launch_counts()
                if launches != want:
                    raise AssertionError(
                        "second_stage_remat: %s: %s launches per step %s, "
                        "expected %s" % (label, name, launches, want))
                seen[name] = {"loss": arm.logs["loss/total_loss"],
                              "grads": arm.grads, "launches": launches,
                              "params": dict(optimizers.flatten_params(
                                  arm.state["params"]))}
                del arm.tx.apply, arm.grads
            for name in ("control", "remat"):
                diff = differing(torch, seen[name], seen["plain"])
                if diff:
                    raise AssertionError(
                        "second_stage_remat: %s: the %s arm's bits differ "
                        "from the plain arm's in %d of loss, gradients and "
                        "params: %s" % (label, name, len(diff), diff[:8]))
            result = {name: {"launches": seen[name]["launches"]}
                      for name in ("plain", "remat")}
            result["loss"] = float(seen["plain"]["loss"])
            del arms["control"], seen
            torch.cuda.empty_cache()

            for name, arm in arms.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                arm.run()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                result[name].update(peak_gb=peak / 1e9,
                                    step_rise_gb=(peak - before) / 1e9)
            times = {name: [] for name in arms}
            for turn in range(REMAT_TURNS):
                order = ("plain", "remat") if turn % 2 == 0 else (
                    "remat", "plain")
                for name in order:
                    times[name].append(benchlib.time_rounds(
                        arms[name].run, "cuda", REMAT_STEPS, 1,
                        warmup=0)["ms"])
            for name, arm in arms.items():
                if not np.isfinite(arm.loss()):
                    raise AssertionError("second_stage_remat: %s: %s loss "
                                         "%r" % (label, name, arm.loss()))
                step_ms = float(np.median(times[name]))
                busy_ms = profiled_device_ms(torch, arm.run,
                                             REMAT_PROFILED_STEPS)
                result[name].update(step_ms=step_ms,
                                    step_ms_min=min(times[name]),
                                    step_ms_max=max(times[name]),
                                    turns_ms=times[name],
                                    device_ms=busy_ms,
                                    busy_share=busy_ms / step_ms)
            result["batch"] = arms["plain"].batch_size
            result["num_proposals"] = shape["num_proposals"]
            result["full_freeze"] = shape["full_freeze"]
            out[label] = result
            log("second_stage_remat: %s: bit for bit (control and remat); "
                "peak %.4f GB plain, %.4f GB remat; step %.4f ms plain, "
                "%.4f remat (medians of %d turns of %d); device %.4f ms "
                "plain, %.4f remat" % (
                    label, result["plain"]["peak_gb"],
                    result["remat"]["peak_gb"], result["plain"]["step_ms"],
                    result["remat"]["step_ms"], REMAT_TURNS, REMAT_STEPS,
                    result["plain"]["device_ms"],
                    result["remat"]["device_ms"]))
            del arms
            torch.cuda.empty_cache()
    finally:
        cudnn.benchmark, cudnn.deterministic = saved[:2]
        torch.use_deterministic_algorithms(saved[2])
    peaks = out[REMAT_PEAK_SHAPE]
    if not peaks["remat"]["peak_gb"] < peaks["plain"]["peak_gb"]:
        raise AssertionError("second_stage_remat: at %s the peak with remat "
                             "%.4f GB is not below the plain %.4f GB" % (
                                 REMAT_PEAK_SHAPE, peaks["remat"]["peak_gb"],
                                 peaks["plain"]["peak_gb"]))
    log("second_stage_remat " + json.dumps({
        "shapes": out, "turns": REMAT_TURNS, "steps_per_turn": REMAT_STEPS,
        "clock": "cuda events", "card": card_name_and_limit(),
        "seconds": time.perf_counter() - t0}))
    return out


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
            "maxpool_grad": 2, "avgpool_grad": 1, "fused_optimizer": 1,
            "nms": 0, "bn_fold": 1, "bn_fold_grad": 1}


def run_train(torch, trainer, cfg, model_dir, steps, profile_steps=None,
              device="cuda", pretrained_checkpoint=None):
    """trainer.train() on the card with a hook that records, per step, a
    CUDA event and the host clock at its end, the loop's wait on the
    input pipeline, its pinning and queuing of the batches' copies, the
    canvas (None for a text batch), the loss (a tensor, read later) and
    the kernel launches. Returns (state, records,
    start event, host start, wall seconds)."""
    records = []
    previous = [launch_counts()]

    def hook(step, state, logs):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        now = launch_counts()
        canvas = None  # a text batch has none
        if "input/canvas_height" in logs:
            canvas = (int(logs["input/canvas_height"]),
                      int(logs["input/canvas_width"]))
        records.append({
            "step": step, "host": time.perf_counter(), "event": end,
            "wait": logs["input/wait_sec"],
            "place": logs["input/place_sec"], "canvas": canvas,
            "loss": logs["loss/total_loss"],
            "launches": {k: now[k] - previous[0][k] for k in KERNELS}})
        previous[0] = now

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t_start = time.perf_counter()
    state = trainer.train(cfg, model_dir=model_dir, max_steps=steps,
                          hooks=[hook], profile_steps=profile_steps,
                          device=device,
                          pretrained_checkpoint=pretrained_checkpoint)
    torch.cuda.synchronize()
    return state, records, start, t_start, time.perf_counter() - t_start


def report_steps(tag, records, start, t_start, train_config,
                 phase="train_loop"):
    """Logs, per canvas bucket, the step's time on the card's timeline
    (event to event) and on the host clock (hook to hook), the loop's
    wait on the input pipeline and its time placing batches. A bucket's
    first step, and the steps that wrote metrics or a checkpoint, are
    reported apart. Returns the medians over the other steps."""
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
    for canvas in sorted(per_bucket, key=lambda c: c or ()):
        b = per_bucket[canvas]
        first = b["first"]
        line = {"run": tag, "bucket": "%dx%d" % canvas if canvas else "text",
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
        log(phase + ": " + json.dumps(line))
    log(phase + ": %s: steps that wrote metrics or a checkpoint: %s" % (
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
    log(phase + ": %s: over %d steps (no bucket's first, none that wrote),"
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
    and the fused optimizer 1
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
        from cap2det_tpu_torch.kernels import build

        log("train_loop: the feed read its records through "
            "native.read_records_native (host library %s, %s in %.3f s in "
            "this process before its worker started); the first step "
            "waited %.3f s on the feed, its placing %.3f s" % (
                build.host_build_info["key"],
                "built" if build.host_build_info["built"] else "loaded",
                build.host_build_info["seconds"], records[0]["wait"],
                records[0]["place"]))
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
    checkpoint, reports, promotion, launches K1 4x8x2, K4 12x8x2 and NMS
    4x8x2 with no backward kernel, each checkpoint's detections its own; seconds per
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
                    pool_fwd=3 * num_scales * per_run,
                    nms=iterations * per_run, bn_fold=len(EVAL_STEPS))
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
    if min(evaluated["roi_crop_maxpool"], evaluated["pool_fwd"],
           evaluated["nms"]) < 1 or trained["nms"]:
        raise AssertionError("overfit_map: training launched %s, the "
                             "daemon %s" % (trained, evaluated))


# The text model at configs/coco17_text.pbtxt width: data/coco_open_vocab.txt
# (7379 words + OOV) with a seeded stand-in for its 300-d GloVe table, which
# is not in the repository. GloVe's components have a spread of about 0.4.
GLOVE_DIMS = 300
GLOVE_STD = 0.4
TEXT_TRAIN_RECORDS = 400
TEXT_EVAL_RECORDS = 100
TEXT_STEPS = 300
TEXT_SAVE_EVERY = 100  # three checkpoints for the daemon
# Card float32 against CPU float32 logits: products over 300 and 400 terms
# summed in another order (TF32 off).
TEXT_LOGIT_TOL = (1e-4, 1e-5)  # (rtol, atol)
# A classifier label that flips between the card and the CPU further than
# this from label_threshold (in probability) is no rounding difference.
FLIP_MARGIN = 1e-4
TEXT_CAP2DET_STEPS = 12
WORD_VECTOR_STEPS = 4
COCO_TRAIN_PATTERN = '"output/records/coco17_train.record*"'
COCO_VAL_PATTERN = '"output/records/coco17_val.record*"'
GLOVE_FILE = "'data/coco_open_vocab_300d.npy'"
TEXT_CHECKPOINT = "'zoo/coco17_text'"


def shipped_config_text(name, replacements):
    """The text of configs/<name> with each (old, new) replaced; raises if
    an `old` is not in it."""
    with open(os.path.join("configs", name)) as f:
        text = f.read()
    for old, new in replacements:
        if old not in text:
            raise AssertionError("%s has no %s" % (name, old))
        text = text.replace(old, new)
    return text


def write_text_inputs(directory):
    """A seeded stand-in for data/coco_open_vocab_300d.npy ([7379, 300],
    normal with GloVe's spread) and seeded text-only records whose
    captions name COCO classes (data/synthetic.py, with_image=False):
    TEXT_TRAIN_RECORDS for training, TEXT_EVAL_RECORDS for evaluation.
    Returns (embedding file, train record, eval record)."""
    from cap2det_tpu_torch.data import synthetic
    from cap2det_tpu_torch.text import vocab

    words = vocab.load_lines(os.path.join("data", "coco_open_vocab.txt"))
    classes = vocab.load_lines(os.path.join("data", "coco_label.txt"))
    emb_file = os.path.join(directory, "coco_open_vocab_300d.npy")
    np.save(emb_file, (GLOVE_STD * np.random.default_rng(SEED + 20)
                       .standard_normal((len(words), GLOVE_DIMS)))
            .astype(np.float32))
    records = []
    for name, count, seed in (("train", TEXT_TRAIN_RECORDS, SEED + 21),
                              ("val", TEXT_EVAL_RECORDS, SEED + 22)):
        records.append(synthetic.write_synthetic_dataset(
            os.path.join(directory, "text-%s.record" % name),
            num_examples=count, seed=seed, classes=classes,
            with_image=False))
    return (emb_file,) + tuple(records)


def phase_text_model(torch, directory):
    """text_model: configs/coco17_text.pbtxt as shipped (7379 words + OOV,
    a seeded [7379, 300] stand-in table, hidden 400, 80 classes, batch 20,
    64 caption tokens, dropout 0.5, regularizer 1e-5, Adagrad lr 0.1) over
    seeded text-only records: train() for TEXT_STEPS steps with a
    checkpoint every TEXT_SAVE_EVERY, then continuous_evaluation
    (evaluate_all) over the checkpoints. No kernel launches in either (the
    counts set to 0 just before each). The step on the card's timeline and
    the host clock, the feed's wait, peak memory, the loss falling; P/R
    per checkpoint and seconds per checkpoint. Card against CPU: one
    float32 batch's logits within TEXT_LOGIT_TOL, and the dropout's
    division by 0.5 and 0.7 bit for bit.

    Returns the model_dir and the stand-in table's path."""
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.eval import evaluator
    from cap2det_tpu_torch.models import registry
    from cap2det_tpu_torch.text import classifier
    from cap2det_tpu_torch.train import trainer

    t0 = time.perf_counter()
    emb_file, train_record, eval_record = write_text_inputs(directory)
    log("text_model: wrote a [7379, %d] stand-in table and %d + %d text "
        "records in %.1f s" % (GLOVE_DIMS, TEXT_TRAIN_RECORDS,
                               TEXT_EVAL_RECORDS, time.perf_counter() - t0))
    cfg = schema.loads_pipeline(shipped_config_text("coco17_text.pbtxt", [
        (COCO_TRAIN_PATTERN, '"%s"' % train_record),
        (COCO_VAL_PATTERN, '"%s"' % eval_record),
        (GLOVE_FILE, "'%s'" % emb_file)]))
    cfg.train_config.save_checkpoints_steps = TEXT_SAVE_EVERY
    model_dir = os.path.join(directory, "text_model")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, records, start, t_start, wall = run_train(
        torch, trainer, cfg, model_dir, TEXT_STEPS)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # No kernel of the detector runs; the fused optimizer updates the
    # classifier's leaves once a step.
    want = dict.fromkeys(KERNELS, 0)
    want["fused_optimizer"] = TEXT_STEPS
    if launches != want:
        raise AssertionError("text_model: the text step launched %s, "
                             "expected %s" % (launches, want))
    losses = [float(r["loss"]) for r in records]
    if [r["step"] for r in records] != list(range(1, TEXT_STEPS + 1)) or (
            not np.all(np.isfinite(losses))):
        raise AssertionError("text_model: steps %s, losses %s" % (
            [r["step"] for r in records], losses))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first:
        raise AssertionError("text_model: the loss did not fall: %r -> %r"
                             % (first, last))
    medians = report_steps("train()", records, start, t_start,
                           cfg.train_config, phase="text_model")
    log("text_model: %d steps in %.2f s; loss %r -> %r (mean of the first "
        "and last 10: %r -> %r); launches %s; peak memory %d bytes" % (
            TEXT_STEPS, wall, losses[0], losses[-1], first, last,
            json.dumps(launches), peak))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    best = evaluator.continuous_evaluation(
        cfg, model_dir=model_dir, max_idle_polls=0, evaluate_all=True,
        poll_interval_secs=0)
    eval_wall = time.perf_counter() - t0
    eval_launches = launch_counts()
    if any(eval_launches.values()):
        raise AssertionError("text_model: evaluation launched %s"
                             % eval_launches)
    with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [TEXT_SAVE_EVERY * (i + 1)
             for i in range(TEXT_STEPS // TEXT_SAVE_EVERY)]
    if [r["step"] for r in rows] != steps or any(
            r["num_examples"] != TEXT_EVAL_RECORDS for r in rows):
        raise AssertionError("text_model: eval rows %s" % rows)
    for r in rows:
        log("text_model: eval " + json.dumps(
            {k: v for k, v in r.items()
             if k.startswith(("metrics/", "eval/")) or k == "step"}))
    log("text_model: daemon over %d checkpoints in %.2f s, best %s, "
        "launches %s, peak memory %d bytes" % (
            len(rows), eval_wall, best, json.dumps(eval_launches),
            torch.cuda.max_memory_allocated()))

    # One float32 batch's logits, the card against the CPU.
    pipe = pipeline_lib.build_input_pipeline(
        cfg.train_reader, seed=SEED, **registry.build(
            cfg.model, device="cpu").pipeline_kwargs())
    it = iter(pipe)
    try:
        host = next(it)
    finally:
        it.close()
    tree = params_lib.to_jax_numpy(state["params"])
    logits = {}
    for device in ("cuda", "cpu"):
        model = registry.build(cfg.model, device=device)
        logits[device] = model.predict_logits(
            params_lib.from_jax_numpy(tree, device),
            model.device_batch(host)).detach().cpu()
    rtol, atol = TEXT_LOGIT_TOL
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=rtol,
                               atol=atol)
    x = torch.from_numpy(np.random.default_rng(SEED + 23).uniform(
        0.0, 3.0, (20, 400)).astype(np.float32))
    differ = {}
    for keep in (0.5, 0.7):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        got = classifier.dropout(x.cuda(), keep, gen).cpu()
        want = torch.where(got != 0, x / torch.tensor(keep),
                           torch.zeros_like(x))
        differ[keep] = int((got != want).sum())
    log("text_model: card vs CPU logits of a [%d, %d] batch, max|err| %r "
        "(rtol %g, atol %g); dropout x / keep over %d values differs in %s"
        % (tuple(host["concat_caption_token_ids"].shape) + (
            float((logits["cuda"] - logits["cpu"]).abs().max()), rtol, atol,
            x.numel(), json.dumps(differ))))
    if any(differ.values()):
        raise AssertionError("text_model: the dropout's division differs")
    log("text_model: " + json.dumps({
        "median_event_ms": medians["event_ms"],
        "median_host_s": medians["host_s"],
        "median_wait_s": medians["wait_s"], "peak_bytes": peak,
        "first_loss": losses[0], "last_loss": losses[-1],
        "seconds_per_checkpoint": [r["eval/seconds_per_checkpoint"]
                                   for r in rows],
        "recall_at_0.5": [r["metrics/recall_at_0.5"] for r in rows],
        "precision_at_1": [r["metrics/precision_at_1"] for r in rows]}))
    return model_dir, emb_file


def write_synonym_records(directory, image_hw=(480, 640), count=8):
    """Seeded PNG records at coco17's shape whose captions name a
    single-word synonym of a COCO class (data/coco_label_synonyms.txt)
    and no class name: no exact match, so the text classifier labels
    them."""
    from cap2det_tpu_torch.data import synthetic
    from cap2det_tpu_torch.text import vocab

    classes, name2id = vocab.load_synonym_table(
        os.path.join("data", "coco_label_synonyms.txt"))
    words = set(vocab.load_lines(os.path.join("data",
                                              "coco_open_vocab.txt")))
    synonyms = sorted(n for n in name2id if n in words and n not in classes)
    return synthetic.write_synthetic_dataset(
        os.path.join(directory, "train-synonym.record"), num_examples=count,
        seed=SEED + 24, classes=synonyms, image_hw=image_hw,
        num_proposals=TRAIN_P, smooth=True)


def labels_card_vs_cpu(torch, extractor_cfg, texts):
    """The text classifier's labels for `texts` on the card and on the CPU
    (the extractor Cap2Det builds): every flip of sigmoid > threshold,
    with its margin to the threshold; raises on a flip further than
    FLIP_MARGIN. Returns (CPU labels, exact-match rows, flips)."""
    from cap2det_tpu_torch.text import extractors

    ex = {d: extractors.build_label_extractor(extractor_cfg, device=d)
          for d in ("cuda", "cpu")}
    labels = {d: e.extract_labels(texts) for d, e in ex.items()}
    ids = ex["cpu"].encode_tokens(texts)
    probas = {d: 1.0 / (1.0 + np.exp(-e.predict_logits(ids).cpu().numpy()))
              for d, e in ex.items()}
    threshold = extractor_cfg.text_classifier_match_extractor.label_threshold
    flips = [{"caption": i, "class": int(c),
              "margin": float(abs(probas["cpu"][i, c] - threshold))}
             for i, c in zip(*np.nonzero((probas["cuda"] > threshold)
                                         != (probas["cpu"] > threshold)))]
    exact = extractors.match_labels(
        texts, {c: i for i, c in enumerate(ex["cpu"].classes)},
        ex["cpu"].num_classes).any(axis=1)
    log("text_cap2det: labels card vs CPU over %d captions x %d classes: "
        "%d classifier flips %s; labels differ in %d rows; least margin to "
        "the threshold %r" % (
            len(texts), ex["cpu"].num_classes, len(flips), json.dumps(flips),
            int((labels["cuda"] != labels["cpu"]).any(axis=1).sum()),
            float(np.abs(probas["cpu"] - threshold).min())))
    if any(f["margin"] > FLIP_MARGIN for f in flips):
        raise AssertionError("text_cap2det: a label flipped further than %g "
                             "from the threshold" % FLIP_MARGIN)
    return labels["cpu"], exact, flips


def phase_text_cap2det(torch, directory, text_model_dir, emb_file):
    """text_cap2det: Cap2Det train() at
    configs/coco17_text_classifier_match.pbtxt as shipped, its text
    classifier warm-started from the text_model phase's model_dir, over
    train_loop's PNG records plus records whose captions name only
    synonyms: launches per step K1 1, K4 3, K2 1, K5 2, K6 1 and the fused
    optimizer 1 through at
    least two canvas buckets (counts set to 0 just before), step medians,
    peak memory; the images the classifier labelled beyond an exact
    match; the extractor's labels on the card against the CPU's. Then
    WORD_VECTOR_STEPS steps of configs/coco17_word_vector_match.pbtxt.

    Returns the launches of the text_classifier_match run."""
    import glob

    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.data import tfrecord
    from cap2det_tpu_torch.train import trainer

    pattern = write_train_records(directory, 8, (480, 640), SEED + 9)
    write_synonym_records(directory)
    replacements = [(COCO_TRAIN_PATTERN, '"%s"' % pattern),
                    (GLOVE_FILE, "'%s'" % emb_file)]
    cfg = schema.loads_pipeline(shipped_config_text(
        "coco17_text_classifier_match.pbtxt", replacements + [
            (TEXT_CHECKPOINT, "'%s'" % text_model_dir)]))
    cfg.train_config.log_step_count_steps = 5
    extractor_cfg = cfg.model.cap2det_model.label_extractor

    texts = [pipeline_lib.parse_example(record, False)["concat_tokens"]
             for path in sorted(glob.glob(pattern))
             for record in tfrecord.read_records(path)]
    labels, exact, flips = labels_card_vs_cpu(torch, extractor_cfg, texts)
    beyond = int((labels.any(axis=1) & ~exact).sum())
    log("text_cap2det: %d images, %d with an exact class match; the "
        "classifier labelled %d of the other %d (%d labels)" % (
            len(texts), int(exact.sum()), beyond, int((~exact).sum()),
            int(labels[~exact].sum())))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    _, records, start, t_start, wall = run_train(
        torch, trainer, cfg, os.path.join(directory, "text_cap2det"),
        TEXT_CAP2DET_STEPS)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    bad = [r["step"] for r in records if r["launches"] != PER_STEP]
    buckets = {r["canvas"] for r in records}
    if bad or len(records) != TEXT_CAP2DET_STEPS or len(buckets) < 2:
        raise AssertionError("text_cap2det: steps %s launched other than %s;"
                             " %d steps; buckets %s" % (
                                 bad, PER_STEP, len(records), buckets))
    losses = [float(r["loss"]) for r in records]
    if not np.all(np.isfinite(losses)):
        raise AssertionError("text_cap2det: losses %s" % losses)
    medians = report_steps("text_classifier_match", records, start, t_start,
                           cfg.train_config, phase="text_cap2det")
    log("text_cap2det: %d steps in %.2f s through %d canvas buckets; "
        "launches %s (per step %s); losses %s; peak memory %d bytes" % (
            TEXT_CAP2DET_STEPS, wall, len(buckets), json.dumps(launches),
            json.dumps(PER_STEP), json.dumps(losses), peak))

    cfg = schema.loads_pipeline(shipped_config_text(
        "coco17_word_vector_match.pbtxt", replacements))
    reset_launch_counts()
    _, wv_records, start, _, wv_wall = run_train(
        torch, trainer, cfg, os.path.join(directory, "word_vector"),
        WORD_VECTOR_STEPS)
    wv_launches = launch_counts()
    if [r["launches"] for r in wv_records] != [PER_STEP] * WORD_VECTOR_STEPS:
        raise AssertionError("text_cap2det: word_vector_match launched %s"
                             % [r["launches"] for r in wv_records])
    event_ms = [(prev["event"] if prev else start).elapsed_time(r["event"])
                for prev, r in zip([None] + wv_records[:-1], wv_records)]
    log("text_cap2det: word_vector_match %d steps in %.2f s, step ms on the "
        "card %s, canvases %s, losses %s, launches %s" % (
            WORD_VECTOR_STEPS, wv_wall, json.dumps(event_ms),
            json.dumps([r["canvas"] for r in wv_records]),
            json.dumps([float(r["loss"]) for r in wv_records]),
            json.dumps(wv_launches)))
    log("text_cap2det: " + json.dumps({
        "median_event_ms": medians["event_ms"],
        "median_host_s": medians["host_s"],
        "median_wait_s": medians["wait_s"], "peak_bytes": peak,
        "labelled_beyond_exact": beyond, "flips": len(flips),
        "buckets": len(buckets)}))
    return launches


DS_IMAGES = 12
DS_HW = (480, 640)  # the rich scenes' height and width
DS_STEPS = 12
DS_SS_PROCESSES = 2
DS_GLOVE_DIMS = 300
DS_FIXTURES = os.path.join("tests", "data_torch", "tf_checkpoint")
DS_VAL_IMAGES = 3  # val2017: the first train scenes again, under new ids
DS_LAYOUT_IMAGES = 4  # scenes in each of the VOC and Flickr30k layouts
DS_BUILD_TIMEOUT = 300.0  # seconds for one builder script


def _iou_matrix(a, b):
    """[len(a), len(b)] IoU of normalized [ymin, xmin, ymax, xmax] boxes."""
    a, b = np.asarray(a, np.float64)[:, None], np.asarray(b, np.float64)[None]
    ih = np.clip(np.minimum(a[..., 2], b[..., 2])
                 - np.maximum(a[..., 0], b[..., 0]), 0, None)
    iw = np.clip(np.minimum(a[..., 3], b[..., 3])
                 - np.maximum(a[..., 1], b[..., 1]), 0, None)
    inter = ih * iw
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    return inter / np.maximum(area(a) + area(b) - inter, 1e-12)


def flat_leaves(tree, prefix=""):
    """[(path, leaf)] of a nested dict, in sorted key order."""
    out = []
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            out += flat_leaves(value, prefix + key + "/")
        else:
            out.append((prefix + key, value))
    return out


def write_coco_layout(directory, scenes, classes):
    """The rich scenes as a COCO split: <dir>/train2017/%012d.jpg (image
    id i + 1), captions JSON (two captions each, naming the scene's
    objects by COCO class name) and instances JSON (pixel boxes). Returns
    (image dir, captions file, instances file, {file stem: gt boxes})."""
    import shutil

    from cap2det_tpu_torch.tools import make_rich_synthetic_dataset as rich

    img_dir = os.path.join(directory, "train2017")
    os.makedirs(img_dir)
    h, w = DS_HW
    names = {cls: classes[i] for i, cls in enumerate(rich.CLASSES)}
    images, caps, insts, gt = [], [], [], {}
    for i, row in enumerate(scenes):
        image_id, file_name = i + 1, "%012d.jpg" % (i + 1)
        shutil.copy(os.path.join(directory, "rich", "images",
                                 row["image_id"] + ".jpg"),
                    os.path.join(img_dir, file_name))
        images.append({"id": image_id, "file_name": file_name, "height": h,
                       "width": w})
        objects = [names[c] for c in row["classes"]]
        caps.append({"image_id": image_id, "id": 2 * i, "caption":
                     "A photo of a %s." % " and a ".join(objects)})
        caps.append({"image_id": image_id, "id": 2 * i + 1, "caption":
                     "There is a %s next to the background" % objects[-1]})
        for j, (box, name) in enumerate(zip(row["boxes"], objects)):
            y0, x0, y1, x1 = box
            insts.append({"image_id": image_id, "id": 100 * image_id + j,
                          "category_id": classes.index(name) + 1,
                          "bbox": [x0 * w, y0 * h, (x1 - x0) * w,
                                   (y1 - y0) * h]})
        gt[file_name[:-4]] = np.asarray(row["boxes"], np.float32)
    categories = [{"id": k + 1, "name": c} for k, c in enumerate(classes)]
    cap_file = os.path.join(directory, "captions_train2017.json")
    inst_file = os.path.join(directory, "instances_train2017.json")
    with open(cap_file, "w") as f:
        json.dump({"images": images, "annotations": caps}, f)
    with open(inst_file, "w") as f:
        json.dump({"images": images, "annotations": insts,
                   "categories": categories}, f)
    return img_dir, cap_file, inst_file, gt


def write_stand_in_glove(path, words, seed):
    """A GloVe-format text file: each word and DS_GLOVE_DIMS seeded
    values, plus a multi-token key as glove.840B has."""
    rng = np.random.default_rng(seed)
    with open(path, "w", encoding="utf-8") as f:
        for word in list(words) + [". . ."]:
            f.write(word + " " + " ".join(
                "%.5f" % v for v in rng.normal(0, 0.4, DS_GLOVE_DIMS)) + "\n")


def write_builder_layouts(directory, img_dir, cap_file, inst_file, glove):
    """The data dirs of the three dataset builders over the phase's scenes:
    coco/ (train2017 the phase's own, val2017 the first DS_VAL_IMAGES
    scenes under new ids, annotations/, glove.6B.300d.txt), voc/VOC2007
    (DS_LAYOUT_IMAGES scenes with XML boxes, two in trainval.txt and the
    rest in test.txt) and flickr30k/ (the next DS_LAYOUT_IMAGES scenes,
    their captions as results_20130124.token). Returns {name: (data dir,
    {image stem: the train2017 stem whose image has the same bytes})}."""
    import shutil

    with open(cap_file) as f:
        caps = json.load(f)
    with open(inst_file) as f:
        insts = json.load(f)
    entries = sorted(caps["images"], key=lambda e: e["id"])
    categories = {c["id"]: c["name"] for c in insts["categories"]}

    def copy(entry, dest, stem):
        shutil.copy(os.path.join(img_dir, entry["file_name"]),
                    os.path.join(dest, stem + ".jpg"))
        return stem, entry["file_name"][:-4]

    coco = os.path.join(directory, "coco")
    notes = os.path.join(coco, "annotations")
    os.makedirs(os.path.join(coco, "val2017"))
    os.makedirs(notes)
    os.symlink(img_dir, os.path.join(coco, "train2017"))
    os.symlink(glove, os.path.join(coco, "glove.6B.300d.txt"))
    shutil.copy(cap_file, os.path.join(notes, "captions_train2017.json"))
    shutil.copy(inst_file, os.path.join(notes, "instances_train2017.json"))
    coco_same = {e["file_name"][:-4]: e["file_name"][:-4] for e in entries}
    new_id = {e["id"]: e["id"] + len(entries)
              for e in entries[:DS_VAL_IMAGES]}
    for e in entries[:DS_VAL_IMAGES]:
        stem, same = copy(e, os.path.join(coco, "val2017"),
                          "%012d" % new_id[e["id"]])
        coco_same[stem] = same
    for src, name in ((caps, "captions_val2017.json"),
                      (insts, "instances_val2017.json")):
        with open(os.path.join(notes, name), "w") as f:
            json.dump(dict(src, images=[
                dict(e, id=new_id[e["id"]],
                     file_name="%012d.jpg" % new_id[e["id"]])
                for e in src["images"] if e["id"] in new_id],
                annotations=[dict(a, image_id=new_id[a["image_id"]])
                             for a in src["annotations"]
                             if a["image_id"] in new_id]), f)

    voc = os.path.join(directory, "voc")
    year = os.path.join(voc, "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(year, sub))
    voc_same = {}
    picked = entries[:DS_LAYOUT_IMAGES]
    for e in picked:
        stem, same = copy(e, os.path.join(year, "JPEGImages"),
                          e["file_name"][:-4])
        voc_same[stem] = same
        objects = "".join(
            "<object><name>%s</name><difficult>0</difficult><bndbox>"
            "<xmin>%.1f</xmin><ymin>%.1f</ymin><xmax>%.1f</xmax>"
            "<ymax>%.1f</ymax></bndbox></object>" % (
                categories[a["category_id"]], a["bbox"][0], a["bbox"][1],
                a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3])
            for a in insts["annotations"] if a["image_id"] == e["id"])
        with open(os.path.join(year, "Annotations", stem + ".xml"), "w") as f:
            f.write("<annotation><size><width>%d</width><height>%d</height>"
                    "</size>%s</annotation>" % (e["width"], e["height"],
                                                objects))
    for split, part in (("trainval", picked[:2]), ("test", picked[2:])):
        with open(os.path.join(year, "ImageSets", "Main", split + ".txt"),
                  "w") as f:
            f.write("".join(e["file_name"][:-4] + "\n" for e in part))

    flickr = os.path.join(directory, "flickr30k")
    images = os.path.join(flickr, "flickr30k_images")
    os.makedirs(images)
    os.symlink(glove, os.path.join(flickr, "glove.6B.300d.txt"))
    flickr_same, lines = {}, []
    for e in entries[DS_LAYOUT_IMAGES:2 * DS_LAYOUT_IMAGES]:
        stem, same = copy(e, images, e["file_name"][:-4])
        flickr_same[stem] = same
        lines += ["%s.jpg#%d\t%s" % (stem, k, a["caption"]) for k, a in
                  enumerate(a for a in caps["annotations"]
                            if a["image_id"] == e["id"])]
    with open(os.path.join(flickr, "results_20130124.token"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"coco": (coco, coco_same), "voc": (voc, voc_same),
            "flickr30k": (flickr, flickr_same)}


def record_multiset(pattern):
    """The sorted record bytes of every shard matching `pattern` (CRCs
    checked) and the number of shards."""
    import glob

    from cap2det_tpu_torch.data import tfrecord

    shards = sorted(glob.glob(pattern))
    return sorted(r for s in shards for r in tfrecord.read_records(
        s, verify_crc=True)), len(shards)


def run_builder(name, data_dir, out_dir, cwd, nproc):
    """``python -m cap2det_tpu_torch.scripts.build_<name>_dataset`` as a
    user runs it, from `cwd` (whose data/ takes the vocabulary); returns
    its wall seconds."""
    from cap2det_tpu_torch.scripts import steps

    os.makedirs(os.path.join(cwd, "data"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "cap2det_tpu_torch.scripts.build_%s_dataset" % name, data_dir,
         out_dir, str(nproc)], cwd=cwd, env=steps.env(), capture_output=True,
        text=True, timeout=DS_BUILD_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("dataset_build: build_%s_dataset exited %d:\n%s"
                             % (name, proc.returncode, proc.stderr[-3000:]))
    return wall


def check_dataset_builders(directory, img_dir, cap_file, inst_file, glove,
                           ss_dir, train_records):
    """The three dataset builders (``cap2det_tpu_torch.scripts.build_{coco,
    voc,flickr30k}_dataset``, DS_SS_PROCESSES selective-search processes
    each) over write_builder_layouts' data dirs, each from a working
    directory of its own, held against the port's tools run by hand with
    the flags the shell scripts pass: every ``.npy`` byte for byte against
    the phase's own selective search of the same image (`ss_dir`), the
    records as a multiset of record bytes (the shard counts differ from
    `train_records`' two), the vocabulary files byte for byte. Returns
    each builder's wall seconds and images."""
    from cap2det_tpu_torch.tools import create_coco_tf_record
    from cap2det_tpu_torch.tools import create_flickr30k_tf_record
    from cap2det_tpu_torch.tools import create_pascal_tf_record
    from cap2det_tpu_torch.tools import create_vocab

    layouts = write_builder_layouts(directory, img_dir, cap_file, inst_file,
                                    glove)
    hand = os.path.join(directory, "by_hand")
    os.makedirs(hand)
    report = {}
    for name in ("coco", "voc", "flickr30k"):
        data, same = layouts[name]
        out = os.path.join(directory, name + "_out")
        cwd = os.path.join(directory, name + "_cwd")
        wall = run_builder(name, data, out, cwd, DS_SS_PROCESSES)
        report[name] = {"images": len(same), "wall_s": wall,
                        "s_per_image": wall / len(same)}

        npys = sorted(os.listdir(os.path.join(out, "ss_npy")))
        if npys != sorted(s + ".npy" for s in same):
            raise AssertionError("dataset_build: build_%s_dataset wrote %s"
                                 % (name, npys))
        for stem, twin in same.items():
            with open(os.path.join(out, "ss_npy", stem + ".npy"), "rb") as f:
                got = f.read()
            with open(os.path.join(ss_dir, twin + ".npy"), "rb") as f:
                if got != f.read():
                    raise AssertionError("dataset_build: build_%s_dataset's "
                                         "%s.npy differs" % (name, stem))

        # (records written by the builder, by hand, shards the shell asks)
        pairs = []
        if name == "coco":
            val_ss = os.path.join(hand, "val_ss_npy")
            os.makedirs(val_ss)
            for stem in os.listdir(os.path.join(data, "val2017")):
                stem = stem[:-4]
                os.symlink(os.path.join(ss_dir, same[stem] + ".npy"),
                           os.path.join(val_ss, stem + ".npy"))
            create_coco_tf_record.main([
                "--image_dir", os.path.join(data, "val2017"),
                "--caption_annotations_file",
                os.path.join(data, "annotations", "captions_val2017.json"),
                "--instance_annotations_file",
                os.path.join(data, "annotations", "instances_val2017.json"),
                "--proposal_data_path", val_ss, "--output_path",
                os.path.join(hand, "coco17_val.record"), "--num_shards", "5"])
            pairs += [("coco17_train.record", train_records, 100),
                      ("coco17_val.record",
                       os.path.join(hand, "coco17_val.record"), 5)]
            vocab_flags = ["--caption_annotations_file",
                           os.path.join(data, "annotations",
                                        "captions_train2017.json"),
                           "--min_word_freq", "20"]
        elif name == "voc":
            for split in ("trainval", "test"):
                record = os.path.join(hand, "VOC2007_%s.record" % split)
                create_pascal_tf_record.main([
                    "--data_dir", data, "--year", "VOC2007", "--set", split,
                    "--proposal_data_path", ss_dir, "--output_path", record,
                    "--num_shards", "5"])
                pairs.append(("VOC2007_%s.record" % split, record, 5))
            vocab_flags = None
        else:
            record = os.path.join(hand, "flickr30k_trainval.record")
            tsv = os.path.join(data, "results_20130124.token")
            create_flickr30k_tf_record.main([
                "--image_source", os.path.join(data, "flickr30k_images"),
                "--annotation_path", tsv, "--proposal_data_path", ss_dir,
                "--output_path", record, "--num_shards", "20"])
            pairs.append(("flickr30k_trainval.record", record, 20))
            vocab_flags = ["--caption_tsv_file", tsv, "--min_word_freq",
                           "10"]
        count = 0
        for built, by_hand, shards in pairs:
            got, n_got = record_multiset(
                os.path.join(out, "records", built + "-*"))
            want, _ = record_multiset(by_hand + "-*")
            if n_got != shards or not got or got != want:
                raise AssertionError(
                    "dataset_build: build_%s_dataset's %s: %d records in %d "
                    "shards, by hand %d" % (name, built, len(got), n_got,
                                            len(want)))
            count += len(got)
        if count != len(same):
            raise AssertionError("dataset_build: build_%s_dataset wrote %d "
                                 "records of %d images" % (name, count,
                                                           len(same)))

        built = sorted(os.listdir(os.path.join(cwd, "data")))
        if vocab_flags is None:
            if built:
                raise AssertionError("dataset_build: build_voc_dataset wrote "
                                     "%s" % built)
            continue
        vocab_file = os.path.join(hand, name + "_open_vocab.txt")
        emb_file = os.path.join(hand, name + "_open_vocab_300d.npy")
        kept, _ = create_vocab.main(vocab_flags + [
            "--glove_file", os.path.join(data, "glove.6B.300d.txt"),
            "--output_vocabulary_file", vocab_file,
            "--output_vocabulary_word_embedding_file", emb_file])
        want = [name + "_open_vocab.txt", name + "_open_vocab_300d.npy"]
        if built != want or not kept:
            raise AssertionError("dataset_build: build_%s_dataset's data/ "
                                 "holds %s; %d words by hand" % (
                                     name, built, len(kept)))
        for mine, theirs in zip(want, (vocab_file, emb_file)):
            with open(os.path.join(cwd, "data", mine), "rb") as f:
                got = f.read()
            with open(theirs, "rb") as f:
                if got != f.read():
                    raise AssertionError("dataset_build: build_%s_dataset's "
                                         "%s differs" % (name, mine))
        report[name]["vocabulary"] = len(kept)
    return report


def phase_dataset_build(torch):
    """The README's quick start from cap2det_tpu_torch alone, at the full
    width of configs/coco17_extend_match.pbtxt: seeded rich scenes as
    JPEG (make_rich_synthetic_dataset), a COCO layout naming COCO
    classes, selective search in DS_SS_PROCESSES processes
    (create_selective_search_data, the host C++ library built from the
    checkout), COCO TFRecords (create_coco_tf_record, 2 shards), the
    vocabulary over a stand-in GloVe file (create_vocab), the passthrough
    backbone (make_passthrough_checkpoint) and the committed TensorFlow V1
    and V2 fixtures converted without TensorFlow (convert_tf_checkpoint),
    then train() over the records from the passthrough backbone (launches
    per step K1 1, K4 3, K2 1, K5 2, K6 1, the fused optimizer 1; counts
    set to 0 just before),
    one COCO evaluation of its last checkpoint, and the three dataset
    builders held against those tools (check_dataset_builders). Returns
    the launches of that train()."""
    import glob
    import importlib.util
    import io
    import tempfile

    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.data import tfrecord
    from cap2det_tpu_torch.eval import evaluator
    from cap2det_tpu_torch.kernels import build
    from cap2det_tpu_torch.text import vocab
    from cap2det_tpu_torch.tools import convert_tf_checkpoint
    from cap2det_tpu_torch.tools import create_coco_tf_record
    from cap2det_tpu_torch.tools import create_selective_search_data as ss
    from cap2det_tpu_torch.tools import create_vocab
    from cap2det_tpu_torch.tools import make_passthrough_checkpoint
    from cap2det_tpu_torch.tools import make_rich_synthetic_dataset as rich
    from cap2det_tpu_torch.train import trainer

    cpu, cores = host_cpu()
    log("dataset_build: host CPU %s, %d logical cores" % (cpu, cores))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_") as tmp:
        # 1. Scenes, then the COCO layout over them.
        t0 = time.perf_counter()
        rich.main(["--phase", "images", "--out", os.path.join(tmp, "rich"),
                   "--num_images", str(DS_IMAGES), "--height",
                   str(DS_HW[0]), "--width", str(DS_HW[1]), "--seed",
                   str(SEED + 30)])
        with open(os.path.join(tmp, "rich", "gt.jsonl")) as f:
            scenes = [json.loads(line) for line in f if line.strip()]
        classes, _ = vocab.load_synonym_table(
            os.path.join("data", "coco_label_synonyms.txt"))
        img_dir, cap_file, inst_file, gt = write_coco_layout(
            tmp, scenes, [c for c in classes if " " not in c])
        log("dataset_build: %d JPEG scenes %s and the COCO layout in %.2f s"
            % (len(scenes), DS_HW, time.perf_counter() - t0))

        # 2. Selective search, the processes started together.
        ss_dir = os.path.join(tmp, "ss_npy")
        t0 = time.perf_counter()
        build.host_library()  # built once here; the processes reuse it
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "cap2det_tpu_torch.tools.create_selective_search_data",
             "--image_dir", img_dir, "--output_dir", ss_dir,
             "--process_indicator", "%d/%d" % (k, DS_SS_PROCESSES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in range(DS_SS_PROCESSES)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ss_wall = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError("dataset_build: selective search failed:\n"
                                 + "\n".join(outs))
        npys = sorted(glob.glob(os.path.join(ss_dir, "*.npy")))
        if len(npys) != len(scenes):
            raise AssertionError("dataset_build: %d proposal files for %d "
                                 "images" % (len(npys), len(scenes)))
        # One image again in this process: the same bytes, and its time.
        per_image = []
        for npy in npys[:2]:
            stem = os.path.basename(npy)[:-4]
            with open(os.path.join(img_dir, stem + ".jpg"), "rb") as f:
                image = ss.decode_rgb(f.read())
            t1 = time.perf_counter()
            boxes = ss.extract_for_image(image)
            per_image.append(time.perf_counter() - t1)
            buf = io.BytesIO()
            np.save(buf, boxes.astype(np.float32))
            with open(npy, "rb") as f:
                if f.read() != buf.getvalue():
                    raise AssertionError("dataset_build: a second run of %s "
                                         "gave other bytes" % stem)
        counts, r500, r2000 = [], [], []
        for npy in npys:
            props = np.load(npy)
            want = gt[os.path.basename(npy)[:-4]]
            if not (props.ndim == 2 and props.shape[1] == 4 and len(props)
                    and np.isfinite(props).all() and props.min() >= 0
                    and props.max() <= 1):
                raise AssertionError("dataset_build: bad proposals in %s"
                                     % npy)
            counts.append(len(props))
            for top, out in ((500, r500), (2000, r2000)):
                iou = _iou_matrix(want, props[:top])
                out.append(float((iou.max(axis=1) >= 0.5).mean()))
        log("dataset_build: selective search: " + json.dumps({
            "images": len(npys), "processes": DS_SS_PROCESSES,
            "host_library_build_s": build_s, "wall_s": ss_wall,
            "images_per_s": len(npys) / ss_wall,
            "one_process_s_per_image": per_image,
            "proposals_per_image": {"min": min(counts), "max": max(counts),
                                    "mean": float(np.mean(counts))},
            "recall_at_0.5": {"top500": float(np.mean(r500)),
                              "top2000": float(np.mean(r2000))},
            "host_cpu": cpu, "cores": cores}))
        if np.mean(r2000) < 0.5:
            raise AssertionError("dataset_build: recall@0.5 of the top 2000 "
                                 "%.3f" % np.mean(r2000))

        # 3. Records, read back.
        t0 = time.perf_counter()
        records = os.path.join(tmp, "records", "coco17_train.record")
        os.makedirs(os.path.dirname(records))
        n = create_coco_tf_record.main([
            "--image_dir", img_dir, "--caption_annotations_file", cap_file,
            "--instance_annotations_file", inst_file,
            "--proposal_data_path", ss_dir, "--output_path", records,
            "--num_shards", "2"])
        rec_s = time.perf_counter() - t0
        shards = sorted(glob.glob(records + "-*"))
        parsed = [pipeline_lib.parse_example(r) for s in shards
                  for r in tfrecord.read_records(s, verify_crc=True)]
        if n != len(scenes) or len(shards) != 2 or len(parsed) != n or any(
                len(e["proposals"]) != min(c, 2000) or not e["captions"]
                or not len(e["object_boxes"])
                for e, c in zip(sorted(parsed,
                                       key=lambda e: int(e["image_id"])),
                                counts)):
            raise AssertionError("dataset_build: the records do not hold "
                                 "what went in")
        log("dataset_build: %d records in %d shards in %.3f s (%.1f records "
            "per s, %d bytes)" % (n, len(shards), rec_s, n / rec_s,
                                  sum(os.path.getsize(s) for s in shards)))

        # 4. Vocabulary over a stand-in GloVe file.
        with open(cap_file) as f:
            words = sorted({t for a in json.load(f)["annotations"]
                            for t in create_vocab.tokenize_caption(
                                a["caption"])})
        glove = os.path.join(tmp, "glove.stand_in.300d.txt")
        write_stand_in_glove(glove, words[:-3], SEED + 31)
        vocab_file = os.path.join(tmp, "coco_open_vocab.txt")
        emb_file = os.path.join(tmp, "coco_open_vocab_300d.npy")
        kept, emb = create_vocab.main([
            "--caption_annotations_file", cap_file, "--glove_file", glove,
            "--output_vocabulary_file", vocab_file,
            "--output_vocabulary_word_embedding_file", emb_file,
            "--min_word_freq", "2"])
        if not kept or np.load(emb_file).shape != (len(kept),
                                                   DS_GLOVE_DIMS):
            raise AssertionError("dataset_build: vocabulary %d words, "
                                 "table %s" % (len(kept),
                                               np.load(emb_file).shape))
        log("dataset_build: vocabulary of %d words (of %d caption tokens), "
            "table %s" % (len(kept), len(words), np.load(emb_file).shape))

        # 5. The passthrough backbone; the TensorFlow fixtures converted.
        t0 = time.perf_counter()
        tf_before = {m for m in sys.modules if m.split(".")[0] == "tensorflow"}
        passthrough = os.path.join(tmp, "passthrough.pt")
        make_passthrough_checkpoint.write(passthrough, seed=SEED)
        expected = dict(np.load(os.path.join(DS_FIXTURES, "expected.npz")))
        want = convert_tf_checkpoint.variables_to_tree(expected)
        for fmt in ("v1", "v2"):
            got = convert_tf_checkpoint.convert(
                os.path.join(DS_FIXTURES, fmt, "inception_v2.ckpt"),
                os.path.join(tmp, "converted_%s.pt" % fmt))
            got, want_leaves = flat_leaves(got), flat_leaves(want)
            if [k for k, _ in got] != [k for k, _ in want_leaves] or not all(
                    a.dtype == b.dtype and np.array_equal(a, b)
                    for (_, a), (_, b) in zip(got, want_leaves)):
                raise AssertionError("dataset_build: %s fixture converted "
                                     "to another tree" % fmt)
        if {m for m in sys.modules if m.split(".")[0] == "tensorflow"} != (
                tf_before):
            raise AssertionError("dataset_build: the conversion imported "
                                 "tensorflow")
        log("dataset_build: passthrough backbone and both TensorFlow "
            "fixtures converted in %.2f s; no tensorflow imported (%s on "
            "this machine)" % (time.perf_counter() - t0, "installed"
                               if importlib.util.find_spec("tensorflow")
                               else "not installed"))

        # 6. train() over the records from the passthrough backbone.
        cfg = schema.load_pipeline(os.path.join("configs",
                                                "coco17_extend_match.pbtxt"))
        cfg.train_reader.cap2det_reader.input_pattern = [records + "*"]
        cfg.eval_reader.cap2det_reader.input_pattern = [records + "*"]
        cfg.train_config.log_step_count_steps = 4
        model_dir = os.path.join(tmp, "model")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state, steps, start, t_start, wall = run_train(
            torch, trainer, cfg, model_dir, DS_STEPS,
            pretrained_checkpoint=passthrough)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        bad = [r for r in steps if r["launches"] != PER_STEP]
        losses = [float(r["loss"]) for r in steps]
        if bad or len(steps) != DS_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError("dataset_build: steps %s, launches %s" % (
                [r["step"] for r in steps], [r["launches"] for r in bad]))
        medians = report_steps("from passthrough", steps, start, t_start,
                               cfg.train_config, phase="dataset_build")
        log("dataset_build: train(): %d steps in %.2f s from the "
            "passthrough backbone; launches %s (per step %s); losses %s; "
            "peak memory %d bytes" % (DS_STEPS, wall, json.dumps(launches),
                                      json.dumps(PER_STEP),
                                      json.dumps(losses), peak))
        del state

        # 7. One COCO evaluation of the last checkpoint.
        t0 = time.perf_counter()
        best = evaluator.continuous_evaluation(
            cfg, model_dir=model_dir, max_eval_examples=len(scenes),
            max_idle_polls=0, evaluator_kind="coco", device="cuda")
        with open(os.path.join(model_dir, "eval_metrics.jsonl")) as f:
            row = json.loads(f.readlines()[-1])
        coco_map = [row["iter%d/DetectionBoxes_Precision/mAP" % i]
                    for i in range(4)]
        if best is None or best[0] != DS_STEPS or row["num_examples"] != len(
                scenes) or not np.all(np.isfinite(coco_map)):
            raise AssertionError("dataset_build: evaluation %s, row %s" % (
                best, row))
        log("dataset_build: COCO evaluation of step %d over %d images in "
            "%.2f s: mAP@[.5:.95] per iteration %s" % (
                best[0], row["num_examples"], time.perf_counter() - t0,
                json.dumps(coco_map)))

        # 8. The three dataset builders against the tools run by hand.
        builders = check_dataset_builders(
            os.path.join(tmp, "builders"), img_dir, cap_file, inst_file,
            glove, ss_dir, records)
        log("dataset_build: the builders (%d selective-search processes "
            "each; the host's wall clock on %s): %s" % (
                DS_SS_PROCESSES, card_name_and_limit(), json.dumps(builders)))
    log("dataset_build: passed in %.1f s; median step %.3f ms on the card's "
        "timeline" % (time.perf_counter() - t_phase, medians["event_ms"]))
    return launches


DP_WORLD = 2
DP_BATCH = 2  # per rank: the global batch is DP_WORLD x DP_BATCH
DP_CANVAS = (1024, 1536)  # the coco17 fixed-batch step's canvas
DP_TIMED = 4  # steps timed with the all-reduce, and as many without
DP_TRAIN_STEPS = 16
DP_TIMEOUT = 480.0  # seconds for a spawned group to finish
# tests/test_torch_data_parallel.py's bounds (tests/test_trainer_spmd.py's).
DP_PARAM_TOL = 1e-4
DP_ACC_REL_TOL = 1e-3
DP_LOSS_RTOL = 1e-5


def dp_setup(torch, device, group):
    """coco17_extend_match at full width in float32 with dropout off (so
    that the ranks' step equals one process's on the global batch): the
    model, its train config, a fresh state from SEED, and the step in
    `group` (None: no group). Also the global batch of DP_WORLD x
    DP_BATCH seeded 1024x1536 canvases, P=500, made alike in every
    process."""
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.models import registry
    from cap2det_tpu_torch.train import trainer
    import cap2det_tpu_torch.models  # noqa: F401  (registers the model)

    cfg = schema.load_pipeline(os.path.join("configs",
                                            "coco17_extend_match.pbtxt"))
    cfg.model.cap2det_model.frcnn_options.dropout_keep_prob = 1.0
    model = registry.build(cfg.model, is_training=True,
                           compute_dtype=torch.float32, device=device)
    state, opt, _, mask = trainer.TrainState.create(model, cfg.train_config,
                                                    SEED)
    step = trainer.make_train_step(model, opt, cfg.train_config, mask,
                                   process_group=group)
    host = train_batch(np.random.default_rng(SEED + 20), DP_WORLD * DP_BATCH,
                       DP_CANVAS, TRAIN_P, model.num_classes,
                       pad=TRAIN_P // 10)
    return model, cfg, state, opt, mask, step, host


def dp_rank_slice(host, rank):
    return {k: v[rank * DP_BATCH:(rank + 1) * DP_BATCH]
            for k, v in host.items()}


def dp_trainable(state, mask):
    """CPU copies of the trainable params and their Adagrad accumulators."""
    from cap2det_tpu_torch.train import optimizers

    flat_mask = dict(optimizers.flatten_params(mask))
    return ({p: leaf.detach().cpu().clone() for p, leaf
             in optimizers.flatten_params(state["params"]) if flat_mask[p]},
            {p: s["sum_of_squares"].detach().cpu().clone()
             for p, s in state["opt_state"]["slots"].items()})


def dp_step_rank(device, build_root, out_dir):
    """(a) One rank of two on the one card (gloo): the kernels built from
    a clean directory by both ranks at once; one step on this rank's half
    of the global batch, with its launches; then steps timed with and
    without the all-reduce, and the all-reduce alone."""
    import pathlib

    import torch
    import torch.distributed as dist

    from cap2det_tpu_torch.kernels import build, roi_pool
    from cap2det_tpu_torch.parallel import mesh as mesh_lib
    from cap2det_tpu_torch.train import trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = mesh_lib.rank()
    build.BUILD_ROOT = pathlib.Path(build_root)
    dist.barrier()  # both ranks start building together
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0

    group = dist.group.WORLD
    model, cfg, state, opt, mask, step, host = dp_setup(torch, device, group)
    batch = model.device_batch(dp_rank_slice(host, rank))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, logs = step(state, batch, SEED)
    torch.cuda.synchronize()
    launches = launch_counts()
    params, slots = dp_trainable(state, mask)
    torch.save({"params": params, "slots": slots,
                "loss": float(logs["loss/total_loss"])},
               os.path.join(out_dir, "rank%d.pt" % rank))

    alone = trainer.make_train_step(model, opt, cfg.train_config, mask)
    times = {"with": [], "without": []}
    for kind in ["with", "without"] + ["with", "without", "without",
                                        "with"] * (DP_TIMED // 2):
        fn = step if kind == "with" else alone
        dist.barrier()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, logs = fn(state, batch, SEED)
        end.record()
        torch.cuda.synchronize()
        times[kind].append((start.elapsed_time(end),
                            (time.perf_counter() - t0) * 1e3))
    # The first of each kind is a warm-up.
    times = {k: v[1:] for k, v in times.items()}
    # What the step reduces: the trainable gradients, the total and the
    # losses.
    tensors = [leaf.to(device) for leaf in params.values()] + list(
        logs.values())
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    reduce_ms = []
    for _ in range(1 + DP_TIMED):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_lib.all_reduce_mean(tensors)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "device": str(device),
                   "backend": dist.get_backend(), "launches": launches,
                   "generic": roi_pool.generic_launches
                   + roi_pool.grad_generic_launches,
                   "build": {"built": build.build_info["built"],
                             "seconds": build_s,
                             "key": build.build_info["key"]},
                   "step_ms": times, "all_reduce_bytes": nbytes,
                   "all_reduce_ms": reduce_ms[1:],
                   "peak_bytes": torch.cuda.max_memory_allocated()}, f)


def dp_nccl_rank(device, out_dir):
    """(b) A group of one in NCCL: the step with the group equals the
    no-group step bit for bit (the all-reduce sums over one rank and
    nothing is divided). Deterministic algorithms, and a second no-group
    step, rule out run-to-run differences of the step itself."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    results = []
    for group in (None, dist.group.WORLD, None):
        model, _, state, _, mask, step, host = dp_setup(torch, device, group)
        reset_launch_counts()
        state, logs = step(state, model.device_batch(dp_rank_slice(host, 0)),
                           SEED)
        torch.cuda.synchronize()
        params, slots = dp_trainable(state, mask)
        results.append({"params": params, "slots": slots,
                        "loss": logs["loss/total_loss"].cpu(),
                        "launches": launch_counts()})
        del model, state
    torch.save({"backend": dist.get_backend(), "results": results},
               os.path.join(out_dir, "nccl.pt"))


def dp_train_rank(device, pattern, model_dir, out_dir):
    """(c) One rank of train() at configs/coco17_extend_match.pbtxt as
    shipped over train_loop's records: spies count what it writes, a hook
    its launches and step times."""
    import hashlib

    import torch
    import torch.distributed as dist

    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.data import pipeline as pipeline_lib
    from cap2det_tpu_torch.parallel import mesh as mesh_lib
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib
    from cap2det_tpu_torch.train import metrics as metrics_lib
    from cap2det_tpu_torch.train import optimizers, trainer

    rank = mesh_lib.rank()
    cfg = schema.load_pipeline(os.path.join("configs",
                                            "coco17_extend_match.pbtxt"))
    cfg.train_reader.cap2det_reader.input_pattern = [pattern]
    cfg.train_config.save_checkpoints_steps = DP_TRAIN_STEPS // 2
    cfg.train_config.log_step_count_steps = DP_TRAIN_STEPS // 4
    writes = {"save": 0, "write": 0, "seed": None}
    real = (ckpt_lib.CheckpointManager.save, metrics_lib.MetricsWriter.write,
            pipeline_lib.build_input_pipeline)

    def save(self, *a, **k):
        writes["save"] += 1
        return real[0](self, *a, **k)

    def write(self, *a, **k):
        writes["write"] += 1
        return real[1](self, *a, **k)

    def build_pipe(reader, seed=0, **k):
        writes["seed"] = seed
        return real[2](reader, seed=seed, **k)

    ckpt_lib.CheckpointManager.save = save
    metrics_lib.MetricsWriter.write = write
    pipeline_lib.build_input_pipeline = build_pipe
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, records, start, t_start, wall = run_train(
        torch, trainer, cfg, model_dir, DP_TRAIN_STEPS, device=device)
    launches = launch_counts()
    digest = hashlib.sha256()
    for _, leaf in optimizers.flatten_params(state["params"]):
        digest.update(leaf.detach().float().cpu().numpy().tobytes())
    steps = []
    for prev, r in zip([None] + records[:-1], records):
        steps.append({"step": r["step"], "canvas": r["canvas"],
                      "launches": r["launches"],
                      "event_ms": (prev["event"] if prev else start)
                      .elapsed_time(r["event"]),
                      "host_s": r["host"] - (prev["host"] if prev
                                             else t_start),
                      "wait_s": r["wait"], "loss": float(r["loss"])})
    with open(os.path.join(out_dir, "train%d.json" % rank), "w") as f:
        json.dump(dict(writes, rank=rank, backend=dist.get_backend(),
                       launches=launches, steps=steps, wall_s=wall,
                       params=digest.hexdigest(),
                       peak_bytes=torch.cuda.max_memory_allocated()), f)


def phase_data_parallel(torch):
    """data_parallel: coco17_extend_match at full width on DP_WORLD ranks
    of one process group on the one card (gloo: NCCL refuses two ranks on
    one device), each a spawned process:
      (a) one float32 step, dropout off, on each rank's half of a seeded
          global batch of DP_WORLD x DP_BATCH (P=500), against one step of
          this process on the whole batch: params within DP_PARAM_TOL,
          Adagrad accumulators within DP_ACC_REL_TOL relative, loss within
          DP_LOSS_RTOL, both ranks' params bit for bit; launches per rank
          K1 1, K4 3, K2 1, K5 2, K6 1, the fused optimizer 1 (counts set
          to 0 just before); the
          kernels built by both ranks at once into a clean directory; step
          times on CUDA events with and without the all-reduce, the
          all-reduce's bytes and time; peak memory;
      (b) a group of one in NCCL: its step equals the no-group step bit
          for bit;
      (c) train() over train_loop's records at the shipped config on two
          ranks: launches per step on each rank, step medians, only rank
          0 saving checkpoints and writing metrics, the ranks' params
          equal at the end, peak memory.
    Nothing falls back to one process, to the CPU or to a plain kernel."""
    import tempfile

    from cap2det_tpu_torch.parallel import distributed
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        # (a)
        t0 = time.perf_counter()
        distributed.spawn(dp_step_rank, DP_WORLD, args=(
            os.path.join(tmp, "build"), tmp), device="cuda",
            timeout=DP_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        got = [torch.load(os.path.join(tmp, "rank%d.pt" % r),
                          weights_only=True) for r in range(DP_WORLD)]
        for r, info in enumerate(ranks):
            if info["launches"] != PER_STEP or info["generic"]:
                raise AssertionError("data_parallel: rank %d launched %s "
                                     "(generic K1/K2 %d), expected %s" % (
                                         r, info["launches"],
                                         info["generic"], PER_STEP))
            if info["backend"] != "gloo" or info["device"] != "cuda:0":
                raise AssertionError("data_parallel: rank %d on %s %s" % (
                    r, info["backend"], info["device"]))
        if sum(info["build"]["built"] for info in ranks) < 1:
            raise AssertionError("data_parallel: no rank built the kernels")
        for part in ("params", "slots"):
            if not all(torch.equal(v, got[0][part][k])
                       for k, v in got[1][part].items()):
                raise AssertionError("data_parallel: the ranks' %s differ"
                                     % part)
        if got[1]["loss"] != got[0]["loss"]:
            raise AssertionError("data_parallel: the ranks' losses differ")

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model, _, state, _, mask, step, host = dp_setup(torch, "cuda", None)
        state, logs = step(state, model.device_batch(host), SEED)
        want_params, want_slots = dp_trainable(state, mask)
        want_loss = float(logs["loss/total_loss"])
        del model, state, step
        torch.cuda.empty_cache()
        d_params = max(float((got[0]["params"][k].double() - v.double())
                             .abs().max()) for k, v in want_params.items())
        acc_rel = max(float(torch.linalg.vector_norm(
            got[0]["slots"][k].double() - v.double())
            / (torch.linalg.vector_norm(v.double()) + 1e-12))
            for k, v in want_slots.items())
        loss_rel = abs(got[0]["loss"] - want_loss) / abs(want_loss)
        log("data_parallel: (a) %d gloo ranks on cuda:0, %d trainable "
            "leaves: max|dparam| %r (bound %g), accumulators' relative error"
            " %r (bound %g), loss %r on the ranks against %r in one process "
            "(relative %r, bound %g)" % (
                DP_WORLD, len(want_params), d_params, DP_PARAM_TOL, acc_rel,
                DP_ACC_REL_TOL, got[0]["loss"], want_loss, loss_rel,
                DP_LOSS_RTOL))
        if not (d_params < DP_PARAM_TOL and acc_rel < DP_ACC_REL_TOL
                and loss_rel < DP_LOSS_RTOL):
            raise AssertionError("data_parallel: the ranks' step is not one "
                                 "process's step on the global batch")
        for info in ranks:
            log("data_parallel: (a) rank %d: " % info["rank"] + json.dumps({
                "launches": info["launches"], "build": info["build"],
                "median_step_ms_with_all_reduce": float(np.median(
                    [e for e, _ in info["step_ms"]["with"]])),
                "median_step_ms_without": float(np.median(
                    [e for e, _ in info["step_ms"]["without"]])),
                "step_ms_events_host": info["step_ms"],
                "all_reduce_bytes": info["all_reduce_bytes"],
                "median_all_reduce_ms": float(np.median(
                    info["all_reduce_ms"])),
                "all_reduce_ms": info["all_reduce_ms"],
                "peak_bytes": info["peak_bytes"]}))
        log("data_parallel: (a) the group's spawn to join %.1f s" % spawn_s)

        # (b)
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "nccl"))
        distributed.spawn(dp_nccl_rank, 1, args=(os.path.join(tmp, "nccl"),),
                          device="cuda", timeout=DP_TIMEOUT)
        nccl = torch.load(os.path.join(tmp, "nccl", "nccl.pt"),
                          weights_only=True)
        plain, grouped, again = nccl["results"]

        def same(x, y):
            return (torch.equal(x["loss"], y["loss"]) and all(
                torch.equal(v, y[part][k]) for part in ("params", "slots")
                for k, v in x[part].items()))

        if nccl["backend"] != "nccl" or not same(plain, again):
            raise AssertionError("data_parallel: (b) backend %s; the no-group"
                                 " step repeats its bits: %s" % (
                                     nccl["backend"], same(plain, again)))
        if not same(grouped, plain) or grouped["launches"] != PER_STEP:
            raise AssertionError("data_parallel: (b) a group of one in NCCL "
                                 "changed the step's bits (launches %s)"
                                 % grouped["launches"])
        log("data_parallel: (b) a group of one in NCCL gives the no-group "
            "step's loss %r, %d params and %d accumulators bit for bit "
            "(%.1f s)" % (float(grouped["loss"]), len(grouped["params"]),
                          len(grouped["slots"]), time.perf_counter() - t0))

        # (c)
        t0 = time.perf_counter()
        pattern = write_train_records(tmp, 8, (480, 640), SEED + 9)
        model_dir = os.path.join(tmp, "model")
        distributed.spawn(dp_train_rank, DP_WORLD, args=(
            pattern, model_dir, tmp), device="cuda", timeout=DP_TIMEOUT)
        trains = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, "train%d.json" % r)) as f:
                trains.append(json.load(f))
        for info in trains:
            bad = [s["step"] for s in info["steps"]
                   if s["launches"] != PER_STEP]
            if bad or len(info["steps"]) != DP_TRAIN_STEPS:
                raise AssertionError("data_parallel: (c) rank %d launched "
                                     "other than %s at steps %s" % (
                                         info["rank"], PER_STEP, bad))
        saved = [s for s, _ in ckpt_lib.list_checkpoints(model_dir)]
        with open(os.path.join(model_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
        if (trains[0]["save"] < 1 or trains[0]["write"] < 1
                or any(t["save"] or t["write"] for t in trains[1:])
                or saved != [DP_TRAIN_STEPS // 2, DP_TRAIN_STEPS]
                or logged != [DP_TRAIN_STEPS * k // 4 for k in (1, 2, 3, 4)]):
            raise AssertionError("data_parallel: (c) saves %s, metric writes"
                                 " %s, checkpoints %s, logged steps %s" % (
                                     [t["save"] for t in trains],
                                     [t["write"] for t in trains], saved,
                                     logged))
        if len({t["params"] for t in trains}) != 1 or len(
                {json.dumps([s["loss"] for s in t["steps"]])
                 for t in trains}) != 1:
            raise AssertionError("data_parallel: (c) the ranks' params or "
                                 "losses differ")
        if [t["seed"] for t in trains] != [7919 * r for r in range(DP_WORLD)]:
            raise AssertionError("data_parallel: (c) pipeline seeds %s"
                                 % [t["seed"] for t in trains])
        for info in trains:
            # Steps on a canvas this rank has seen before; a rank's step
            # also waits for the other rank's in the all-reduce.
            seen, steady = set(), []
            for s in info["steps"]:
                if tuple(s["canvas"]) in seen:
                    steady.append(s)
                seen.add(tuple(s["canvas"]))
            log("data_parallel: (c) rank %d: " % info["rank"] + json.dumps({
                "saves": info["save"], "metric_writes": info["write"],
                "pipeline_seed": info["seed"], "launches": info["launches"],
                "canvases": [s["canvas"] for s in info["steps"]],
                "first_step_s": info["steps"][0]["host_s"],
                "median_event_ms": float(np.median(
                    [s["event_ms"] for s in steady])),
                "median_host_s": float(np.median(
                    [s["host_s"] for s in steady])),
                "median_wait_s": float(np.median(
                    [s["wait_s"] for s in steady])),
                "steady_steps": len(steady),
                "event_ms": [s["event_ms"] for s in info["steps"]],
                "peak_bytes": info["peak_bytes"], "wall_s": info["wall_s"]}))
        log("data_parallel: (c) %d steps on %d gloo ranks, checkpoints %s "
            "and metrics at steps %s from rank 0 only, the ranks' params "
            "equal; losses %s (%.1f s)" % (
                DP_TRAIN_STEPS, DP_WORLD, saved, logged,
                json.dumps([s["loss"] for s in trains[0]["steps"]]),
                time.perf_counter() - t0))


# -- configs: the four configs no other phase steps -------------------------

CONFIG_STEPS = 2
NEVER_STEPPED = ("coco17_exact_match.pbtxt", "coco17_groundtruth.pbtxt",
                 "voc07_groundtruth.pbtxt",
                 "flickr30k_text_classifier_match.pbtxt")
FLICKR_GLOVE_FILE = "'data/flickr30k_open_vocab_300d.npy'"


def phase_configs(torch, directory):
    """configs: CONFIG_STEPS training steps of each config in
    NEVER_STEPPED at its shipped width (phase_train: batch 2, 1024x1536,
    P=500, seeded He weights and batch). Each keeps Mixed_4e trainable
    under the first stage's multiplier of 0.0, so every step must launch
    K1 1, K4 3, K2 1, K5 2, K6 1, the fused optimizer 1 (PER_STEP; counts
    set to 0 just before
    the steps). flickr30k_text_classifier_match reads a seeded stand-in
    for its 300-d table and a text classifier checkpoint written here.
    Returns {config: phase_train's result}."""
    from cap2det_tpu_torch import params as params_lib
    from cap2det_tpu_torch.config import schema
    from cap2det_tpu_torch.text import extractors, vocab
    from cap2det_tpu_torch.train import checkpoint as ckpt_lib

    flickr = "flickr30k_text_classifier_match.pbtxt"
    words = vocab.load_lines(os.path.join("data", "flickr30k_open_vocab.txt"))
    emb_file = os.path.join(directory, "flickr30k_open_vocab_300d.npy")
    np.save(emb_file, (GLOVE_STD * np.random.default_rng(SEED + 40)
                       .standard_normal((len(words), GLOVE_DIMS)))
            .astype(np.float32))
    text = shipped_config_text(flickr, [(FLICKR_GLOVE_FILE,
                                         "'%s'" % emb_file)])
    ext_cfg = schema.loads_pipeline(text).model.cap2det_model \
        .label_extractor.text_classifier_match_extractor
    checkpoint = os.path.join(directory, "coco17_text")
    ckpt_lib.save_params(checkpoint, params_lib.from_jax_numpy(
        extractors.TextClassifierMatchExtractor(ext_cfg, device="cpu")
        .init_params_numpy(SEED), "cpu"))
    texts = {flickr: text.replace(TEXT_CHECKPOINT, "'%s'" % checkpoint)}

    results = {}
    for name in NEVER_STEPPED:
        text = texts.get(name) or shipped_config_text(name, [])
        reader = schema.loads_pipeline(text).train_reader.cap2det_reader
        results[name] = phase_train(
            torch, name, batch_size=reader.batch_size,
            num_p=reader.max_num_proposals, warmup=0, timed=CONFIG_STEPS,
            want=PER_STEP, breakdown=False, text=text)
        torch.cuda.empty_cache()
    log("configs: " + json.dumps({
        name.split(".")[0]: {"launches": r["launches"],
                             "losses": r["losses"], "step_s": r["step_s"],
                             "peak_bytes": r["peak_bytes"]}
        for name, r in results.items()}))
    return results


# -- scripts: the run scripts of cap2det_tpu_torch/scripts ------------------

QR_IMAGES = 24
QR_STEPS = 500
QR_NPROC = 4
QR_TAG = "groundtruth-exact"
QR_TIMEOUT = 420.0
# scripts.train: long enough that the daemon's 10 s polls land while the
# trainer steps at any step time seen so far (30-65 ms), with retention
# racing the daemon.
SCRIPT_STEPS = 600
SCRIPT_SAVE_EVERY = 50
SCRIPT_KEEP = 3
SCRIPT_TIMEOUT = 300.0
GONE_SECS = 30.0
# quality_run's pipeline freezes the whole first stage (as voc07_inc2):
# no K2, and K5 only for Mixed_5c.
FROZEN_PER_STEP = {"roi_crop_maxpool": 1, "pool_fwd": 3,
                   "roi_crop_maxpool_grad": 0, "maxpool_grad": 1,
                   "avgpool_grad": 1, "fused_optimizer": 1, "nms": 0,
                   "bn_fold": 1, "bn_fold_grad": 1}


def logged_launches(text, where):
    """The {kernel: launches} a trainer process logged at its end
    ("kernel launches: {...}", train/trainer.py)."""
    marker = "kernel launches: "
    lines = [l for l in text.splitlines() if marker in l]
    if len(lines) != 1:
        raise AssertionError("%s: %d kernel-launch lines" % (where,
                                                             len(lines)))
    return json.loads(lines[0].split(marker, 1)[1])


def group_gone(pgid, within=GONE_SECS):
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.2)
    return False


def phase_scripts(torch, directory):
    """scripts: (1) ``python -m cap2det_tpu_torch.scripts.quality_run`` at a
    cut size (QR_IMAGES scenes, QR_STEPS steps, QR_NPROC selective-search
    processes, groundtruth labels, class set 9) on the card: its curve has
    a finite mAP at steps 250 and 500, and its trainer launched
    FROZEN_PER_STEP every step; (2) ``scripts.train`` over the same
    records with a staged copy of that pipeline (checkpoints every
    SCRIPT_SAVE_EVERY steps, SCRIPT_STEPS steps, SCRIPT_KEEP kept, so
    retention races the daemon): exit code 0, the daemon started
    evaluating at least one checkpoint before the trainer's last step,
    and neither process group outlives the script. Reports the
    checkpoints written, those the daemon evaluated, and its lag behind
    the newest checkpoint in steps and seconds (checkpoint times from the
    trainer's metrics.jsonl rows at those steps)."""
    from cap2det_tpu_torch.scripts import quality_run, steps

    env = steps.env()
    work = os.path.join(directory, "quality")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cap2det_tpu_torch.scripts.quality_run", work,
         str(QR_IMAGES), str(QR_STEPS), str(QR_NPROC)],
        env=env, capture_output=True, text=True, timeout=QR_TIMEOUT)
    qr_wall = time.perf_counter() - t0
    train_log = os.path.join(work, "train-%s.log" % QR_TAG)
    if proc.returncode != 0:
        raise AssertionError("scripts: quality_run exited %d:\n%s\n%s" % (
            proc.returncode, proc.stdout[-2000:], proc.stderr[-3000:]))
    summary = quality_run.summary(os.path.join(work, "model-" + QR_TAG))
    curve = summary["curve"]
    if not {250, 500} <= set(curve) or not all(
            np.isfinite(curve[s]) for s in (250, 500)):
        raise AssertionError("scripts: quality_run's curve %s" % curve)
    with open(train_log) as f:
        launches = logged_launches(f.read(), "quality_run")
    want = {k: v * QR_STEPS for k, v in FROZEN_PER_STEP.items()}
    if launches != want:
        raise AssertionError("scripts: quality_run's trainer launched %s, "
                             "expected %s" % (launches, want))
    log("scripts: quality_run %d scenes, %d steps, %d processes in %.1f s; "
        "trainer launches %s; summary %s" % (
            QR_IMAGES, QR_STEPS, QR_NPROC, qr_wall, json.dumps(launches),
            json.dumps(summary)))

    stage = os.path.join(directory, "staged")
    os.makedirs(os.path.join(stage, "configs"))
    with open(os.path.join(work, "pipeline-%s.pbtxt" % QR_TAG)) as f:
        text = f.read()
    for old, new in (("max_steps: %d" % QR_STEPS,
                      "max_steps: %d" % SCRIPT_STEPS),
                     ("save_checkpoints_steps: 250",
                      "save_checkpoints_steps: %d" % SCRIPT_SAVE_EVERY),
                     ("keep_checkpoint_max: 50",
                      "keep_checkpoint_max: %d" % SCRIPT_KEEP)):
        if old not in text:
            raise AssertionError("scripts: the pipeline has no %s" % old)
        text = text.replace(old, new)
    with open(os.path.join(stage, "configs", "quality.pbtxt"), "w") as f:
        f.write(text)
    train_dir = os.path.join(directory, "train_model")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cap2det_tpu_torch.scripts.train", "quality",
         train_dir, "--pretrained_checkpoint",
         os.path.join(work, "passthrough_ckpt")],
        cwd=stage, env=env, capture_output=True, text=True,
        timeout=SCRIPT_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("scripts: scripts.train exited %d:\n%s" % (
            proc.returncode, proc.stderr[-3000:]))
    pids = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^(eval daemon|trainer): pid (\d+)", proc.stderr, re.MULTILINE)}
    left = [role for role, pid in pids.items() if not group_gone(pid)]
    if len(pids) != 2 or left:
        raise AssertionError("scripts: processes %s, still running %s"
                             % (pids, left))
    launches = logged_launches(proc.stderr, "scripts.train")
    want = {k: v * SCRIPT_STEPS for k, v in FROZEN_PER_STEP.items()}
    if launches != want:
        raise AssertionError("scripts: scripts.train's trainer launched %s, "
                             "expected %s" % (launches, want))
    metrics = quality_run.read_jsonl(
        os.path.join(train_dir, "metrics.jsonl"))
    saved = {r["step"]: r["time"] for r in metrics
             if r["step"] % SCRIPT_SAVE_EVERY == 0}
    evals = quality_run.read_jsonl(
        os.path.join(train_dir, "eval_metrics.jsonl"))
    if len(saved) != SCRIPT_STEPS // SCRIPT_SAVE_EVERY or not evals:
        raise AssertionError("scripts: checkpoints %s, evaluated %s" % (
            sorted(saved), [r["step"] for r in evals]))
    # The trainer's last logged step; an evaluation counts as made while
    # the trainer ran when it started (its row's time less its duration)
    # before that.
    trainer_end = max(r["time"] for r in metrics)
    lags = []
    for r in evals:
        newest = max(s for s, t in saved.items() if t <= r["time"])
        lags.append({"step": r["step"], "newest": newest,
                     "lag_steps": newest - r["step"],
                     "lag_s": r["time"] - saved[r["step"]],
                     "during_training": r["time"] - r[
                         "eval/seconds_per_checkpoint"] < trainer_end,
                     "seconds_per_checkpoint":
                         r["eval/seconds_per_checkpoint"],
                     "best_map": quality_run.best_map(r)})
    if not any(l["during_training"] for l in lags):
        raise AssertionError("scripts: the daemon evaluated no checkpoint "
                             "while the trainer ran: %s" % lags)
    with open(os.path.join(train_dir, "eval.log")) as f:
        skipped = f.read().count("vanished before restore")
    kept = sorted(int(d) for d in os.listdir(os.path.join(train_dir, "ckpt"))
                  if d.isdigit())
    log("scripts: scripts.train %d steps in %.1f s: checkpoints written %s, "
        "kept %s; the daemon evaluated %s (%d while the trainer ran), "
        "skipped %d that vanished; lags %s; trainer launches %s; no "
        "process left" % (
            SCRIPT_STEPS, wall, json.dumps(sorted(saved)), json.dumps(kept),
            json.dumps([r["step"] for r in evals]),
            sum(l["during_training"] for l in lags), skipped,
            json.dumps(lags), json.dumps(launches)))
    return {"quality_run_s": qr_wall, "curve": curve, "train_s": wall,
            "evaluated": [r["step"] for r in evals], "lags": lags}


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
    serve_launches, serve_model, serve_outs = phase_serve(torch, profile)
    nms = phase_nms(torch, serve_model, serve_outs)
    del serve_model, serve_outs
    torch.cuda.empty_cache()
    k2 = phase_roi_grad(torch)
    k5, k6 = phase_pool_grad(torch)
    torch.cuda.empty_cache()
    fused = phase_fused_optimizer(torch)
    torch.cuda.empty_cache()
    folds = phase_bn_fold(torch)
    torch.cuda.empty_cache()
    coco = phase_train(
        torch, "coco17_extend_match.pbtxt", batch_size=2, num_p=TRAIN_P,
        warmup=3, timed=12, breakdown=True,
        want=PER_STEP)
    torch.cuda.empty_cache()
    # Full first-stage freeze: the ROIs need no gradient, so neither K2
    # nor Mixed_5a's pool backward runs.
    phase_train(
        torch, "voc07_inc2.pbtxt", batch_size=1, num_p=2000, warmup=2,
        timed=5, breakdown=False,
        want=FROZEN_PER_STEP)
    torch.cuda.empty_cache()
    # ResNet-101 at the coco17 shape: block3 and block4 train; block4 has
    # no pool, so no K4-K6.
    resnet = phase_train(
        torch, RESNET_CONFIG, batch_size=2, num_p=TRAIN_P, warmup=2,
        timed=5, breakdown=False, want=RESNET_PER_STEP,
        init=scale_resnet_gammas)
    torch.cuda.empty_cache()
    phase_bench(torch, coco, PER_STEP, FROZEN_PER_STEP)
    torch.cuda.empty_cache()
    phase_second_stage_remat(torch)
    torch.cuda.empty_cache()
    phase_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    launches = phase_train_loop(torch, profile)
    torch.cuda.empty_cache()
    eval_launches = phase_eval_daemon(torch)
    torch.cuda.empty_cache()
    phase_overfit_map(torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
        text_model_dir, emb_file = phase_text_model(torch, tmp)
        torch.cuda.empty_cache()
        text_launches = phase_text_cap2det(torch, tmp, text_model_dir,
                                           emb_file)
    torch.cuda.empty_cache()
    phase_data_parallel(torch)
    torch.cuda.empty_cache()
    dataset_launches = phase_dataset_build(torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_configs_") as tmp:
        phase_configs(torch, tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as tmp:
        phase_scripts(torch, tmp)
    log("chip_smoke: all phases passed in %.1f s" % (time.perf_counter() - t0))
    log("chip_smoke: the eval daemon's launches (two checkpoints) %s"
        % json.dumps(eval_launches))

    # Launches: the train() run of the train_loop phase, the main path,
    # which runs all six training kernels (the coco17 step phase,
    # text_cap2det's and dataset_build's train() do too); a step runs no
    # NMS, which the serve phase's images launch 4 times each.
    trained = [launches, coco["launches"], text_launches, dataset_launches]
    if min(v for counts in trained for k, v in counts.items()
           if k != "nms") < 1 or any(counts["nms"] for counts in trained):
        raise AssertionError("a kernel did not run in training, or NMS "
                             "did: %s" % json.dumps(trained))
    rows = [
        ("roi_crop_maxpool", "roi_pool.cu", "kernels/roi_pool.py:1213", k1),
        ("pool_fwd", "pool.cu", "kernels/pool_grad.py:350", k4),
        ("roi_crop_maxpool_grad", "roi_pool_bwd.cu",
         "kernels/roi_pool.py:1458", k2),
        ("maxpool_grad", "pool_grad.cu", "kernels/pool_grad.py:418", k5),
        ("avgpool_grad", "pool_grad.cu", "kernels/pool_grad.py:235", k6),
        # No Pallas kernel: the JAX package's default flat update, which
        # XLA fuses on the TPU.
        ("fused_optimizer", "fused_optimizer.cu", "train/optimizers.py:184",
         fused),
        # No Pallas kernel: the greedy pass's lax.fori_loop, which XLA
        # compiles into the TPU's postprocess program.
        ("nms", "nms.cu", "ops/nms.py:23", nms),
        # No Pallas kernel: the BN fold's arithmetic, which XLA fuses into
        # the TPU's step program.
        ("bn_fold", "bn_fold.cu", "models/inception_v2.py:265",
         folds["coco17"][0]),
        ("bn_fold_grad", "bn_fold.cu", "models/inception_v2.py:265",
         folds["coco17"][1]),
    ]
    # Each kernel's launches on its path: training's for the six, serving's
    # (the serve phase's three images) for NMS.
    launches = dict(launches, nms=serve_launches["nms"])
    # ResNet-101's fold and its backward (the JAX package has no such
    # backbone), with the launches of its training phase.
    rows += [(name + ".resnet101", "bn_fold.cu", None, r)
             for name, r in zip(("bn_fold", "bn_fold_grad"),
                                folds["resnet101"])]
    launches.update({name + ".resnet101": resnet["launches"][name]
                     // len(resnet["step_s"])
                     for name in ("bn_fold", "bn_fold_grad")})
    kernels = [
        {"name": name, "route": "cuda",
         "source": "cap2det_tpu_torch/csrc/" + source,
         "replaces": replaces and "cap2det_tpu/" + replaces,
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms")}
        for name, source, replaces, r in rows
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
