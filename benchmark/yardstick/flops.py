"""Floating-point operations of the model's work, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's plain
reference (convolutions and matrix products, forward and, for a step,
the backward the configuration's freeze needs) on meta tensors: shapes
only, no memory, no device. No change to the measured program moves the
count, and work it recomputes is not counted.

A unit's count is a base of its canvas plus a share for each valid
proposal: the program pads every image to the configuration's
``max_num_proposals``, and the padded rows are not model work. The count
is linear in the proposals (each ROI's second stage and heads), so two
counts, at the full and at half the proposals, give the share."""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import cap2det as ref

CACHE = Path(__file__).resolve().parents[2] / "build" / "bench_cache" / "flops"


def cached(kind, config, canvases, count):
    """`count(config, canvases)` -> {canvas: (base operations, operations
    per valid proposal of an image)}, kept in the
    checkout's build directory under a key of everything the count reads
    (the configuration, the reference's and this file's sources, torch's
    version), so only a checkout's first run pays the counter's start-up
    (seconds of importing its machinery)."""
    h = hashlib.sha256(json.dumps([kind, config, [list(c) for c in canvases],
                                   torch.__version__]).encode())
    for source in (ref.__file__, __file__):
        h.update(Path(source).read_bytes())
    path = CACHE / (h.hexdigest()[:24] + ".json")
    try:
        with open(path) as f:
            rows = json.load(f)
        return {tuple(hw): tuple(n) for hw, n in rows}
    except (OSError, ValueError):
        pass
    counts = count(config, canvases)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp%d" % os.getpid())
    with open(tmp, "w") as f:
        json.dump([[list(hw), list(n)] for hw, n in counts.items()], f)
    os.replace(tmp, path)
    return counts


def _meta_params(model, trainable_fn=None):
    leaves, empty = ref.param_spec(model["num_classes"],
                                   model["oicr_iterations"],
                                   model["fc_stddev"])
    values = []
    for path, shape, _ in leaves:
        t = torch.empty(shape, device="meta")
        if trainable_fn is not None and trainable_fn("/".join(path)):
            t.requires_grad_(True)
        values.append((path, t))
    return ref.nest(values, empty)


def _train_params(config):
    multipliers = [tuple(m) for m in config["train"]["gradient_multipliers"]]
    return _meta_params(
        config["model"], lambda p: ref.trainable(p, multipliers) is not None)


def _first_stage_flops(config, canvas_hw):
    """The first stage's forward, and its backward where the freeze
    trains part of it, on a training batch of `canvas_hw`."""
    params = _train_params(config)
    scope = params[ref.FIRST_SCOPE]
    leaves = [leaf for _, leaf in ref.flatten(scope) if leaf.requires_grad]
    b = config["train"]["batch_size"]
    with FlopCounterMode(display=False) as counter:
        out = ref.first_stage(ref.fold(scope, torch.bfloat16),
                              torch.empty((b, *canvas_hw, 3), device="meta"))
        if leaves:
            torch.autograd.grad(out.float().sum(), leaves)
    return counter.get_total_flops()


def unit_flops(counts, canvas_hw, valid):
    """Operations of a unit on `canvas_hw` with `valid` proposals in all
    (summed over its images)."""
    base, per_proposal = counts[tuple(canvas_hw)]
    return base + per_proposal * int(valid)


def _split(full, half, p, images):
    """(base, per valid proposal of an image) from counts at `p` and `p //
    2` proposals an image over `images` images."""
    per = (full - half) / (images * (p - p // 2))
    return full - per * images * p, per


def train_step_flops(config, canvases):
    """{canvas: (base, per proposal)} of one training step on a batch of
    it.

    The whole step is counted on the first canvas, at the full and at
    half the proposals; the other canvases differ from it only in the
    first stage, which is counted on each. Convolution and product counts
    depend on the output's height times its width, so a canvas and its
    transpose count alike."""
    first = canvases[0]
    b, p = config["train"]["batch_size"], config["train"]["max_num_proposals"]
    base, per = _split(_train_step_flops(config, first, p),
                       _train_step_flops(config, first, p // 2), p, b)
    rest = base - _first_stage_flops(config, first)
    counts = {}
    for hw in canvases:
        key = tuple(sorted(hw))
        if key not in counts:
            counts[key] = (rest + _first_stage_flops(config, hw), per)
    return {hw: counts[tuple(sorted(hw))] for hw in canvases}


def _train_step_flops(config, canvas_hw, p):
    model, train = config["model"], config["train"]
    params = _train_params(config)
    b = train["batch_size"]
    batch = {
        "image": torch.empty((b, *canvas_hw, 3), device="meta"),
        "proposals": torch.empty((b, p, 4), device="meta"),
        "num_proposals": torch.full((b,), p, dtype=torch.int32,
                                    device="meta"),
        "labels": torch.empty((b, model["num_classes"]), device="meta"),
    }
    leaves = [leaf for _, leaf in ref.flatten(params) if leaf.requires_grad]
    with FlopCounterMode(display=False) as counter:
        total = ref.loss(params, batch, model, None)
        torch.autograd.grad(total, leaves, allow_unused=True)
    return counter.get_total_flops()


def predict_scale_flops(config, canvas_hw, p):
    """Operations of one scale's forward of one image on `canvas_hw` with
    `p` proposals."""
    model = config["model"]
    params = _meta_params(model)
    with torch.no_grad():
        folded = ref.fold_all(params, torch.bfloat16)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.predictions(params, folded,
                        torch.empty((1, *canvas_hw, 3), device="meta"),
                        torch.empty((1, p, 4), device="meta"),
                        torch.full((1,), p, dtype=torch.int32,
                                   device="meta"), model)
    return counter.get_total_flops()


def predict_flops(config, canvases):
    """{canvas: (base, per proposal)} of one scale's forward of one image
    on it. The share of a proposal is the same on every canvas (the
    second stage and heads of one ROI), so it is counted on the first."""
    p = config["eval"]["max_num_proposals"]
    _, per = _split(predict_scale_flops(config, canvases[0], p),
                    predict_scale_flops(config, canvases[0], p // 2), p, 1)
    return {hw: (predict_scale_flops(config, hw, p) - per * p, per)
            for hw in canvases}
