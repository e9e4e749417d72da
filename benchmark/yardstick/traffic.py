"""The one traffic generator: a mix file's parameters and a seed in, the
inputs of a run out. The same seed gives the same inputs; every seed gives
the same set of sizes, in another order.

Values a mix leaves out come from the configuration's ``dataset`` section
(what an image of that dataset carries: its labels and proposals).

Training (the mixes of ``drivers/train_step.py``): a schedule of steps
in cycles. A cycle holds ``steps_per_scale`` steps of each training
scale, ``landscape[i]`` of them landscape for scale i; the seed orders
the steps inside each cycle. A step's bucket is its (scale, orientation)
canvas; each bucket has ``batches_per_bucket`` host batches, used in
turn.

Evaluation (``drivers/predict.py``): ``images`` decoded images whose
short sides are spread evenly over ``short_side``, the long side
``long_side``, ``landscape`` of them landscape, and whose numbers of
valid proposals are spread evenly over ``valid_proposals``: the same
images' sizes on every seed, which orders them and draws their pixels
and boxes.
"""

from __future__ import annotations

import numpy as np


def merged(mix, config):
    """The mix's parameters over the configuration's dataset values."""
    return {**config.get("dataset", {}), **mix}


def _rng(seed, stream):
    return np.random.default_rng([int(seed), stream])


def canvas(min_dimension, scale, aspect_cap=1.5, multiple=32):
    """(short, long) side of a scale bucket's canvas."""
    def up(x):
        return int(-(-x // multiple) * multiple)

    return (up(round(min_dimension * scale)),
            up(round(min_dimension * scale * aspect_cap)))


def train_buckets(config):
    """[(scale, landscape, (height, width))] of the training canvases."""
    train = config["train"]
    out = []
    for scale in train["scales"]:
        short, long = canvas(train["min_dimension"], scale,
                             train["aspect_cap"], train["canvas_multiple"])
        out.append((scale, True, (short, long)))
        out.append((scale, False, (long, short)))
    return out


def train_schedule(mix, config, seed, cycles):
    """[bucket index into ``train_buckets``] for `cycles` cycles."""
    train = config["train"]
    per = mix["steps_per_scale"]
    cycle = []
    for i, _ in enumerate(train["scales"]):
        land = mix["landscape"][i]
        cycle += [2 * i] * land + [2 * i + 1] * (per - land)
    rng = _rng(seed, 1)
    out = []
    for _ in range(cycles):
        out += [cycle[j] for j in rng.permutation(len(cycle))]
    return out


def _boxes(rng, n, side):
    """[n, 4] normalized boxes, each side log-uniform in `side`."""
    lo, hi = np.log(side[0]), np.log(side[1])
    h = np.exp(rng.uniform(lo, hi, n))
    w = np.exp(rng.uniform(lo, hi, n))
    y0 = rng.uniform(0.0, 1.0 - h)
    x0 = rng.uniform(0.0, 1.0 - w)
    return np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)


def train_batches(mix, config, seed):
    """{bucket index: [host batch]}: each batch a dict of the program's
    host batch keys ("image" [B, H, W, 3] uint8, "proposals" [B, P, 4],
    "number_of_proposals" [B], "pseudo_labels" [B, C])."""
    params = merged(mix, config)
    train = config["train"]
    batch, max_p = train["batch_size"], train["max_num_proposals"]
    classes = config["model"]["num_classes"]
    rng = _rng(seed, 2)
    out = {}
    for b, (_, _, (h, w)) in enumerate(train_buckets(config)):
        out[b] = []
        for _ in range(mix["batches_per_bucket"]):
            image = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
            proposals = np.zeros((batch, max_p, 4), np.float32)
            valid = rng.integers(params["valid_proposals"][0],
                                 params["valid_proposals"][1] + 1, batch)
            labels = np.zeros((batch, classes), np.float32)
            for i in range(batch):
                proposals[i, :valid[i]] = _boxes(rng, valid[i],
                                                 params["proposal_side"])
                k = rng.integers(params["labels_per_image"][0],
                                 params["labels_per_image"][1] + 1)
                labels[i, rng.choice(classes, k, replace=False)] = 1.0
            out[b].append({
                "image": image, "proposals": proposals,
                "number_of_proposals": valid.astype(np.int32),
                "pseudo_labels": labels})
    return out


def eval_images(mix, config, seed):
    """[{"image": [H, W, 3] uint8, "proposals": [n, 4] float32}]."""
    params = merged(mix, config)
    count = params["images"]
    shorts = np.rint(np.linspace(*params["short_side"], count)).astype(int)
    valids = np.rint(np.linspace(*params["valid_proposals"],
                                 count)).astype(int)
    landscape = np.arange(count) < params["landscape"]
    # Each image's (short side, proposals, orientation) is the same on
    # every seed; the seed orders the images.
    valids = valids[np.random.default_rng(0).permutation(count)]
    rng = _rng(seed, 3)
    order = rng.permutation(count)
    shorts, valids, landscape = shorts[order], valids[order], landscape[order]
    out = []
    for short, valid, land in zip(shorts, valids, landscape):
        long = params["long_side"]
        h, w = (short, long) if land else (long, short)
        out.append({
            "image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "proposals": _boxes(rng, valid, params["proposal_side"])})
    return out


def eval_canvases(config, landscape):
    """The canvases [(height, width)] an image of that orientation is
    predicted at, one per evaluation scale."""
    ev = config["eval"]
    out = []
    for min_dim in config["model"]["eval_min_dimension"]:
        short, long = canvas(min_dim, 1.0, ev["aspect_cap"],
                             ev["canvas_multiple"])
        out.append((short, long) if landscape else (long, short))
    return out
