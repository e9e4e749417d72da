"""Driver of multi-scale prediction: ``eval/evaluator.MultiScalePredictor
.predict`` on decoded images, one at a time, as the eval daemon and the
export job run it: each scale's canvas, ``Cap2DetModel.predictions``,
the mean over the scales, then ``Cap2DetModel.postprocess`` (the softmax
and the NMS of every iteration), the results copied to the host.

The params are prepared once in set-up (``update_params``: the BN fold),
as a new checkpoint is. Warm-up predicts two images of each orientation,
which covers the cell's canvases. The window predicts the mix's images
in a cycle for the given seconds; ``predict_images_per_s`` is every image
returned over the window's time and ``predict_ms_p95`` the 95th
percentile of every image's latency, host clock from the call to its
return (``predict`` ends in copies to the host, so the work is done).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import cap2det as ref
from benchmark.yardstick import compare, flops, traffic, weights

class Program:
    """The program's predictor over `params`, prepared once."""

    def __init__(self, config, params, device):
        import cap2det_tpu_torch.models  # noqa: F401  (registers the model)
        from cap2det_tpu_torch.config import schema
        from cap2det_tpu_torch.eval import evaluator
        from cap2det_tpu_torch.models import registry

        pipeline = schema.loads_pipeline(config["pbtxt"])
        self.model = registry.build(pipeline.model, is_training=False,
                                    device=device)
        self.predictor = evaluator.MultiScalePredictor(
            self.model, params, pipeline.eval_reader.cap2det_reader)

    def predict(self, example):
        return self.predictor.predict(example)


def detections(out, iterations):
    """The detection arrays of a program output, by key."""
    keys = ["num_detections", "detection_boxes", "detection_scores",
            "detection_classes"]
    return {"%s_at_%d" % (k, i): out[k + "_at_%d" % i]
            for k in keys for i in range(1 + iterations)}


def reference_scores(params, folded, example, config, device,
                     head_dtype=torch.float32):
    """The reference's four-scale mean scores of one example, [1, P, C']
    numpy arrays by key, with its padded proposals and count."""
    image = torch.as_tensor(example["image"], device=device)
    with torch.no_grad():
        means, props, num = ref.score_mean(params, folded, image,
                                           example["proposals"],
                                           config["model"], config["eval"],
                                           head_dtype)
    return {k: v.cpu().numpy() for k, v in means.items()}, props, num


def reference_detections(scores, props, num, config, device):
    """The reference's postprocess of the given mean scores."""
    with torch.no_grad():
        out = ref.postprocess(
            {k: torch.as_tensor(v, device=device) for k, v in scores.items()},
            props, num, config["model"])
    return {k: v[0].cpu().numpy() for k, v in out.items()}


def check_numbers(sample, examples, outputs, params, config, device,
                  head_dtype=torch.float32):
    """{"score_gap", "nms_mismatch", "detection_mismatch"} of the
    program's outputs of the sampled images against the reference: its
    mean scores, its postprocess of the program's mean scores, and its
    detections end to end from its own mean scores."""
    folded = ref.fold_all(params, torch.bfloat16)
    gap, mismatch, own = 0.0, 0, 0
    iterations = config["model"]["oicr_iterations"]
    for i in sample:
        out = outputs[i]
        scores, props, num = reference_scores(params, folded, examples[i],
                                              config, device, head_dtype)
        gap = max(gap, compare.score_gap(out["proposal_scores"], scores))
        want = reference_detections(out["proposal_scores"], props, num,
                                    config, device)
        got = detections(out, iterations)
        mismatch += compare.mismatches(got, want)
        own += compare.mismatches(got, reference_detections(
            scores, props, num, config, device))
    return {"score_gap": gap, "nms_mismatch": mismatch,
            "detection_mismatch": own}


def choose_sample(seed, finished, examples, k):
    """`k` finished images drawn from the seed, the one with the most
    proposals among them."""
    finished = sorted(finished)
    most = max(finished, key=lambda i: len(examples[i]["proposals"]))
    rest = [i for i in finished if i != most]
    rng = np.random.default_rng([int(seed), 5])
    picked = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
    return [most] + [rest[j] for j in sorted(picked)]


def image_flops(config, examples):
    """[operations of each example's forward over every scale, at its
    valid proposals]."""
    canvases = {land: traffic.eval_canvases(config, land)
                for land in (True, False)}
    counts = flops.cached("predict", config,
                          canvases[True] + canvases[False],
                          flops.predict_flops)
    cap = config["eval"]["max_num_proposals"]
    return [sum(flops.unit_flops(counts, hw, min(len(e["proposals"]), cap))
                for hw in canvases[landscape(e)]) for e in examples]


def setup(ctx):
    dev = ctx.device
    config, mix = ctx.config, ctx.mix
    ctx.clock.lap("imports")
    if torch.device(dev).type == "cuda":
        from cap2det_tpu_torch.kernels import build

        build.library()
        ctx.clock.lap("kernel_library")
    params = weights.make_params(config["model"], ctx.seed, dev)
    program = Program(config, params, dev)
    harness.synchronize(dev)
    ctx.clock.lap("weights")
    examples = traffic.eval_images(mix, config, ctx.seed)
    ctx.clock.lap("inputs")
    for land in (True, False, True, False):
        program.predict(next(e for e in examples
                             if (e["image"].shape[1] >= e["image"].shape[0])
                             == land))
    ctx.clock.lap("warmup")
    return {"program": program, "params": params, "examples": examples}


def landscape(example):
    h, w = example["image"].shape[:2]
    return w >= h


def run(ctx):
    dev = ctx.device
    config, mix = ctx.config, ctx.mix
    s = setup(ctx)
    program, examples = s["program"], s["examples"]
    setup_s = ctx.clock.total()
    card = harness.card(dev)
    ctx.line({"setup_s": setup_s, "pieces": ctx.clock.pieces})

    n = len(examples)
    outputs, latencies = {}, []
    before = harness.launch_counts()
    starts = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        i = len(latencies) % n
        start = time.perf_counter()
        starts.append(start)
        outputs[i] = program.predict(examples[i])
        latencies.append(time.perf_counter() - start)
    window_s = time.perf_counter() - t0
    ctx.line({"images_per_second": harness.per_second(starts, t0,
                                                      ctx.seconds)})
    images = len(latencies)
    launches = harness.per_unit(before, harness.launch_counts(), images)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if torch.device(dev).type == "cuda" else 0)
    ms = np.asarray(latencies) * 1e3
    ctx.line({"card": card, "memory_peak_bytes": memory_peak,
              "launches_per_image": launches, "images": images,
              "window_s": window_s, "latency_ms_median": float(
                  np.median(ms)), "latency_ms_max": float(ms.max())})
    outcome = {
        "setup_s": setup_s, "card": card, "memory_peak_bytes": memory_peak,
        "attempted": images, "failed": 0,
        "end_to_end": {"predict_images_per_s": images / window_s,
                       "predict_ms_p95": float(np.percentile(ms, 95))},
    }

    if ctx.trace:
        start = images

        def run_units(count):
            for k in range(count):
                with torch.profiler.record_function(harness.SPAN_UNIT):
                    program.predict(examples[(start + k) % n])

        count = mix["traced_images"]
        model = program.model
        trace, work = harness.traced(
            dev, run_units, count,
            [(model, "predictions", harness.SPAN_PREDICTIONS, None),
             (model, "postprocess", harness.SPAN_POSTPROCESS, None)])
        t = time.perf_counter()
        per_image = image_flops(config, examples)
        ctx.line({"reference_flops_s": time.perf_counter() - t})
        outcome["traced"] = {
            "trace": trace, "kernel_work": work, "kind": card["kind"],
            "units": count, "window_s": window_s, "window_units": images,
            "window_flops": sum(per_image[k % n] for k in range(images))}

    # The check, once the program's predictor is freed.
    params = s["params"]
    del program, s["program"]
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    sample = choose_sample(ctx.seed, outputs, examples,
                           mix["reference_images"])
    numbers = check_numbers(sample, examples, outputs, params, config, dev)
    outcome["correct"], outcome["checks"] = compare.verdict(numbers,
                                                            ctx.limits)
    return outcome
