"""The readings the limits of ``correct`` are set from, on the card at a
cell's own sizes, in one process:

* the program's numbers over many seeds (the lower readings): the train
  cells' run as the benchmark makes it, with a window of ``--seconds``
  (its two sets of three checked steps against the reference); the
  predict cells' sampled images against the reference;
* the control's numbers over a few seeds (the upper readings): the
  reference put in the program's place with every part the
  configuration runs in float32 (the pooled features, the heads, the
  losses) in bfloat16;
* the faults a cell can have, planted in the program: half of the batch
  left out with the mean over the rest (a batch of two), an answer
  altered where it is produced (a detection score moved by one float32
  step). A step that returns its state unchanged reads 1 on grad_gap by
  its measure and needs no run.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,...
        --control_seeds 7,8,9 [--seconds 10]

Prints one JSON line per reading and a summary line: the largest
program reading and the smallest control and fault readings of each
number. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import predict, train_step
from benchmark.yardstick import compare, traffic, weights


def _ctx(cell, seed, device, files, seconds=0.0):
    return harness.Context(cell, seed, seconds, False, device,
                           harness.SetupClock(time.perf_counter()),
                           out=sys.stderr, files=files)


class HalfBatch(train_step.Program):
    """The program with half of each batch left out, its loss the mean
    over the rest."""

    def step(self, host_batch, seed):
        half = {k: v[:len(v) // 2] for k, v in host_batch.items()}
        return super().step(half, seed)


def train_rows(cell, seeds, control_seeds, device, files=None,
               seconds=10.0):
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = _ctx(cell, seed, device, files, seconds)
        outcome = train_step.run(ctx)
        if seed in seeds:
            rows.append(("program", seed, outcome["numbers"]))
            for prefix, _, _, readings, reference in outcome["phases"]:
                print(json.dumps({"seed": seed, "phase": prefix,
                                  "detail": train_detail(readings,
                                                         reference)}),
                      file=sys.stderr, flush=True)
        if seed in control_seeds:
            control = {}
            for prefix, start, batches, _, reference in outcome["phases"]:
                readings = train_step.reference_steps(
                    ctx.config, start, batches, seed, device,
                    head_dtype=torch.bfloat16)
                for name, value in compare.train_numbers(
                        readings, reference).items():
                    control[prefix + name] = value
            rows.append(("control", seed, control))
            if ctx.config["train"]["batch_size"] > 1:
                half = train_step.run(_ctx(cell, seed, device, files,
                                           seconds), HalfBatch)
                rows.append(("fault_half_batch", seed, half["numbers"]))
        del outcome
        torch.cuda.empty_cache()
    return rows


def train_detail(program, reference):
    """Per-step losses and the leaves that set the two leaf gaps: what a
    look at a high reading starts from."""
    def worst(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    return {"losses": list(zip(program["losses"], reference["losses"])),
            "grad": worst(compare.leaf_gaps(program["grad_norms"],
                                            reference["grad_norms"])),
            "change": worst(compare.leaf_gaps(
                program["change_norms"], reference["change_norms"],
                compare.kept_leaves(reference))),
            "left_out": sorted(set(reference["true_grad_norms"])
                               - compare.kept_leaves(reference))}


def altered(outputs):
    """The outputs with the first detection score of the last iteration
    moved up by one float32 step."""
    out = {}
    for i, o in outputs.items():
        o = dict(o)
        key = [k for k in o if k.startswith("detection_scores_at_")][-1]
        scores = np.array(o[key], np.float32)
        scores.flat[0] = np.nextafter(scores.flat[0], np.float32(2.0))
        o[key] = scores
        out[i] = o
    return out


def control_outputs(sample, examples, params, config, device):
    """The reference in bfloat16 in the program's place: its mean scores
    and its own postprocess of them, as the program's outputs hold
    them."""
    folded = predict.ref.fold_all(params, torch.bfloat16)
    outputs = {}
    for i in sample:
        scores, props, num = predict.reference_scores(
            params, folded, examples[i], config, device, torch.bfloat16)
        dets = predict.reference_detections(scores, props, num, config,
                                            device)
        outputs[i] = {**dets, "proposal_scores": scores}
    return outputs


def predict_rows(cell, seeds, control_seeds, device, files=None):
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = _ctx(cell, seed, device, files)
        config = ctx.config
        params = weights.make_params(config["model"], seed, device)
        examples = traffic.eval_images(ctx.mix, config, seed)
        sample = predict.choose_sample(seed, range(len(examples)), examples,
                                       ctx.mix["reference_images"])
        program = predict.Program(config, params, device)
        outputs = {i: program.predict(examples[i]) for i in sample}
        del program
        if seed in seeds:
            rows.append(("program", seed, predict.check_numbers(
                sample, examples, outputs, params, config, device)))
        if seed in control_seeds:
            rows.append(("control", seed, predict.check_numbers(
                sample, examples, control_outputs(sample, examples, params,
                                                  config, device),
                params, config, device)))
            rows.append(("fault_altered_answer", seed, predict.check_numbers(
                sample, examples, altered(outputs), params, config,
                device)))
        torch.cuda.empty_cache()
    return rows


def summary(rows):
    out = {}
    for kind, _, numbers in rows:
        for name, value in numbers.items():
            key = "%s.%s" % (kind, name)
            pick = max if kind == "program" else min
            out[key] = value if key not in out else pick(out[key], value)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control_seeds", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seconds", type=float, default=10.0,
                        help="the train cells' window before the check")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    bench = harness.benchmark_file()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    driver = harness.mix(cell["traffic"])["driver"]
    if driver == "train_step":
        rows = train_rows(cell, seeds, control, args.device,
                          seconds=args.seconds)
    else:
        rows = predict_rows(cell, seeds, control, args.device)
    for kind, seed, numbers in rows:
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": seed,
                          **numbers}), flush=True)
    print(json.dumps({"cell": cell["name"], "summary": summary(rows)}))


if __name__ == "__main__":
    sys.exit(main())
