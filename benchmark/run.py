"""Runs one cell of the benchmark and prints its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell's entry in ``BENCHMARK.json``
names its configuration and traffic mix; the mix names its driver (see
``harness.py``). Set-up (imports, the kernel library built or loaded,
weights, inputs, warm-up of the cell's shapes) is timed apart from the
measured window. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` the window runs untraced as well,
then a fixed number of further steps or images run under
``torch.profiler``, the reference's FLOP count of the window's work is
made, and the result carries the per-layer metrics. After the window the run compares what the window's path
produced with the plain reference (``correct``), and prints each
compared number beside its limit, last on standard error and last in the
result line.

It exits with a non-zero code and prints no result when no CUDA card is
there (or fewer than the cell asks for), or when the process holds JAX
or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    bench = harness.benchmark_file()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print("the cell needs %d cards, %d are there"
              % (cell["chips"], torch.cuda.device_count()), file=sys.stderr)
        return 2
    return run(bench, cell, args.seed, args.seconds, args.trace, "cuda",
               harness.SetupClock(START))


def run(bench, cell, seed, seconds, trace, device, clock, out=sys.stdout,
        err=sys.stderr, files=None):
    """Runs the cell on `device` and prints its lines to `out`; returns
    the exit code. The result line is the last line of `out`. `files`:
    see ``harness.Context``."""
    from benchmark import harness

    ctx = harness.Context(cell, seed, seconds, trace, device, clock, out,
                          files)
    e2e, per_layer = harness.cell_metrics(bench, cell["name"])
    outcome = harness.driver(ctx.driver_name).run(ctx)

    found = harness.forbidden_modules()
    if found:
        print("the run holds modules it may not load: %s" % ", ".join(found),
              file=err)
        return 3
    metrics = {}
    for m in e2e:
        if m["name"] == "setup_s":
            value = outcome["setup_s"]
        else:
            value = outcome["end_to_end"][m["name"]]
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": outcome["card"]["kind"], "count": 1,
                   "memory_peak_bytes": outcome["memory_peak_bytes"]}
    breakdown = None
    if trace:
        info = outcome["traced"]
        metrics = harness.read_per_layer(per_layer, info)
        t = info["trace"]
        device_info["busy_s"] = t.busy_us() / 1e6
        device_info["window_s"] = t.window_us / 1e6
        breakdown = {"device_ops": t.top_device_ops(10),
                     "idle_gaps": t.idle_gaps(10)}
    checks = outcome["checks"]
    for name, value, limit in checks:
        print("check %s %r limit %r" % (name, value, limit), file=err)
    line = harness.result_line(outcome["correct"], outcome["attempted"],
                               outcome["failed"], metrics, device_info,
                               checks, breakdown)
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
