"""Device time of the training step by kernel, and the card's idle gaps by
host activity, from ``torch.profiler`` (port of ``tools/profile_step.py``).

Builds the SAME step as ``cap2det_tpu_torch/bench.py`` (its config,
shapes, weights and placed batch), warms it up, and traces N steps with
the CPU and CUDA activities. The trace holds the port's own spans
(``utils/spans.py``, recorded while a profiler records): each step in
``cap2det/step``, its forward, backward and update, the model's layers
(``cap2det/model/...``) and the kernel wrappers
(``cap2det/kernel/...``), so an idle gap of the card can be tied to what
the host was doing. Prints JSON lines:

* ``total_device_ms_per_step``, with the steps' kernel launches, which
  must be the bench's;
* one line per device kernel name, the top N by time: ms per step and
  count;
* the busy share: the union of the card's kernel, copy and set
  intervals over the trace's window;
* the 10 longest idle gaps of the card, each with the innermost host
  operation or span that was open across it (null where none was, as
  across the end of one step and the start of the next) and the one open
  where it ended (what the card was waiting for);
* the step's time with the profiler on (the host clock over the traced
  steps) and off (CUDA events over as many steps just before), and the
  busy share with tracing off: the device time a step over the untraced
  step, since tracing slows the host, not the kernels;
* with ``--convs``, in place of the JAX tool's HLO convolution table, a
  table of ``aten::convolution`` and ``aten::convolution_backward`` by
  input shapes (``key_averages``), and ``conv_total_ms``.

A trace without device events fails the run: it does not print zeros.

    python -m cap2det_tpu_torch.tools.profile_step [--steps 8]
        [--shape bench] [--top 40] [--convs]
        [--trace_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch

from cap2det_tpu_torch import bench, kernels
from cap2det_tpu_torch import params as params_lib
from cap2det_tpu_torch.tools import benchlib

WARMUP_STEPS = 3
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime", "cuda_driver")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def innermost_host_event(events, start, end):
    """The shortest host event open over all of [start, end], or None."""
    best = None
    for e in events:
        if (e.get("cat") in HOST_CATEGORIES and e["ts"] <= start
                and e["ts"] + e["dur"] >= end
                and (best is None or e["dur"] < best["dur"])):
            best = e
    return best


def aggregate(trace, steps, top=40, gaps=10):
    """The per-step device time by kernel name, the busy share and the
    longest idle gaps of a torch.profiler chrome trace (a dict or a
    path) of `steps` steps. Raises when it holds no device event."""
    events = benchlib.load_trace(trace)
    device = [e for e in events if e.get("cat") in benchlib.DEVICE_CATEGORIES]
    if not device:
        raise RuntimeError("the trace holds no device events: nothing ran "
                           "on a card, so there is no device time to report")
    by_name = {}
    for e in device:
        total = by_name.setdefault(e["name"], [0.0, 0])
        total[0] += e["dur"]
        total[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy_ms, window_ms = benchlib.busy_share({"traceEvents": events})
    intervals = benchlib.device_intervals(events)
    idle = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(
        intervals, intervals[1:]) if b[0] > a[1]), reverse=True)
    origin = min(e["ts"] for e in events)
    gap_rows = []
    for length, start, end in idle[:gaps]:
        across = innermost_host_event(events, start, end)
        at_end = innermost_host_event(events, end, end)
        gap_rows.append({
            "gap_ms": length / 1e3, "start_ms": (start - origin) / 1e3,
            "host_op": across["name"] if across else None,
            "host_category": across.get("cat") if across else None,
            "host_op_at_end": at_end["name"] if at_end else None})
    return {
        "total_device_ms_per_step": sum(e["dur"] for e in device) / 1e3
                                    / steps,
        "kernels": [{"ms_per_step": dur / 1e3 / steps, "count": count,
                     "name": name} for name, (dur, count) in rows[:top]],
        "busy_ms": busy_ms, "window_ms": window_ms,
        "busy_share": busy_ms / window_ms,
        "idle_gaps": len(idle), "idle_ms": sum(g[0] for g in idle) / 1e3,
        "gaps": gap_rows,
    }


def _device_us(event):
    return getattr(event, "device_time_total", None) or getattr(
        event, "cuda_time_total", 0.0)


def conv_table(prof, steps):
    """[(op, input shapes, ms per step, calls per step)] of the
    convolutions and their backward, longest first."""
    rows = [(e.key, e.input_shapes, _device_us(e) / 1e3 / steps,
             e.count / steps)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in CONV_OPS]
    return sorted(rows, key=lambda r: -r[2])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--shape", choices=sorted(bench.SHAPES),
                        default="bench")
    parser.add_argument("--top", type=int, default=40)
    parser.add_argument("--convs", action="store_true",
                        help="print the convolution table")
    parser.add_argument("--trace_dir", default=None,
                        help="keep trace.json here (default: a temporary "
                             "directory, removed)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    device = params_lib.resolve_device(args.device)
    cuda = device.type == "cuda"
    fields = benchlib.device_fields(device)
    step = bench.BenchStep(bench.SHAPES[args.shape], device)
    for _ in range(WARMUP_STEPS):
        step.run()
    benchlib.synchronize(device)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    untraced = benchlib.time_rounds(step.run, device, args.steps, 1,
                                    warmup=0)
    before = kernels.launch_counts()
    with profile(activities=activities, record_shapes=args.convs) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step.run()
        benchlib.synchronize(device)
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    after = kernels.launch_counts()
    launches = {k: (after[k] - before[k]) / args.steps for k in after}
    bench.check_launches(launches, step.full_freeze, device)

    with contextlib.ExitStack() as stack:
        trace_dir = args.trace_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="profile_step_"))
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    agg = aggregate(trace, args.steps, args.top)

    lines = [{"total_device_ms_per_step": agg["total_device_ms_per_step"],
              "steps": args.steps, "shape": args.shape,
              "launches": launches, "step_ms_untraced": untraced["ms"],
              "step_ms_traced": traced_ms,
              "busy_share_untraced": agg["total_device_ms_per_step"]
              / untraced["ms"]}]
    lines += agg["kernels"]
    lines.append({k: agg[k] for k in ("busy_share", "busy_ms", "window_ms",
                                      "idle_gaps", "idle_ms")})
    lines.append({"longest_gaps": agg["gaps"]})
    if args.convs:
        rows = conv_table(prof, args.steps)
        lines.append({"conv_total_ms": sum(r[2] for r in rows),
                      "conv_calls_per_step": sum(r[3] for r in rows)})
        lines += [{"op": op, "input_shapes": shapes, "ms_per_step": ms,
                   "calls_per_step": calls}
                  for op, shapes, ms, calls in rows]
    for line in lines:
        benchlib.json_line({**line, **fields})
    return agg


if __name__ == "__main__":
    main()
