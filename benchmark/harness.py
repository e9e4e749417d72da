"""What every cell shares: the files found by name, the set-up clock, the
spans the benchmark puts around calls into the program, the traced
phase, and the result line.

Files, by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<mix>.json``: the mix's parameters and the ``driver`` that
  runs it;
* ``drivers/<driver>.py``: ``run(ctx)`` drives one entry of the program;
* ``limits/<config>.<driver>.json``: the limit of each compared number;
* ``metrics/<metric>.py``: ``read(traced)`` -> a number, or None when the
  traced run holds nothing to read;
* ``reference/<feature_extractor>.py``: the reference's backbone of the
  configurations whose ``model.feature_extractor`` names it (its
  weights, preprocess and both stages; see ``reference/cap2det.py``).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cap2det_tpu")

SPAN_WINDOW = "bench/window"
SPAN_UNIT = "bench/unit"
SPAN_PREPARE = "bench/prepare"
SPAN_PREDICTIONS = "bench/predictions"
SPAN_POSTPROCESS = "bench/postprocess"
SPAN_KERNEL = "bench/kernel/"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark_file():
    return load_json(ROOT / "BENCHMARK.json")


def find(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError("no %s named %r in BENCHMARK.json" % (what, name))


def config(name):
    return load_json(HERE / "configs" / (name + ".json"))


def mix(name):
    return load_json(HERE / "traffic" / (name + ".json"))


def driver(name):
    return importlib.import_module("benchmark.drivers." + name)


def limits(config_name, driver_name):
    return load_json(HERE / "limits" / ("%s.%s.json" % (config_name,
                                                       driver_name)))


def metric_reader(name):
    """The reader module of a per-layer metric (its file name holds the
    metric's dots)."""
    path = HERE / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench, cell_name):
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    def listed(m):
        return "workloads" not in m or cell_name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if listed(m) and m["moves"] in moved]
    return e2e, per_layer


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class SetupClock:
    """Seconds of each piece of set-up, from a start taken before the
    heavy imports."""

    def __init__(self, start):
        self.start = start
        self.last = start
        self.pieces = {}

    def lap(self, name):
        now = time.perf_counter()
        self.pieces[name] = self.pieces.get(name, 0.0) + now - self.last
        self.last = now

    def total(self):
        return sum(self.pieces.values())


class Context:
    """One run of one cell."""

    def __init__(self, cell, seed, seconds, trace, device, clock,
                 out=sys.stdout, files=None):
        """`files` may hold "config", "mix" and "limits" in place of the
        files the cell names (the tests' small sizes)."""
        files = files or {}
        self.cell = cell
        self.config = files.get("config") or config(cell["config"])
        self.mix = files.get("mix") or mix(cell["traffic"])
        self.driver_name = self.mix["driver"]
        self.limits = files.get("limits") or limits(cell["config"],
                                                    self.driver_name)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.clock = clock
        self.out = out

    def line(self, record):
        """An earlier line of the run's output (not the result)."""
        print(json.dumps(record), file=self.out, flush=True)


def synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card(device):
    """{"kind", "power_limit"} of the card (the host CPU off the card)."""
    import torch

    if torch.device(device).type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        limit = out.split(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return {"kind": torch.cuda.get_device_name(torch.device(device)),
            "power_limit": limit}


def per_second(starts, t0, seconds):
    """How many units started in each whole second of the window."""
    counts = [0] * max(1, int(seconds + 0.999))
    for t in starts:
        counts[min(int(t - t0), len(counts) - 1)] += 1
    return counts


def launch_counts():
    from cap2det_tpu_torch import kernels

    return kernels.launch_counts()


def per_unit(before, after, units):
    return {k: (after[k] - before[k]) / max(units, 1) for k in after}


@contextlib.contextmanager
def spans(targets):
    """Wraps each (owner, attribute, label, on_call) so that every call
    runs inside a ``record_function`` span: `label`, or with `on_call`
    (called with the bound arguments and the result) `label` + "#n", n
    counting the calls. Module attributes are restored and instance
    attributes deleted on exit."""
    import torch

    patched = []
    for owner, name, label, on_call in targets:
        real = getattr(owner, name)
        signature = inspect.signature(real) if on_call else None
        counter = [0]

        def spanned(*args, _real=real, _label=label, _on=on_call,
                    _sig=signature, _n=counter, **kwargs):
            if _on is None:
                with torch.profiler.record_function(_label):
                    return _real(*args, **kwargs)
            tag = "%s#%d" % (_label, _n[0])
            _n[0] += 1
            with torch.profiler.record_function(tag):
                result = _real(*args, **kwargs)
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            _on(tag, bound.arguments, result)
            return result

        setattr(owner, name, spanned)
        patched.append((owner, name, real))
    try:
        yield
    finally:
        for owner, name, real in reversed(patched):
            if isinstance(owner, types.ModuleType):
                setattr(owner, name, real)
            else:
                delattr(owner, name)


class KernelCalls:
    """The work of every kernel wrapper call made inside ``spans``:
    {span tag: (bytes, operations)}, computed from the call's arguments
    by ``yardstick.work``; a call whose work needs its result on the
    device is kept and worked out after the trace."""

    def __init__(self):
        self.work = {}
        self._later = []

    def targets(self):
        from benchmark.yardstick import work

        out = []
        for name, (module, attr, fn, later) in work.WORK.items():
            owner = importlib.import_module(module)
            out.append((owner, attr, SPAN_KERNEL + name,
                        self._recorder(fn, later)))
        return out

    def _recorder(self, fn, later):
        def record(tag, arguments, result):
            if later:
                self._later.append((tag, fn, dict(arguments), result))
            else:
                self.work[tag] = fn(arguments, result)
        return record

    def finish(self):
        for tag, fn, arguments, result in self._later:
            self.work[tag] = fn(arguments, result)
        self._later = []
        return self.work


def traced(device, run_units, units, unit_targets):
    """Runs `run_units(units)` under ``torch.profiler`` (CPU and CUDA
    activities) inside a window span, with `unit_targets` and the kernel
    wrappers spanned. Returns (yardstick Trace, {kernel span: (bytes,
    operations)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.yardstick.trace import Trace

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    calls = KernelCalls()
    synchronize(device)
    with spans(unit_targets + calls.targets()), profile(
            activities=activities) as prof:
        with record_function(SPAN_WINDOW):
            run_units(units)
            synchronize(device)
    work = calls.finish()
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = Trace(path, SPAN_WINDOW)
    return trace, work


def read_per_layer(per_layer, traced_info):
    """{metric: {"value", "unit"}} of the readers that find something."""
    out = {}
    for m in per_layer:
        value = metric_reader(m["name"]).read(traced_info)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    return line
