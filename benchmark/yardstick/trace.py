"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read: the card's busy intervals, the host spans the benchmark put
around calls into the program, the device time of the kernels a span
launched (matched through the launch's correlation id), the longest idle
gaps with the host operation open across each, and the top device
operations. Copied from the program's measuring tools
(``tools/benchlib.py`` ``load_trace`` / ``device_intervals`` /
``busy_share`` and ``tools/profile_step.py`` ``aggregate``)."""

from __future__ import annotations

import bisect
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime", "cuda_driver")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def load_events(trace):
    """A chrome trace (a path or the loaded dict) -> its complete ("X")
    events that have a duration."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def merge_intervals(pairs):
    merged = []
    for a, b in sorted(pairs):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _corr(e):
    return (e.get("args") or {}).get("correlation")


class Trace:
    """The events of one traced window, in the trace's microseconds."""

    def __init__(self, trace, window_span):
        events = load_events(trace)
        windows = [e for e in events if e.get("name") == window_span]
        if not windows:
            raise ValueError("the trace holds no %r span" % window_span)
        self.start = min(e["ts"] for e in windows)
        self.end = max(e["ts"] + e["dur"] for e in windows)
        self.events = events
        self.device = [e for e in events
                       if e.get("cat") in DEVICE_CATEGORIES
                       and e["ts"] < self.end
                       and e["ts"] + e["dur"] > self.start]
        self.host = [e for e in events if e.get("cat") in HOST_CATEGORIES]
        self.spans = {}
        for e in events:
            if e.get("cat") == "user_annotation":
                self.spans.setdefault(e["name"], []).append(e)
        self.launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATEGORIES and _corr(e) is not None:
                self.launches.setdefault(e.get("tid"), []).append(
                    (e["ts"], _corr(e)))
        for rows in self.launches.values():
            rows.sort()
        self.device_by_corr = {}
        for e in self.device:
            self.device_by_corr.setdefault(_corr(e), []).append(e)

    @property
    def window_us(self):
        return self.end - self.start

    def intervals(self):
        """The card's busy intervals inside the window, merged."""
        return merge_intervals(
            (max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end))
            for e in self.device)

    def busy_us(self):
        return sum(b - a for a, b in self.intervals())

    def named(self, prefix):
        """The span events whose name starts with `prefix`."""
        return [e for name, evs in self.spans.items()
                if name.startswith(prefix) for e in evs]

    def host_us(self, spans):
        return sum(e["dur"] for e in spans)

    def launched(self, span):
        """The device events launched from inside `span` (same thread,
        launch time within it)."""
        rows = self.launches.get(span.get("tid"), [])
        lo = bisect.bisect_left(rows, (span["ts"], -1))
        hi = bisect.bisect_right(rows, (span["ts"] + span["dur"],
                                        float("inf")))
        out = []
        for _, corr in rows[lo:hi]:
            out.extend(self.device_by_corr.get(corr, ()))
        return out

    def launched_us(self, spans):
        """Device microseconds of the events launched inside `spans`:
        the union of their intervals, so nested spans count once."""
        events = {id(e): e for s in spans for e in self.launched(s)}
        return sum(b - a for a, b in merge_intervals(
            (e["ts"], e["ts"] + e["dur"]) for e in events.values()))

    def top_device_ops(self, n=10):
        """[[name, seconds]] of the device operations that took most time
        in the window."""
        by_name = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in rows]

    def _innermost_host(self, start, end):
        best = None
        for e in self.host:
            if (e["ts"] <= start and e["ts"] + e["dur"] >= end
                    and (best is None or e["dur"] < best["dur"])):
                best = e
        return best

    def idle_gaps(self, n=10):
        """[[host operation open across the gap, seconds]] of the `n`
        longest idle gaps of the card in the window, the window's edges
        included."""
        edges = [[self.start, self.start]] + self.intervals() + [
            [self.end, self.end]]
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in
                       zip(edges, edges[1:]) if b[0] > a[1]), reverse=True)
        out = []
        for length, start, end in gaps[:n]:
            across = self._innermost_host(start, end)
            out.append([across["name"] if across else "none", length / 1e6])
        return out
