"""What the per-layer metrics read from a traced run. Each function takes
the ``traced`` dict of a run's outcome (``drivers/*.py``): {"trace":
yardstick.trace.Trace, "kernel_work": {kernel span: (bytes,
operations)}, "kind": the card, "units": steps or images traced,
"window_s", "window_units", "window_flops": the untraced window's
seconds, units and model FLOPs}; it returns a number, or None when the
run holds nothing to read."""

from __future__ import annotations

from benchmark.yardstick import peaks


def host_ms_per_unit(t, span):
    spans = t["trace"].named(span)
    if not spans:
        return None
    return t["trace"].host_us(spans) / 1e3 / t["units"]


def device_ms_per_unit(t):
    busy = t["trace"].busy_us()
    return busy / 1e3 / t["units"] if busy > 0 else None


def launched_ms_per_unit(t, span):
    spans = t["trace"].named(span)
    us = t["trace"].launched_us(spans) if spans else 0.0
    return us / 1e3 / t["units"] if us > 0 else None


def kernel_roofline(t):
    """100 x the least time of every kernel wrapper call's work over the
    device time of the kernels those calls launched, in %."""
    if t["kind"] not in peaks.HBM_BYTES_PER_S:
        return None
    trace = t["trace"]
    least = device = 0.0
    for tag, (nbytes, ops) in t["kernel_work"].items():
        us = trace.launched_us(trace.spans.get(tag, []))
        if us > 0:
            least += peaks.least_ms(t["kind"], nbytes, ops)
            device += us / 1e3
    return 100.0 * least / device if device > 0 else None


def idle_share(t):
    """100 x (1 - traced device ms a unit / untraced window ms a unit)."""
    busy = device_ms_per_unit(t)
    if busy is None:
        return None
    wall = t["window_s"] * 1e3 / t["window_units"]
    return 100.0 * (1.0 - busy / wall)


def mfu(t):
    """100 x the window's model FLOPs over its seconds over the card's
    dense bfloat16 peak."""
    peak = peaks.BF16_PEAK_FLOPS.get(t["kind"])
    if peak is None or t["trace"].busy_us() <= 0:
        return None
    return 100.0 * t["window_flops"] / t["window_s"] / peak
