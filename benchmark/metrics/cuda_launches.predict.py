"""``cuda_launches.predict``: CUDA runtime and driver calls an image that
put work on the card (a kernel, copy or set matched to the call through
its correlation id; each call once) made while a ``cap2det/predict``
span of the program was open, on any thread of the process. The span is
matched by exact name. None where the program has no such span or the
trace holds no launch."""

import bisect

SPAN = "cap2det/predict"


def read(traced):
    trace = traced["trace"]
    spans = trace.spans.get(SPAN)
    if not spans or not trace.launches:
        return None
    calls = set()
    for s in spans:
        for rows in trace.launches.values():
            lo = bisect.bisect_left(rows, (s["ts"],))
            hi = bisect.bisect_right(rows, (s["ts"] + s["dur"],
                                            float("inf")))
            calls.update(c for _, c in rows[lo:hi]
                         if c in trace.device_by_corr)
    return len(calls) / traced["units"]
