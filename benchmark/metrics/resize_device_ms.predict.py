"""``resize_device_ms.predict``: device milliseconds an image of the
kernels and copies launched inside the program's
``cap2det/predict/resize`` spans (each scale's canvas), matched to them
through the launch's correlation id as ``backbone_device_ms.predict``
matches its own; the span is matched by exact name. None where the
program has no such span or it launched nothing."""

SPAN = "cap2det/predict/resize"


def read(traced):
    trace = traced["trace"]
    spans = trace.spans.get(SPAN)
    us = trace.launched_us(spans) if spans else 0.0
    return us / 1e3 / traced["units"] if us > 0 else None
