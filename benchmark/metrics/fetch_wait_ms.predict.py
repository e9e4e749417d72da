"""``fetch_wait_ms.predict``: host milliseconds an image inside the
program's ``cap2det/predict/fetch`` span (the copies of the detections
and scores to the host, where the host waits for the card's tail),
matched by exact name; None where the program has no such span."""

SPAN = "cap2det/predict/fetch"


def read(traced):
    spans = traced["trace"].spans.get(SPAN)
    if not spans:
        return None
    return traced["trace"].host_us(spans) / 1e3 / traced["units"]
