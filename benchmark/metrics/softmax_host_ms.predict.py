"""``softmax_host_ms.predict``: host milliseconds an image inside the
program's ``cap2det/postprocess/softmax`` spans (the float64 softmax of
each OICR iteration), matched by exact name; None where the program has
no such span."""

SPAN = "cap2det/postprocess/softmax"


def read(traced):
    spans = traced["trace"].spans.get(SPAN)
    if not spans:
        return None
    return traced["trace"].host_us(spans) / 1e3 / traced["units"]
