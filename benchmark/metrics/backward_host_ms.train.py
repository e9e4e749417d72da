"""``backward_host_ms.train``: host milliseconds a step inside the
program's ``cap2det/step/backward`` span (``torch.autograd.grad`` and the
zeros of unused leaves), matched by exact name; None where the program
has no such span."""

SPAN = "cap2det/step/backward"


def read(traced):
    spans = traced["trace"].spans.get(SPAN)
    if not spans:
        return None
    return traced["trace"].host_us(spans) / 1e3 / traced["units"]
