"""Device: the share of the device trace's sub-window in which no kernel,
copy or set ran on the card, %."""
from flexbench.lib import trace


def read(view):
    span = trace.span_s(view)
    if span <= 0 or not view.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s(view) / span)
