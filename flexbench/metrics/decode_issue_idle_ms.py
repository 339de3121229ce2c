"""Device: the card's idle time (no kernel, copy or set) inside a decode
step's ``step.issue`` span, the span mapped onto the device trace's clock
by the program's ``Timeline.to_profiler_ns``; mean over the issue spans
wholly inside the device trace's sub-window, ms."""
from flexbench.lib import spans


def read(view):
    return spans.mean(spans.decode_issue_idle_ms(view))
