"""Virtualization layer and phase policy (``core/daemon.py``,
``sched/dispatch.py``): the mean time a prefill op waited in the daemon's
queue before dispatch, over the window's prefill ops (timeline
``queue_delay``), ms."""


def read(view):
    ops = view.ops_of("prefill")
    if not ops:
        return None
    return sum(o["args"]["queue_delay_us"] for o in ops) / len(ops) / 1e3
