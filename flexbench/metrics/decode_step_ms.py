"""Model step (``models/*``): a decode op's mean time from dispatch to
its completion on the card, over the window's decode ops (timeline
``exec_time``), ms."""


def read(view):
    ops = view.ops_of("decode")
    if not ops:
        return None
    return sum(o["dur"] for o in ops) / len(ops) / 1e3
