"""Engine layer (``serving/engine.py``): the mean share of the decode
batch's rows that hold a request, over the window's decode ops (the
timeline's meta ``tokens`` over ``max_num_seqs``), %."""


def read(view):
    ops = view.ops_of("decode")
    if not ops:
        return None
    rows = sum(o["args"]["tokens"] for o in ops) / len(ops)
    return 100.0 * rows / view.engine["max_num_seqs"]
