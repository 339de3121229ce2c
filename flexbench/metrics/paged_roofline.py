"""Kernels (``csrc/paged_attention.cu``): the paged kernel's roofline
bound over its device time, summed over the decode steps the device trace
holds whole, each bound from the context length of every row of the
batch (the benchmark's record) and the configuration's sizes, %."""
from flexbench.lib import arith


def read(view):
    m = view.model
    window = int(m.get("sliding_window", 0))
    T = int(view.engine["max_len"])
    T = min(T, window) if window else T
    ps = arith.page_size(T)
    bound = secs = 0.0
    for step, kernels in view.steps_in_span("decode"):
        paged = [k for k in kernels if "paged_attention" in k.name]
        if len(paged) != m["num_layers"]:
            continue
        f, b = arith.paged_call(step.rows, m["num_heads"], m["num_kv_heads"],
                                m["head_dim"], ps)
        bound += m["num_layers"] * arith.bound_s(f, b)
        secs += sum(k.end - k.start for k in paged) / 1e9
    if secs <= 0:
        return None
    return 100.0 * bound / secs
