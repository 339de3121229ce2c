"""Kernels (``kernels/ops.py``, ``csrc/flash_attention.cu``): the flash
kernel's roofline bound over its device time, summed over the prefills
the device trace holds whole, each bound from the prompt's length (the
benchmark's record) and the configuration's sizes, %."""
from flexbench.lib import arith


def read(view):
    m = view.model
    window = int(m.get("sliding_window", 0))
    bound = secs = 0.0
    for step, kernels in view.steps_in_span("prefill"):
        flash = [k for k in kernels if "flash_attention" in k.name
                 and "bwd" not in k.name]
        if len(flash) != m["num_layers"]:
            continue
        f, b = arith.flash_call(step.prompt, m["num_heads"],
                                m["num_kv_heads"], m["head_dim"], window)
        bound += m["num_layers"] * arith.bound_s(f, b)
        secs += sum(k.end - k.start for k in flash) / 1e9
    if secs <= 0:
        return None
    return 100.0 * bound / secs
