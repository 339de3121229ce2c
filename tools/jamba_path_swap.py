"""Which path carries the difference between jamba-1.5-large's kernel and
plain training steps in fp32 (on the card).

    PYTHONPATH=src python3 tools/jamba_path_swap.py

jamba-1.5-large ``.reduced()`` at head_dim 64, as the card's training
test takes it, every parameter in fp32 and the embedding left in fp32,
one loss and gradient of ``make_batch(cfg, 2, 200, step=0)``.  Its three
swappable paths are the Mamba-2 scan (``ops.ssd_scan`` and its backward
kernel, or ``ssd_chunked`` under autograd), the attention (flash and its
backward kernel, or ``blocked_attention``) and the MoE dispatch (sorted,
or the reference's one-hot).  The step runs with every combination of
the three, and once more on the plain path in float64 (a copy of
``src/repro_torch`` with every bf16 and fp32 step in float64, as
``tools/bf16_gradient_noise.py`` makes it).  For each combination it
prints the loss, its distance from the all-plain and the float64 loss,
the lowest gradient-leaf cosine and largest leaf error (relative to the
leaf's norm) against both, and how many of the MoE layers' top-k picks
and capacity drops differ from the all-plain run's.
"""
import contextlib
import dataclasses
import itertools
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import bf16_gradient_noise as NZ  # noqa: E402

PATHS = ("scan", "attn", "moe")


def case():
    from repro_torch.configs import get_config
    from repro_torch.training import make_batch
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              head_dim=64)
    return cfg, make_batch(cfg, 2, 200, step=0)


@contextlib.contextmanager
def forced(impls, routes):
    """Each path on its own ``attn_impl`` (``impls``: path -> "kernel" or
    "plain"); every MoE routing (idx, keep) appended to ``routes``."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import moe as MOE
    saved = (M.mamba_forward, L.attention_forward, MOE.apply_moe, MOE.route)

    def on(fn, impl):
        return lambda *a, **kw: fn(*a, **dict(kw, attn_impl=impl))

    def route(*a, **kw):
        r = saved[3](*a, **kw)
        routes.append((r.idx.detach().cpu(), r.keep.detach().cpu()))
        return r
    M.mamba_forward = on(saved[0], impls["scan"])
    L.attention_forward = on(saved[1], impls["attn"])
    MOE.apply_moe = on(saved[2], impls["moe"])
    MOE.route = route
    try:
        yield
    finally:
        M.mamba_forward, L.attention_forward, MOE.apply_moe, MOE.route = \
            saved


def fp32_runs():
    """{combination: (loss, [grad leaves as float64 on the host], routes)}
    and the parameters (float64, host)."""
    from repro_torch import tree as TR
    from repro_torch.models import build_model
    from repro_torch.models import model as TMM
    from repro_torch.training.train_step import loss_and_grads
    TMM.Model._embed = lambda self, p, t: p["embed"][t]
    cfg, np_batch = case()
    model = build_model(cfg)
    params = TR.map_tree(lambda t: t.float(), model.init(0, device="cuda"))
    batch = {k: torch.from_numpy(v).cuda() for k, v in np_batch.items()}
    runs = {}
    for combo in itertools.product(("kernel", "plain"), repeat=3):
        routes = []
        with forced(dict(zip(PATHS, combo)), routes):
            loss, _, g = loss_and_grads(model, params, batch)
        runs[combo] = (float(loss), [t.double().cpu() for t in TR.leaves(g)],
                       routes)
    return runs, [t.detach().double().cpu() for t in TR.leaves(params)]


def float64_run(leaves):
    from repro_torch import tree as TR
    from repro_torch.models import build_model
    from repro_torch.training.train_step import loss_and_grads
    cfg, np_batch = case()
    model = build_model(cfg, attn_impl="plain")
    params = TR.unflatten_like(model.init(0, device="cuda"),
                               [t.cuda() for t in leaves])
    batch = {k: torch.from_numpy(v).cuda() for k, v in np_batch.items()}
    loss, _, g = loss_and_grads(model, params, batch)
    return float(loss), [t.double().cpu() for t in TR.leaves(g)]


def worst(a, b):
    """(lowest cosine, largest error relative to b's norm) over leaves."""
    cos, rel = [], []
    for x, y in zip(a, b):
        x, y = x.flatten(), y.flatten()
        cos.append(float(x @ y / (x.norm() * y.norm())))
        rel.append(float((x - y).norm() / y.norm()))
    return min(cos), max(rel)


def route_flips(routes, ref):
    """(top-k picks that differ, capacity drops that differ) from ``ref``'s
    routing, over every routed slot."""
    picks = sum(int((a != b).sum()) for (a, _), (b, _) in zip(routes, ref))
    drops = sum(int((a != b).sum()) for (_, a), (_, b) in zip(routes, ref))
    return picks, drops


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as C
    print(C.card_line())
    runs, leaves = fp32_runs()
    # the float64 copy replaces the package: import it after the fp32 runs
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        NZ.float64_copy(tmp)
        for name in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[name]
        sys.path.insert(0, tmp)
        f64_loss, f64_g = float64_run(leaves)
    plain = runs[("plain",) * 3]
    print(f"jamba-1.5-large .reduced(), head_dim 64, fp32, batch 2 x 200: "
          f"float64 loss {f64_loss!r}, all-plain fp32 {plain[0]!r}")
    for combo, (loss, g, routes) in runs.items():
        c_p, e_p = worst(g, plain[1])
        c_f, e_f = worst(g, f64_g)
        picks, drops = route_flips(routes, plain[2])
        print("  " + " ".join(f"{p}={i}" for p, i in zip(PATHS, combo))
              + f": loss {loss!r}, -plain {loss - plain[0]:+.3e}, -float64 "
              f"{loss - f64_loss:+.3e}; against plain: cosine {c_p:.7f}, "
              f"error {e_p:.3e}; against float64: cosine {c_f:.7f}, error "
              f"{e_f:.3e}; picks differing {picks}, drops differing {drops}")


if __name__ == "__main__":
    main()
