"""How far bf16 alone moves mamba2-780m's gradient at full width, by depth
(on the card).

    PYTHONPATH=src python3 tools/bf16_depth_noise.py [--layers 4 8 16 48]

For each depth: one loss and gradient of chip_smoke.py's first training
batch (4 x 2048 tokens, seed 0) at full width, from the same random
parameters, on the kernel path (the SSD forward and backward kernels), on
the plain path (ssd_chunked under autograd, the JAX model's own scan) and
on a float64 evaluation of the plain path (tools/bf16_gradient_noise.py
makes the float64 copy of src/repro_torch).  Prints the losses and, for
each pair, the lowest cosine of a gradient leaf and its error relative to
the leaf's norm, then dt_bias's cosines in the first, middle and last
layer.  What it shows is
which depth a comparison of two bf16 gradients can be held to
chip_smoke.py's training gate (every leaf's cosine at least 0.99).
"""
import argparse
import dataclasses
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import bf16_gradient_noise as NZ  # noqa: E402
import chip_smoke as C  # noqa: E402

PAIRS = (("kernel", "f64"), ("plain", "f64"), ("kernel", "plain"))


def cos_rel(a, b):
    a, b = a.flatten(), b.flatten()
    return (float(a @ b / (a.norm() * b.norm())),
            float((a - b).norm() / b.norm()))


def bf16_grads(L: int):
    """The kernel and plain paths' losses and gradients (float64 copies)
    at depth L, and the parameters as float64."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=L)
    params = build_model(cfg).init(0, device="cuda")
    batch = C.train_batch(cfg, 0, 0)
    out = {}
    for impl in ("kernel", "plain"):
        loss, _, g = loss_and_grads(build_model(cfg, attn_impl=impl),
                                    params, batch)
        out[impl] = (float(loss), {k: v.double().cpu() for k, v in
                                   TR.flatten_with_paths(g)})
    leaves = [t.detach().double().cpu() for t in TR.leaves(params)]
    return out, leaves, batch


def float64_grads(L: int, leaves, batch):
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=L)
    model = build_model(cfg, attn_impl="plain")
    params = TR.unflatten_like(model.init(0, device="cuda"),
                               [t.cuda() for t in leaves])
    loss, _, g = loss_and_grads(model, params, batch)
    return float(loss), {k: v.double().cpu() for k, v in
                         TR.flatten_with_paths(g)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 16, 48])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(C.card_line())
    runs = {L: bf16_grads(L) for L in args.layers}
    # the float64 copy replaces the package: import it after the bf16 runs
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        NZ.float64_copy(tmp)
        for name in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[name]
        sys.path.insert(0, tmp)
        report(runs)


def report(runs):
    for L, (res, leaves, batch) in runs.items():
        res["f64"] = float64_grads(L, leaves, batch)
        del leaves, batch
        torch.cuda.empty_cache()
        print(f"mamba2-780m, {L} layers at full width: loss kernel "
              f"{res['kernel'][0]!r}, plain {res['plain'][0]!r}, float64 "
              f"{res['f64'][0]!r}")
        grads = {k: v[1] for k, v in res.items()}
        for x, y in PAIRS:
            worst = min((cos_rel(grads[x][k], grads[y][k]) + (k,)
                         for k in grads[y]), key=lambda t: t[0])
            print(f"  {x} against {y}: lowest leaf cosine {worst[0]:.5f} "
                  f"({worst[2]}, error {worst[1]:.3g} of its norm)")
        k = "['blocks'][0]['mamba']['dt_bias']"
        for layer in (0, L // 2, L - 1):
            cos = [cos_rel(grads[x][k][layer], grads[y][k][layer])[0]
                   for x, y in PAIRS]
            print(f"    dt_bias, layer {layer}: " + ", ".join(
                f"{x}-{y} {c:.4f}" for (x, y), c in zip(PAIRS, cos)))


if __name__ == "__main__":
    main()
