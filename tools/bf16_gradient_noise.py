"""How far bf16 alone moves a model's gradient at smoke width (CPU).

    PYTHONPATH=src python tools/bf16_gradient_noise.py \\
        [--arch mamba2-780m] [--batch 4] [--seq 64]

Computes one loss's gradient tree three ways from the same parameters and
batch: the JAX model in bf16 (``jax.grad``), the port in bf16 (its
kernel path: ``kernels.ops`` with the plain versions on the CPU), and a
float64 evaluation of the same function, the port's plain path with
every bf16 and fp32 step in float64 (a copy of ``src/repro_torch`` whose
models and kernels have ``torch.bfloat16``, ``torch.float32`` and
``.float()`` rewritten to float64, run in a child process).  Prints, for
each pair, the lowest cosine and the largest error of a leaf, relative to
the leaf's norm: the bounds that a comparison of the two bf16 gradients
can be held to.
"""
import argparse
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

CHILD = r"""
import pickle, sys
import torch
sys.path.insert(0, sys.argv[1])
torch.set_default_dtype(torch.float64)
from repro_torch import tree as TR
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training.train_step import loss_and_grads
arch, leaves, batch = pickle.load(sys.stdin.buffer)
model = build_model(get_config(arch).reduced(), attn_impl="plain")
params = TR.unflatten_like(model.init(0, device="cpu"),
                           [torch.from_numpy(a).double() for a in leaves])
_, _, grads = loss_and_grads(
    model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
sys.stdout.buffer.write(pickle.dumps([g.numpy() for g in TR.leaves(grads)]))
"""


def float64_copy(dst: str) -> str:
    """``src/repro_torch`` under ``dst`` with its models and kernels in
    float64; returns the directory to put on sys.path."""
    shutil.copytree(os.path.join(SRC, "repro_torch"),
                    os.path.join(dst, "repro_torch"))
    for sub in ("models", "kernels"):
        d = os.path.join(dst, "repro_torch", sub)
        for name in os.listdir(d):
            if not name.endswith(".py"):
                continue
            path = os.path.join(d, name)
            text = open(path).read()
            text = re.sub(r"torch\.(bfloat16|float32)", "torch.float64", text)
            open(path, "w").write(text.replace(".float()", ".double()"))
    return dst


def worst(a, b):
    """(lowest cosine, largest error relative to b's norm) over leaves."""
    cos, rel = [], []
    for x, y in zip(a, b):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        cos.append(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
        rel.append(np.linalg.norm(x - y) / np.linalg.norm(y))
    return float(min(cos)), float(max(rel))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, SRC)
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jax_get_config
    from repro.distributed.sharding import unbox
    from repro.models import build_model as jax_build_model
    from repro.training import make_batch
    from repro_torch import bridge
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.train_step import loss_and_grads

    jm = jax_build_model(jax_get_config(args.arch).reduced())
    jparams = unbox(jm.init(jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    batch = make_batch(jm.cfg, args.batch, args.seq, step=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_g = [np.asarray(g, np.float32) for g in jax.tree.leaves(
        jax.grad(lambda p: jm.loss(p, jbatch)[0])(jparams))]
    model = build_model(get_config(args.arch).reduced())
    _, _, grads = loss_and_grads(
        model, tparams, {k: torch.from_numpy(v.copy())
                         for k, v in batch.items()})
    port_g = [g.float().numpy() for g in TR.leaves(grads)]
    leaves = [t.detach().float().numpy() for t in TR.leaves(tparams)]
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [sys.executable, "-c", CHILD, float64_copy(tmp)],
            input=pickle.dumps((args.arch, leaves, batch)),
            capture_output=True, check=True)
    f64_g = pickle.loads(out.stdout)
    print(f"{args.arch} at smoke width, batch {args.batch} x {args.seq}: "
          f"lowest leaf cosine, largest leaf error / norm")
    for what, a, b in (("JAX bf16 against float64", jax_g, f64_g),
                       ("port bf16 against float64", port_g, f64_g),
                       ("port bf16 against JAX bf16", port_g, jax_g)):
        cos, rel = worst(a, b)
        print(f"  {what}: cosine {cos:.5f}, error {rel:.4f}")


if __name__ == "__main__":
    main()
