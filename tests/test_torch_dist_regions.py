"""The models on ``DTensor`` parameters over four gloo ranks, with real
values, against the plain single-process path.

The dry-run traces the models on ``DTensor``s, where the products, the
attention (flash decoding over a cache split along T), the SSD mixer, the
one-hot MoE, the vocab-parallel lookup and cross-entropy and the cache
writes run as per-rank regions (``distributed.sharding``: ``per_rank``,
``einsum_per_rank``, ``attend_per_rank``, ``embed_rows``,
``logsumexp_last``, ``take_last``, ``put_prefix``, ``put_rows``; and
``moe._moe_per_rank``, ``mamba2``'s region).  Those regions must compute
what the plain path computes, gradients included.  One spawn of four
rank processes (``tests/torch_dist_rank.py regions``: torch and the port
only, a gloo group through a ``FileStore`` under ``tmp_path``) runs, for
olmo-1b, mixtral-8x7b and jamba-1.5-large-398b ``.reduced()`` in fp32
end to end (the embedding not rounded to bf16, an fp32 KV cache), on the
meshes ``(2, 2)`` data x model and ``(2, 2, 1)`` pod x data x model:

* the training loss, its MoE aux term and the gradient of every
  parameter, parameters and batch laid out by the train rules;
* the prefill of a 48-token prompt into a 64-slot cache and one decode
  step, parameters, prompt and cache laid out by the serve rules, at
  batch 2, at batch 1 (the cache split along T over ``data``: the
  flash-decoding combine), and at batch 1 with the weights laid out
  FSDP as well (a zero HBM budget);

each gathered whole, against the same call on plain tensors in this
process.  The plain path is itself held against the JAX package by
``tests/test_torch_models.py``, ``test_torch_moe.py`` and
``test_torch_jamba.py``.

Bounds, from the measured differences (fp32 sums in another order: a
rank's partial products, then their all-reduce): the loss and the aux
term within 1e-5 of their size (measured at most 8.1e-8, the aux
term equal); each gradient
leaf within 1e-4 of its largest magnitude (measured at most 4.4e-5, in
jamba's leaves on the (2, 2) mesh); the logits and every cache leaf
within 1e-4 of their largest magnitude (measured at most 1.2e-5, jamba's
caches).  Every process has
a timeout: a hung rank fails the test.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_rank as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 400


@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    """The four ranks' gathered results and their cache layouts."""
    tmp = tmp_path_factory.mktemp("regions")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(R.__file__)), "regions", str(r),
         str(WORLD), str(tmp / "store"), str(tmp)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    outputs = []
    try:
        for proc in ranks:
            outputs.append(proc.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, text in zip(ranks, outputs):
        assert proc.returncode == 0, text[-4000:]
    return (dict(np.load(tmp / "regions.npz")),
            json.loads((tmp / "regions.json").read_text()))


@pytest.fixture(scope="module")
def plain():
    """The same calls on plain tensors, in this process: {arch: {name:
    array}} for "train|..." and each serving case."""
    from repro_torch import tree as TR
    from repro_torch.models import build_model
    from repro_torch.models import model as TMM
    from repro_torch.training.train_step import loss_and_grads
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TMM.Model, "_embed", TMM.Model._embed)
        R.fp32_end_to_end()
        for arch in R.REGION_ARCHS:
            cfg = R.region_config(arch)
            model = build_model(cfg, attn_impl="plain")
            params, _ = R.region_params(model)
            batch = R.region_batch(cfg)
            loss, metrics, grads = loss_and_grads(model, params, batch)
            got = {"train|loss": loss, "train|aux": metrics["aux"]}
            got.update({f"train|grad{i}": g
                        for i, g in enumerate(TR.leaves(grads))})
            params = TR.map_tree(lambda t: t.detach(), params)
            for name, B, _ in R.SERVE_CASES:
                cache = model.init_cache(B, R.REGION_SEQ, device="cpu")
                steps = R.region_steps(model, params,
                                       {"tokens": batch["tokens"][:B]},
                                       cache, lambda t, ax: t)
                got.update({f"{name}|{k}": v for k, v in steps.items()})
            out[arch] = {k: v.detach().float().numpy()
                         for k, v in got.items()}
    return out


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


CASES = [(m, a) for m in sorted(R.MESHES) for a in R.REGION_ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_loss_and_gradients_match_the_plain_path(regions, plain, mesh, arch):
    got, _ = regions
    want = plain[arch]
    for k in ("train|loss", "train|aux"):
        assert got[f"{mesh}|{arch}|{k}"].shape == want[k].shape == ()
        assert abs(got[f"{mesh}|{arch}|{k}"] - want[k]) <= \
            1e-5 * max(abs(want[k]), 1e-30), (k, got[f"{mesh}|{arch}|{k}"],
                                              want[k])
    grads = [k for k in want if k.startswith("train|grad")]
    assert grads and len(grads) == len(
        [k for k in got if k.startswith(f"{mesh}|{arch}|train|grad")])
    for k in grads:
        g, w = got[f"{mesh}|{arch}|{k}"], want[k]
        assert g.shape == w.shape, k
        assert np.abs(w).max() > 0, k          # a gradient that flows
        assert rel_err(g, w) <= 1e-4, (k, rel_err(g, w))


@pytest.mark.parametrize("case", [c[0] for c in R.SERVE_CASES])
@pytest.mark.parametrize("mesh,arch", CASES)
def test_prefill_and_decode_match_the_plain_path(regions, plain, mesh, arch,
                                                 case):
    got, _ = regions
    want = {k.split("|", 1)[1]: v for k, v in plain[arch].items()
            if k.startswith(case + "|")}
    assert {"prefill", "decode"} <= set(want)
    for k, w in want.items():
        g = got[f"{mesh}|{arch}|{case}|{k}"]
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        assert rel_err(g, w) <= 1e-4, (k, rel_err(g, w))


def test_the_cases_split_what_they_claim(regions):
    """At batch 1 on the (2, 2) mesh some cache is split along T over
    ``data`` (the flash-decoding combine runs), and at batch 2 along the
    batch."""
    _, layouts = regions
    # a stacked K/V cache is [L, B, T, KVH, D]; placements as DTensor
    # prints them, one a mesh dim
    assert any(leaf[0] == "S(2)" for leaf in layouts["dm|olmo-1b|b1"])
    assert any(leaf[0] == "S(1)" for leaf in layouts["dm|olmo-1b|b2"])
    assert sum(leaf[0] == "S(2)" for k, v in layouts.items()
               for leaf in v if k.endswith("|b1")) >= 2
