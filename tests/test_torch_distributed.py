"""The port's sharding and int8-compressed all-reduce on four gloo ranks,
against the JAX package on four host devices.

One spawn of four rank processes (``tests/torch_dist_rank.py``: torch and
the port only, a gloo group through a ``FileStore`` under ``tmp_path``, so
parallel test workers share no port) runs beside one JAX subprocess
(``--xla_force_host_platform_device_count=4``).  Then:

* on the meshes ``(2, 2)`` data x model and ``(2, 2, 1)`` pod x data x
  model, for olmo-1b and mixtral-8x7b ``.reduced()`` under the train and
  serve rules, each rank's ``to_local()`` shard of every parameter equals
  the block of the whole tensor that JAX's
  ``NamedSharding(mesh, spec).devices_indices_map`` gives the device at
  the rank's mesh coordinate (the ``("pod", "data")`` entries shard one
  dim over two mesh dims);
* one data-parallel train step over the four ranks, each on its own
  batch, its gradients through the compressed all-reduce
  (``make_train_step(..., group=)``), leaves every rank with the same
  parameters and AdamW state, bit for bit those of AdamW applied to the
  fp32 mean, in rank order, of the four batches' int8-quantized
  gradients;
* under ``set_active``, ``shard_act`` and ``collective_matmul_hint``
  redistribute a replicated ``DTensor`` to the blocks their specs give;
* ``compressed_allreduce`` over 4 ranks and over a 2-rank subgroup, in
  fp32 and bf16, equals JAX's ``compressed_allreduce`` (run inside
  ``jax.set_mesh``, which its ``shard_map`` needs): to 2e-6 of the
  largest magnitude in fp32 (the fp32 sum of the dequantized partials in
  another order) and to one bf16 step (both round that sum to bf16), and
  every rank holds the same bits.

Every process has a timeout: a hung rank fails the test.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as TR
from repro_torch.configs import get_config
from repro_torch.distributed.collectives import _quant
from repro_torch.distributed.sharding import unbox
from repro_torch.models import build_model
from repro_torch.training import (adamw_update, init_train_state,
                                  make_batch, quantize_dequantize_int8)
from repro_torch.training.train_step import loss_and_grads

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_rank as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240
SHAPE = (3, 257)          # one rank's partial of the all-reduce

JAX_SIDE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.configs.base import MeshConfig
from repro.distributed.collectives import compressed_allreduce
from repro.distributed.sharding import is_param, make_rules, spec_tree
from repro.models import build_model

cases, meshes, in_npz, out_dir = json.loads(sys.argv[1]), \
    json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
devs = np.array(jax.devices()[:4])
assert len(devs) == 4, jax.devices()
blocks = {}
for key, m, arch, mode in cases:
    shape, axes = meshes[m]
    mesh = Mesh(devs.reshape(shape), tuple(axes))
    cfg = get_config(arch).reduced()
    ann = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    specs = spec_tree(make_rules(cfg, MeshConfig(tuple(shape), tuple(axes)),
                                 mode), ann)
    leaves = jax.tree.leaves(ann, is_leaf=is_param)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for i, (p, spec) in enumerate(zip(leaves, spec_leaves)):
        dims = p.value.shape
        index = NamedSharding(mesh, spec).devices_indices_map(dims)
        for coord in np.ndindex(*shape):
            sl = index[mesh.devices[coord]]
            blocks[f"{key}|{i}|{list(coord)}"] = [
                list(s.indices(n)[:2]) for s, n in zip(sl, dims)]
inputs = np.load(in_npz)
out = {}
for n in (4, 2):
    mesh = Mesh(devs[:n], ("data",))
    for name in ("float32", "bfloat16"):
        x = jnp.asarray(inputs[f"x{n}"], getattr(jnp, name))
        with jax.set_mesh(mesh):
            y = compressed_allreduce(mesh, "data")(x)
        assert y.dtype == x.dtype and y.shape == (1,) + x.shape[1:]
        out[f"allreduce|{n}|{name}"] = np.asarray(y[0], np.float32)
np.savez(out_dir + "/jax.npz", **out)
with open(out_dir + "/jax_blocks.json", "w") as f:
    json.dump(blocks, f)
"""


def bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four gloo ranks and the JAX subprocess, all at once; their outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    np.savez(tmp / "inputs.npz",
             **{f"x{n}": (rng.standard_normal((n, *SHAPE))
                          * rng.uniform(0.01, 3.0, (n, 1, 1))
                          ).astype(np.float32) for n in (4, 2)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(R.__file__)), str(r), str(WORLD),
         str(tmp / "store"), str(tmp / "inputs.npz"), str(tmp)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    meshes = {m: [list(c.shape), list(c.axes)] for m, c in R.MESHES.items()}
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, json.dumps(R.cases()),
         json.dumps(meshes), str(tmp / "inputs.npz"), str(tmp)],
        env=jax_env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    outputs = []
    try:
        for proc in ranks + [ref]:
            outputs.append(proc.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for proc in ranks + [ref]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, text in zip(ranks + [ref], outputs):
        assert proc.returncode == 0, text[-4000:]
    return {
        "ranks": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
        "coords": [json.loads((tmp / f"rank{r}.json").read_text())
                   for r in range(WORLD)],
        "jax": dict(np.load(tmp / "jax.npz")),
        "blocks": json.loads((tmp / "jax_blocks.json").read_text()),
        "inputs": dict(np.load(tmp / "inputs.npz")),
    }


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
@pytest.mark.parametrize("arch", R.ARCHS)
def test_local_shards_equal_jax_device_blocks(runs, mesh, arch):
    cfg = get_config(arch).reduced()
    full = [v.float().numpy() for v in
            TR.leaves(unbox(build_model(cfg).init_annotated(0,
                                                             device="cpu")))]
    coords = [c[mesh] for c in runs["coords"]]
    # the four ranks sit at the four coordinates of the mesh
    assert sorted(map(tuple, coords)) == sorted(
        np.ndindex(*R.MESHES[mesh].shape))
    sharded = 0
    for key, m, a, mode in R.cases():
        if (m, a) != (mesh, arch):
            continue
        for i, value in enumerate(full):
            for r in range(WORLD):
                block = runs["blocks"][f"{key}|{i}|{coords[r]}"]
                want = value[tuple(slice(lo, hi) for lo, hi in block)]
                got = runs["ranks"][r][f"{key}|{i}"]
                assert got.shape == want.shape, (key, i, r, block)
                np.testing.assert_array_equal(got, want, err_msg=str(
                    (key, i, r)))
                sharded += got.size < value.size
    assert sharded > 0        # some leaf really was split


def test_shard_act_redistributes_a_dtensor_under_the_context(runs):
    """Under set_active, shard_act lays a replicated activation out by its
    logical names (train: batch over data, act_embed replicated) and
    collective_matmul_hint by an explicit spec (seq over model)."""
    full = R.activation().numpy()
    for r in range(WORLD):
        i, j = runs["coords"][r]["dm"]
        np.testing.assert_array_equal(runs["ranks"][r]["act|shard_act"],
                                      full[2 * i:2 * i + 2])
        np.testing.assert_array_equal(runs["ranks"][r]["act|hint"],
                                      full[:, 3 * j:3 * j + 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4])
def test_compressed_allreduce_matches_jax_and_is_replicated(runs, n, dtype):
    key = f"allreduce|{n}|{dtype}"
    outs = [runs["ranks"][r][key] for r in range(n)]
    for r in range(1, n):
        assert outs[r].tobytes() == outs[0].tobytes(), (key, r)
    got, want = outs[0], runs["jax"][key]
    assert got.shape == want.shape == SHAPE
    if dtype == "float32":
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    else:
        step = np.maximum(bf16_step(got), bf16_step(want))
        assert np.all(np.abs(got - want) <= step), key
    assert not np.all(got == 0)


def test_data_parallel_train_step_is_replicated_and_exact(runs):
    outs = [{k: v for k, v in runs["ranks"][r].items()
             if k.startswith("dp|")} for r in range(WORLD)]
    assert outs[0]
    for r in range(1, WORLD):
        assert all(outs[r][k].tobytes() == outs[0][k].tobytes()
                   for k in outs[0]), r
    cfg = get_config(R.DP_ARCH).reduced()
    model = build_model(cfg)
    grads = []
    for r in range(WORLD):
        params, _ = init_train_state(model, R.DP_TCFG, 0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in make_batch(
            cfg, R.DP_BATCH, R.DP_SEQ, step=r).items()}
        grads.append(TR.leaves(loss_and_grads(model, params, batch)[2]))
    mean = []
    for parts in zip(*grads):
        qs = [_quant(g) for g in parts]
        total = qs[0][0].float() * qs[0][1]
        for q, s in qs[1:]:
            total = total + q.float() * s
        mean.append((total / WORLD).to(parts[0].dtype))
    params, opt = init_train_state(model, R.DP_TCFG, 0, device="cpu")
    want = adamw_update(R.DP_TCFG.opt, TR.unflatten_like(params, mean), opt,
                        params)[:2]
    leaves = TR.leaves(want)
    assert len(leaves) == len(outs[0])
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(outs[0][f"dp|{i}"],
                                      leaf.detach().float().numpy(),
                                      err_msg=str(i))


def test_compressed_allreduce_is_the_mean_of_dequantized_partials(runs):
    """Against a float64 evaluation of the same function, from the
    quantized partials: within the fp32 rounding of the sum."""
    for n in (2, 4):
        parts = [quantize_dequantize_int8(torch.from_numpy(x)).double()
                 for x in runs["inputs"][f"x{n}"]]
        want = (sum(parts) / n).numpy()
        got = runs["ranks"][0][f"allreduce|{n}|float32"]
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
