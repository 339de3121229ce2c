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
  batch (``make_train_step(..., group=)``), leaves every rank with the
  same parameters and AdamW state, bit for bit those of AdamW applied to
  the int8 fake-quant of the mean of the four batches' gradients (summed
  in their dtype in rank order, then divided by four): Q(mean_r g_r);
* the same step in fp32 matches the JAX package's int8 step
  (``make_train_step(grad_compression="int8")`` jitted with the batch
  sharded over four host devices, where GSPMD reduces the gradient before
  the fake-quant) on the int8 grid;
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
from repro.distributed.sharding import unbox
from repro.models import build_model
from repro.models import model as JMM
from repro.training import (AdamWConfig, TrainConfig, adamw_init,
                            make_batch, make_train_step)

cases, meshes, in_npz, out_dir = json.loads(sys.argv[1]), \
    json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
dp = json.loads(sys.argv[5])
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
# the data-parallel int8 step in fp32 (the embedding not rounded to bf16,
# as on the ranks), from the ranks' initial parameters, the global batch
# the four ranks' batches in rank order, sharded over the four devices
JMM.Model._embed = lambda self, p, t: jnp.take(p["embed"], t, axis=0)
cfg = get_config(dp["arch"]).reduced()
model = build_model(cfg)
treedef = jax.tree.structure(unbox(jax.eval_shape(model.init,
                                                  jax.random.PRNGKey(0))))
init = np.load(out_dir + "/dp_params.npz")
params = jax.tree.unflatten(treedef, [
    jnp.asarray(init[str(i)], jnp.float32) for i in range(len(init.files))])
tcfg = TrainConfig(opt=AdamWConfig(**dp["opt"]), grad_compression="int8")
batches = [make_batch(cfg, dp["batch"], dp["seq"], step=r) for r in range(4)]
batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
mesh = Mesh(devs, ("data",))
rep = NamedSharding(mesh, jax.sharding.PartitionSpec())
bsh = NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
step = jax.jit(make_train_step(model, tcfg), in_shardings=(rep, rep, bsh))
state = step(params, adamw_init(tcfg.opt, params), batch)[:2]
for i, leaf in enumerate(jax.tree.leaves(state)):
    out[f"dp32|{i}"] = np.asarray(leaf, np.float32)
np.savez(out_dir + "/jax.npz", **out)
with open(out_dir + "/jax_blocks.json", "w") as f:
    json.dump(blocks, f)
"""


def bf16_step(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def dp_case():
    """The data-parallel step's arch, batch and AdamW settings, for the
    JAX side."""
    o = R.DP_TCFG.opt
    return {"arch": R.DP_ARCH, "batch": R.DP_BATCH, "seq": R.DP_SEQ,
            "opt": {"lr": o.lr, "warmup_steps": o.warmup_steps,
                    "total_steps": o.total_steps}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four gloo ranks and the JAX subprocess, all at once; their outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    np.savez(tmp / "inputs.npz",
             **{f"x{n}": (rng.standard_normal((n, *SHAPE))
                          * rng.uniform(0.01, 3.0, (n, 1, 1))
                          ).astype(np.float32) for n in (4, 2)})
    params, _ = init_train_state(build_model(get_config(
        R.DP_ARCH).reduced()), R.DP_TCFG, 0, device="cpu")
    np.savez(tmp / "dp_params.npz", **{
        str(i): leaf.float().numpy() for i, leaf in enumerate(
            TR.leaves(params))})
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
         json.dumps(meshes), str(tmp / "inputs.npz"), str(tmp),
         json.dumps(dp_case())],
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
        total = parts[0]
        for g in parts[1:]:
            total = total + g
        mean.append(quantize_dequantize_int8(total / WORLD))
    params, opt = init_train_state(model, R.DP_TCFG, 0, device="cpu")
    want = adamw_update(R.DP_TCFG.opt, TR.unflatten_like(params, mean), opt,
                        params)[:2]
    leaves = TR.leaves(want)
    assert len(leaves) == len(outs[0])
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(outs[0][f"dp|{i}"],
                                      leaf.detach().float().numpy(),
                                      err_msg=str(i))


def test_data_parallel_int8_step_matches_jax(runs):
    """The port's four-rank int8 step against JAX's four-device one, both
    in fp32 end to end from the same parameters and global batch.  Each
    rank's AdamW moment after one step is (1 - beta1) times the
    fake-quantized gradient, so it shows the gradient on the int8 grid:

    * each side's gradient lies on its own int8 grid (a multiple of its
      own amax / 127, to 1e-3 of a step), its grid index within one of
      JAX's at every element and equal to it at all but 0.1 % (the two
      fp32 sums round apart near a rounding boundary);
    * where the grid indices agree, the parameters after the step agree
      to 1e-6.

    Measured at smoke width: every element of the 8 leaves on JAX's grid
    (at most one a step off), parameters 3.0e-8 apart.  The port's
    former step, mean_r Q(g_r) (each rank quantized before the mean), put
    only 3-5 % of each leaf on JAX's grid, up to 1.76 steps off, and
    moved 359,499 of the 688,128 parameters by up to 2.0e-3.  In bf16 the
    two frameworks' own rounding of the gradient moves it by up to 3
    steps on either formula (0.018 of a leaf's norm from float64,
    ``tools/bf16_gradient_noise.py``), so only fp32 resolves the grid;
    the bf16 step is held bit for bit to its formula above."""
    b1 = R.DP_TCFG.opt.beta1
    outs = [{k: v for k, v in runs["ranks"][r].items()
             if k.startswith("dp32|")} for r in range(WORLD)]
    for r in range(1, WORLD):
        assert all(outs[r][k].tobytes() == outs[0][k].tobytes()
                   for k in outs[0]), r
    params, opt = init_train_state(build_model(get_config(
        R.DP_ARCH).reduced()), R.DP_TCFG, 0, device="cpu")
    n = len(TR.leaves(params))
    paths = [p for p, _ in TR.flatten_with_paths({"m": params})]
    m_keys = [f"dp32|{n + i}" for i in range(n)]   # (params, {m, step, v})
    assert len(outs[0]) == 3 * n + 1 and len(paths) == n
    for i, (path, key) in enumerate(zip(paths, m_keys)):
        got = outs[0][key] / (1 - b1)
        want = runs["jax"][key] / (1 - b1)
        grid = []
        for g in (got, want):
            q = g / (np.abs(g).max() / 127)
            assert np.abs(q - np.round(q)).max() <= 1e-3, path
            grid.append(np.round(q))
        assert np.abs(grid[0] - grid[1]).max() <= 1, path
        same = grid[0] == grid[1]
        assert same.mean() >= 0.999, (path, same.mean())
        p_got, p_want = outs[0][f"dp32|{i}"], runs["jax"][f"dp32|{i}"]
        assert np.abs(p_got - p_want)[same].max() <= 1e-6, path


def test_compressed_allreduce_is_the_mean_of_dequantized_partials(runs):
    """Against a float64 evaluation of the same function, from the
    quantized partials: within the fp32 rounding of the sum."""
    for n in (2, 4):
        parts = [quantize_dequantize_int8(torch.from_numpy(x)).double()
                 for x in runs["inputs"][f"x{n}"]]
        want = (sum(parts) / n).numpy()
        got = runs["ranks"][0][f"allreduce|{n}|float32"]
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
