"""The port's dry-run (``launch/dryrun.py``, ``launch/step_analysis.py``)
and its H100 cost model (``serving/costmodel.py``) against the JAX
package.

Every part that starts a ``"fake"`` process group runs in its own process
(``tests/torch_dryrun_worker.py``), so no test worker keeps a global
group:

* the local shape on rank 0 of every parameter (and so every AdamW
  moment), input and cache leaf, for every arch at full width, every
  applicable ``SHAPES`` cell and both production meshes, equals JAX's
  ``NamedSharding(AbstractMesh(...), spec).shard_shape`` of the global
  shape, the spec from the JAX package's own ``make_rules``/``spec_tree``
  (no compile, no devices);
* the activation constraints: under a DTensor trace on a (2, 2) fake
  mesh, each ``shard_act`` the trace reaches on a ``DTensor`` lays it out
  as ``placements(mesh, rules.spec_for(names, shape))``; the port calls
  ``shard_act`` with the same logical names as the JAX models do (their
  calls recorded while tracing one loss each); with no context it hands
  back its input;
* ``StepCounter`` on three products on a 4-rank mesh, against FLOPs,
  bytes and wire bytes worked out by hand;
* one full-width cell, olmo-1b x train_4k on the 16 x 16 mesh, end to
  end; its per-rank FLOPs times 256 equal ``FlopCounterMode``'s count of
  the whole step on ``meta`` (every product is split evenly over the
  ranks and none is repeated);
* the step traced at one and two repeats of its layer stack and carried
  to all of them equals the step traced whole, field by field, at smoke
  width;
* ``roofline_terms`` at the H100's constants, and the cost model's
  constant-free terms, equal to the reference's for all ten archs.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import is_param
from repro.distributed.sharding import make_rules as jax_make_rules
from repro.distributed.sharding import spec_tree as jax_spec_tree
from repro.launch.mesh import mesh_config as jax_mesh_config
from repro.models import build_model as jax_build_model
from repro.serving.costmodel import CostModel as JaxCostModel
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import step_analysis as SA
from repro_torch.models import build_model
from repro_torch.serving import costmodel as CM
from repro_torch.training import make_batch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def run_worker(job: str, tmp_path) -> object:
    out = tmp_path / f"{job}.json"
    proc = subprocess.run(
        [sys.executable, str(Path(W.__file__)), job, str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return json.loads(out.read_text())


# ----------------------------------------------------------- shard shapes
@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return run_worker("shards", tmp_path_factory.mktemp("shards"))


@functools.lru_cache(maxsize=None)
def jax_annotated(arch):
    model = jax_build_model(jax_get_config(arch))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def shard_shape(mesh, spec, shape):
    return list(JaxNamedSharding(mesh, PartitionSpec(*spec)).shard_shape(
        tuple(shape)))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_local_shapes_equal_jax_shard_shapes(shards, arch, multi):
    mcfg = jax_mesh_config(multi_pod=multi)
    mesh = AbstractMesh(tuple(mcfg.shape), tuple(mcfg.axes))
    model, ann = jax_annotated(arch)
    cfg = model.cfg
    leaves = jax.tree.leaves(ann, is_leaf=is_param)
    split = 0
    for mode in ("train", "serve"):
        specs = jax.tree.leaves(
            jax_spec_tree(jax_make_rules(cfg, mcfg, mode), ann),
            is_leaf=lambda x: isinstance(x, PartitionSpec))
        want = [shard_shape(mesh, s, p.value.shape)
                for p, s in zip(leaves, specs)]
        got = shards[f"{arch}|{multi}|{mode}|params"]
        assert got == want, (arch, multi, mode)
        split += sum(g != list(p.value.shape) for g, p in zip(got, leaves))
    assert split > 0
    for name, shape in SHAPES.items():
        if not shape_applicable(get_config(arch), shape)[0]:
            assert f"{arch}|{multi}|{name}|inputs" not in shards
            continue
        mode = "train" if shape.kind.value == "train" else "serve"
        rules = jax_make_rules(cfg, mcfg, mode)
        inputs, axes = model.input_specs(JAX_SHAPES[name])
        want = [shard_shape(mesh, rules.spec_for(axes[k], inputs[k].shape),
                            inputs[k].shape) for k in sorted(inputs)]
        assert shards[f"{arch}|{multi}|{name}|inputs"] == want, name
        if mode == "serve":
            S = shape.seq_len
            sds = jax.eval_shape(lambda: model.init_cache(
                shape.global_batch, S, enc_len=S))
            want = jax.tree.leaves(jax.tree.map(
                lambda x, ax: ",".join(map(str, shard_shape(
                    mesh, rules.spec_for(ax, x.shape), x.shape))),
                sds, model.cache_axes(S),
                is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
            got = [",".join(map(str, s))
                   for s in shards[f"{arch}|{multi}|{name}|cache"]]
            assert got == want, name


# ---------------------------------------------------- activation constraints
@pytest.fixture(scope="module")
def acts(tmp_path_factory):
    return dict(map(tuple, run_worker("acts",
                                      tmp_path_factory.mktemp("acts"))))


def recorded_names(monkeypatch, modules, run):
    """The logical names of every ``shard_act`` call ``run()`` makes
    through ``modules``' own reference to it."""
    names = set()

    def record(x, *axes):
        names.add(tuple(axes))
        return x
    for mod in modules:
        monkeypatch.setattr(mod, "shard_act", record)
    run()
    return names


def jax_site_names(monkeypatch, arch):
    from repro.models import encdec, layers, mamba2, model, moe, transformer
    m = jax_build_model(jax_get_config(arch).reduced())
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    from repro.distributed.sharding import unbox
    batch = make_batch(get_config(arch).reduced(), 4, 64)
    return recorded_names(
        monkeypatch, (encdec, layers, mamba2, model, moe, transformer),
        lambda: jax.eval_shape(lambda p: m.loss(p, batch)[0], unbox(params)))


def port_site_names(monkeypatch, arch):
    from repro_torch.models import encdec, layers, mamba2, model, moe
    from repro_torch.models import transformer
    cfg = get_config(arch).reduced()
    m = build_model(cfg, attn_impl="plain")
    params = m.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 4,
                                                            64).items()}
    return recorded_names(
        monkeypatch, (encdec, layers, mamba2, model, moe, transformer),
        lambda: m.loss(params, batch))


@pytest.mark.parametrize("arch", W.ACT_ARCHS)
def test_shard_act_lays_dtensors_out_by_their_spec(acts, arch):
    records = acts[arch]
    assert records
    for names, got, want in records:
        assert got == want, names


@pytest.mark.parametrize("arch", W.ACT_ARCHS)
def test_shard_act_sites_match_jax(monkeypatch, acts, arch):
    """The port's calls name what the JAX model's calls name; every one
    the DTensor trace reached is among them (the MoE dispatch's and the
    expert FFN's constraints sit inside the per-rank MoE region, on local
    tensors, as the mixer's heads do in the SSD region)."""
    port = port_site_names(monkeypatch, arch)
    assert port == jax_site_names(monkeypatch, arch)
    assert {tuple(n) for n, _, _ in acts[arch]} <= port


def test_shard_act_without_context_returns_its_input():
    x = torch.zeros(2, 3, 4)
    assert SH.shard_act(x, "batch", None, "act_embed") is x
    with SH.set_active("mesh", SH.make_rules(
            get_config("olmo-1b"), W.ACT_MESH, "train")):
        assert SH.shard_act(x, "batch", None, "act_embed") is x


# ---------------------------------------------------------- step analysis
def test_step_counter_on_known_products(tmp_path):
    """A [M, K] x [K, N] fp32 product on 4 ranks, M, K, N = 8, 16, 32."""
    r = run_worker("known", tmp_path)
    M, K, N, g, f32 = W.KNOWN["M"], W.KNOWN["K"], W.KNOWN["N"], 4, 4
    out = r["output"]             # w sharded on N: no collective
    assert out["placements"] == ["Shard(dim=1)"]
    assert out["flops"] == 2 * M * K * N / g
    assert out["hbm_bytes"] == f32 * (M * K + K * N / g + M * N / g)
    assert out["collective_bytes"] == 0 and out["dot_count"] == 1
    con = r["contraction"]        # x on K, w on K: a partial sum, reduced
    assert con["placements"] == ["Replicate()"]
    assert con["flops"] == 2 * M * (K / g) * N
    assert con["hbm_bytes"] == f32 * (M * K / g + K / g * N + M * N
                                      + 2 * M * N)      # the all-reduce
    assert con["collective_by_type"] == {
        "all-reduce": 2 * (g - 1) / g * f32 * M * N}
    assert con["op_counts"]["all_reduce"] == 1
    assert con["peak_live_bytes"] == 2 * f32 * M * N
    rep = r["replicated"]         # every rank the whole product
    assert rep["flops"] == 2 * M * K * N
    assert rep["hbm_bytes"] == f32 * (M * K + K * N + M * N)
    assert rep["collective_bytes"] == 0


def test_step_counter_counts_the_mixed_dtype_product_as_mm():
    """``mm`` with ``out_dtype`` (``aten::mm.dtype``: bf16 operands, an
    fp32 result, the served logits' product) counts as a product like
    ``mm``, its result at fp32's four bytes an element."""
    M, K, N = 8, 16, 32
    a = torch.empty(M, K, dtype=torch.bfloat16, device="meta")
    b = torch.empty(K, N, dtype=torch.bfloat16, device="meta")
    with SA.StepCounter() as counter:
        c = torch.mm(a, b, out_dtype=torch.float32)
    counter.keep(c)
    r = counter.result()
    assert c.dtype == torch.float32
    assert r.flops == 2 * M * K * N and r.dot_count == 1
    assert r.hbm_bytes == 2 * (M * K + K * N) + 4 * M * N
    assert r.op_counts == {"mm": 1}


def test_wire_bytes_factors():
    assert SA.wire_bytes("all-reduce", 4, 100.0) == 150.0
    assert SA.wire_bytes("all-gather", 4, 100.0) == 75.0
    assert SA.wire_bytes("reduce-scatter", 16, 160.0) == 150.0
    assert SA.wire_bytes("all-to-all", 8, 100.0) == 100.0
    assert SA.wire_bytes("all-reduce", 1, 100.0) == 0.0


# ------------------------------------------------------------- one cell
def test_olmo_train_cell_end_to_end(tmp_path):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training.train_step import loss_and_grads
    info = run_worker("cell", tmp_path)
    assert info["chips"] == 256 and info["kind"] == "train"
    assert info["traced_repeats"] == [2, 3]
    for k in ("param_bytes", "opt_state_bytes", "mem_argument_bytes",
              "mem_output_bytes", "mem_temp_bytes", "mem_alias_bytes",
              "hlo_flops", "hlo_bytes"):
        assert info[k] > 0, k
    assert info["mem_alias_bytes"] == (info["param_bytes"]
                                       + info["opt_state_bytes"])
    coll = info["collective_bytes"]
    assert set(coll) - {"total"} and all(v > 0 for v in coll.values())
    assert coll["total"] == pytest.approx(
        sum(v for k, v in coll.items() if k != "total"))
    cfg = get_config("olmo-1b")
    model = build_model(cfg, attn_impl="plain")
    params = SH.unbox(model.init_annotated(0, device="meta"))
    shape = SHAPES["train_4k"]
    batch = {"tokens": torch.empty(shape.global_batch, shape.seq_len,
                                   dtype=torch.int32, device="meta")}
    with FlopCounterMode(display=False) as fc:
        loss_and_grads(model, params, batch)
    assert info["hlo_flops"] * 256 == fc.get_total_flops()


@pytest.mark.parametrize("arch,kind,seq,batch", [
    ("olmo-1b", "train", 256, 8), ("mamba2-780m", "train", 64, 4),
    ("mixtral-8x7b", "prefill", 64, 4)])
def test_extrapolated_step_equals_the_whole_trace(arch, kind, seq, batch,
                                                  tmp_path):
    """At smoke width on a (2, 2) fake mesh, in a process of its own:
    ``trace_cell``'s step, traced at two and three repeats of the layer
    stack and carried to all of them, against ``_trace_step`` of the
    whole stack.  The peak of live bytes is exact once the stack holds
    it: olmo-1b's training step at 8 x 64 peaks in its embedding's
    gradient and optimizer instead, 7.7 % below the whole trace's
    (measured), so it runs at 8 x 256."""
    code = (
        "import json, sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.configs.base import ShapeConfig, ShapeKind\n"
        "from repro_torch.distributed.sharding import make_rules\n"
        "from repro_torch.launch import dryrun as DR\n"
        "import torch_dryrun_worker as W\n"
        "cfg = get_config(sys.argv[1]).reduced()\n"
        "kind = ShapeKind(sys.argv[2])\n"
        "shape = ShapeConfig('x', int(sys.argv[4]), int(sys.argv[5]), kind)\n"
        "train = kind == ShapeKind.TRAIN\n"
        "out = [DR.trace_cell(cfg, shape, W.ACT_MESH)]\n"
        "with DR.fake_world(W.ACT_MESH.num_devices):\n"
        "    out.append(DR._trace_step(\n"
        "        cfg, shape, DR._mesh(W.ACT_MESH),\n"
        "        make_rules(cfg, W.ACT_MESH, 'train' if train else 'serve'),\n"
        "        'float32' if train else None))\n"
        "json.dump(out, open(sys.argv[3], 'w'))\n")
    path = tmp_path / "out.json"
    proc = subprocess.run(
        [sys.executable, "-c", code, arch, kind, str(path), str(seq),
         str(batch)],
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), str(Path(W.__file__).parent)]),
            OMP_NUM_THREADS="1"),
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cut, whole = json.loads(path.read_text())
    assert cut["traced_repeats"] == [2, 3]
    for k in DR.LINEAR_FIELDS + ("collective_bytes", "op_counts"):
        if k in whole:
            assert cut[k] == whole[k], k


# ------------------------------------------------------------- roofline
def test_roofline_terms_at_h100_peaks():
    info = {"arch": "olmo-1b", "shape": "train_4k", "kind": "train",
            "chips": 256, "kv_cache_dtype": "bfloat16", "tp": 16,
            "active_params_b": get_config("olmo-1b").active_param_count(),
            "hlo_flops": 4.0e13, "hlo_bytes": 2.0e12,
            "collective_bytes": {"all-reduce": 5.0e10, "total": 6.0e10}}
    r = DR.roofline_terms(info)
    assert (CM.PEAK_FLOPS, CM.HBM_BW, CM.ICI_BW) == (989e12, 3.35e12,
                                                     450e9)
    assert r["t_compute_s"] == 4.0e13 / 989e12
    assert r["t_memory_s"] == 2.0e12 / 3.35e12
    assert r["t_collective_s"] == 6.0e10 / 450e9
    assert r["dominant"] == "memory"
    shape = SHAPES["train_4k"]
    mf = 3.0 * 2.0 * info["active_params_b"] * shape.tokens / 256
    assert r["model_flops_per_device"] == mf
    assert r["useful_flops_frac"] == mf / 4.0e13
    assert r["mfu_bound"] == (mf / 989e12) / (2.0e12 / 3.35e12)
    ab = DR.analytic_bytes(get_config("olmo-1b"), shape, 256, 16)
    assert r["t_memory_lb_s"] == ab / 3.35e12
    # a shape outside SHAPES is rebuilt from the info's own fields
    r1 = DR.roofline_terms(dict(info, shape="calibration", seq_len=2048,
                                global_batch=4, chips=1, tp=1))
    assert r1["model_flops_per_device"] == 3.0 * 2.0 * info[
        "active_params_b"] * 4 * 2048


@pytest.mark.parametrize("arch", list_archs())
def test_cost_model_terms_match_reference(arch):
    ref, port = JaxCostModel(jax_get_config(arch)), CM.CostModel(
        get_config(arch))
    assert port.kv_bytes_per_token() == ref.kv_bytes_per_token()
    assert port.ssm_state_bytes() == ref.ssm_state_bytes()
    assert port.weights_bytes() == ref.weights_bytes()
    for ctx in (1, 4096, 32768, 524288):
        assert port.kv_bytes_total(ctx) == ref.kv_bytes_total(ctx)
        assert port.prefill_flops(ctx) == ref.prefill_flops(ctx)
    ctx = np.array([1, 100, 4096, 70000])
    np.testing.assert_array_equal(port._kv_bytes_total_arr(ctx),
                                  ref._kv_bytes_total_arr(ctx))
    assert CM.HBM_PER_CHIP == 80e9
