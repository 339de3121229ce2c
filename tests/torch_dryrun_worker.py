"""One process of ``tests/test_torch_dryrun.py`` (not a test file): the
parts that start a ``"fake"`` process group, each in its own process so no
test worker keeps a global group.

    python tests/torch_dryrun_worker.py JOB OUT_JSON

JOB is one of:

* ``shards``: for every arch at full width, both production meshes and
  every applicable ``SHAPES`` cell, the local shape on rank 0 of each
  parameter (and so each AdamW moment), input and cache leaf as the
  dry-run lays it out (``dryrun._distribute``), in leaf order;
* ``acts``: olmo-1b, mixtral-8x7b, mamba2-780m and seamless-m4t-medium
  ``.reduced()`` on the plain path on a (2, 2) fake mesh: one loss under
  ``set_active`` with every ``shard_act`` call on a ``DTensor`` recorded
  (its logical names, the placements of its result and the placements
  ``placements(mesh, rules.spec_for(names, shape))`` gives);
* ``known``: ``StepCounter`` over three products on a 4-rank mesh: one
  sharded on its output, one on its contraction (then its all-reduce),
  one replicated;
* ``cell``: ``lower_cell("olmo-1b", "train_4k", multi_pod=False)``.

Imports torch and the port only.
"""
import json
import sys

import torch

from repro_torch import tree as TR
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, MeshConfig, shape_applicable
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import mesh_config
from repro_torch.models import build_model

ACT_ARCHS = ("olmo-1b", "mixtral-8x7b", "mamba2-780m", "seamless-m4t-medium")
ACT_MESH = MeshConfig((2, 2), ("data", "model"))
KNOWN = dict(M=8, K=16, N=32)


def local_shapes(tree):
    return [list(t.to_local().shape) for t in TR.leaves(tree)]


def shards():
    from repro_torch.distributed.sharding import axes_tree, make_rules, unbox
    out = {}
    for multi in (False, True):
        mcfg = mesh_config(multi_pod=multi)
        with DR.fake_world(mcfg.num_devices):
            mesh = DR._mesh(mcfg)
            for arch in list_archs():
                cfg = get_config(arch)
                model = build_model(cfg, attn_impl="plain")
                ann = model.init_annotated(0, device="meta")
                for mode in ("train", "serve"):
                    rules = make_rules(cfg, mcfg, mode)
                    out[f"{arch}|{multi}|{mode}|params"] = local_shapes(
                        DR._distribute(mesh, rules, unbox(ann),
                                       axes_tree(ann)))
                for name, shape in SHAPES.items():
                    if not shape_applicable(cfg, shape)[0]:
                        continue
                    mode = "train" if shape.kind.value == "train" else "serve"
                    rules = make_rules(cfg, mcfg, mode)
                    values, axes = model.input_specs(shape)
                    out[f"{arch}|{multi}|{name}|inputs"] = local_shapes(
                        DR._distribute(mesh, rules, values, axes))
                    if mode == "serve":
                        S = shape.seq_len
                        cache = model.init_cache(shape.global_batch, S,
                                                 enc_len=S, device="meta")
                        out[f"{arch}|{multi}|{name}|cache"] = local_shapes(
                            DR._distribute(mesh, rules, cache,
                                           model.cache_axes(S)))
    return out


def acts():
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import encdec, layers, mamba2, model, moe
    from repro_torch.models import transformer
    from repro_torch.training import make_batch
    records = []
    real = SH.shard_act

    def recorded(x, *names):
        y = real(x, *names)
        if SH.is_dtensor(x):         # not a per-rank region's local tensor
            mesh, rules = SH._ACTIVE.ctx
            want = SH.placements(mesh, rules.spec_for(names, x.shape),
                                 x.dim())
            records[-1][1].append([list(names),
                                   [str(p) for p in y.placements],
                                   [str(p) for p in want]])
        return y
    for mod in (encdec, layers, mamba2, model, moe, transformer):
        mod.shard_act = recorded
    with DR.fake_world(ACT_MESH.num_devices):
        mesh = DR._mesh(ACT_MESH)
        for arch in ACT_ARCHS:
            cfg = get_config(arch).reduced()
            m = build_model(cfg, attn_impl="plain")
            ann = m.init_annotated(0, device="meta")
            rules = SH.make_rules(cfg, ACT_MESH, "train")
            params = DR._distribute(mesh, rules, SH.unbox(ann),
                                    SH.axes_tree(ann))
            batch = {k: torch.from_numpy(v).to("meta")
                     for k, v in make_batch(cfg, 4, 64).items()}
            batch = DR._distribute(mesh, rules, batch, {
                k: ("batch",) + (None,) * (v.dim() - 1)
                for k, v in batch.items()})
            records.append([arch, []])
            with SH.set_active(mesh, rules), implicit_replication():
                m.loss(params, batch)
    return records


def known():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.step_analysis import StepCounter
    M, K, N = KNOWN["M"], KNOWN["K"], KNOWN["N"]
    out = {}
    with DR.fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        for name, px, pw in (("output", Replicate(), Shard(1)),
                             ("contraction", Shard(1), Shard(0)),
                             ("replicated", Replicate(), Replicate())):
            x = distribute_tensor(torch.empty(M, K, device="meta"), mesh,
                                  (px,))
            w = distribute_tensor(torch.empty(K, N, device="meta"), mesh,
                                  (pw,))
            counter = StepCounter()
            with counter:
                y = torch.mm(x, w)
                if name == "contraction":
                    y = y.redistribute(mesh, (Replicate(),))
            r = counter.result().as_dict()
            r["placements"] = [repr(p) for p in y.placements]
            out[name] = r
    return out


def cell():
    return DR.lower_cell("olmo-1b", "train_4k", multi_pod=False)


if __name__ == "__main__":
    torch.set_num_threads(1)
    job, path = sys.argv[1], sys.argv[2]
    result = {"shards": shards, "acts": acts, "known": known,
              "cell": cell}[job]()
    with open(path, "w") as f:
        json.dump(result, f)
