"""One gloo rank of ``tests/test_torch_distributed.py`` (not a test file).

    python tests/torch_dist_rank.py RANK WORLD STORE_FILE IN_NPZ OUT_DIR

Imports torch and the port only.  The rank joins a gloo process group of
WORLD ranks through a ``FileStore`` (no port), then:

* for each mesh of ``MESHES``, arch of ``ARCHS`` and mode, lays the
  arch's ``.reduced()`` parameters (seed 0, on the CPU) out by
  ``make_shardings(mesh, make_rules(cfg, mesh, mode), ...)`` and keeps
  each leaf's ``to_local()`` shard and the rank's mesh coordinate;
* runs ``compressed_allreduce`` on its row of each input of IN_NPZ, over
  all ranks and over ranks 0 and 1 (a subgroup), in fp32 and bf16;
* under ``set_active`` on the (2, 2) mesh, redistributes a replicated
  ``DTensor`` by ``shard_act`` (logical names) and by
  ``collective_matmul_hint`` (an explicit spec), keeping the local shards;
* takes one data-parallel train step of olmo-1b ``.reduced()`` (seed 0)
  on ``make_batch(..., step=RANK)``, its gradients through the compressed
  all-reduce over all ranks (``make_train_step(..., group=)``);

and writes ``OUT_DIR/rank<R>.npz`` (every value as fp32, exact for bf16)
and ``OUT_DIR/rank<R>.json`` (the coordinates).
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as TR
from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig
from repro_torch.distributed.collectives import compressed_allreduce
from repro_torch.distributed.sharding import (collective_matmul_hint,
                                              make_rules, make_shardings,
                                              set_active, shard_act, unbox)
from repro_torch.launch.mesh import make_mesh_from_config
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, TrainConfig,
                                  init_train_state, make_batch,
                                  make_train_step)

MESHES = {"dm": MeshConfig((2, 2), ("data", "model")),
          "pdm": MeshConfig((2, 2, 1), ("pod", "data", "model"))}
ARCHS = ("olmo-1b", "mixtral-8x7b")
MODES = ("train", "serve")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DP_ARCH, DP_BATCH, DP_SEQ = "olmo-1b", 2, 32
DP_TCFG = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                      total_steps=4),
                      grad_compression="int8")


def activation():
    """The [batch, seq, embed] activation the context tests lay out."""
    return torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)


def cases():
    """(key, mesh name, arch, mode) in the order both sides list them."""
    return [(f"{m}|{a}|{mode}", m, a, mode)
            for m in MESHES for a in ARCHS for mode in MODES]


def main(rank: int, world: int, store: str, in_npz: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out, coords = {}, {}
        meshes = {m: make_mesh_from_config(c, "cpu")
                  for m, c in MESHES.items()}
        for key, m, arch, mode in cases():
            cfg = get_config(arch).reduced()
            ann = build_model(cfg).init_annotated(0, device="cpu")
            shardings = make_shardings(meshes[m], make_rules(
                cfg, MESHES[m], mode), ann)
            coords[m] = meshes[m].get_coordinate()
            for i, (value, s) in enumerate(zip(TR.leaves(unbox(ann)),
                                               TR.leaves(shardings))):
                local = s.distribute(value).to_local()
                out[f"{key}|{i}"] = local.float().numpy()
        from torch.distributed.tensor import Replicate, distribute_tensor
        act = distribute_tensor(activation(), meshes["dm"],
                                (Replicate(), Replicate()))
        rules = make_rules(get_config(DP_ARCH), MESHES["dm"], "train")
        with set_active(meshes["dm"], rules):
            out["act|shard_act"] = shard_act(
                act, "batch", None, "act_embed").to_local().numpy()
            out["act|hint"] = collective_matmul_hint(
                act, (None, "model")).to_local().numpy()
        inputs = np.load(in_npz)
        pair = dist.new_group([0, 1])
        for n, group in ((world, None), (2, pair)):
            if rank >= n:
                continue
            for name, dtype in DTYPES.items():
                x = torch.from_numpy(inputs[f"x{n}"][rank]).to(dtype)
                y = compressed_allreduce(group)(x)
                assert y.dtype == dtype and y.shape == x.shape
                out[f"allreduce|{n}|{name}"] = y.float().numpy()
        cfg = get_config(DP_ARCH).reduced()
        model = build_model(cfg)
        params, opt = init_train_state(model, DP_TCFG, 0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in make_batch(
            cfg, DP_BATCH, DP_SEQ, step=rank).items()}
        state = make_train_step(model, DP_TCFG, group=dist.group.WORLD)(
            params, opt, batch)[:2]
        for i, leaf in enumerate(TR.leaves(state)):
            out[f"dp|{i}"] = leaf.detach().float().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(coords, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
