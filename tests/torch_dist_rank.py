"""One gloo rank of ``tests/test_torch_distributed.py`` and
``tests/test_torch_dist_regions.py`` (not a test file).

    python tests/torch_dist_rank.py RANK WORLD STORE_FILE IN_NPZ OUT_DIR
    python tests/torch_dist_rank.py regions RANK WORLD STORE_FILE OUT_DIR

Imports torch and the port only.  The rank joins a gloo process group of
WORLD ranks through a ``FileStore`` (no port).  The ``regions`` job runs
the models on ``DTensor`` parameters (``regions``, below); the other one:

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
  on ``make_batch(..., step=RANK)``, its gradients averaged over all
  ranks and then fake-quantized to int8 (``make_train_step(...,
  group=)``); then the same step again with every parameter in fp32 and
  the embedding left in fp32 (``fp32_end_to_end``), which the test holds
  against the JAX package's step on four host devices;

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
from repro_torch.training import (AdamWConfig, TrainConfig, adamw_init,
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


# the per-rank regions' job: archs, global batch and prompt, and the
# serving layouts (name, batch, HBM budget of make_rules: 0 lays the
# weights out FSDP as well)
REGION_ARCHS = ("olmo-1b", "mixtral-8x7b", "jamba-1.5-large-398b")
REGION_BATCH, REGION_SEQ, REGION_PROMPT = 4, 64, 48
SERVE_CASES = (("b2", 2, 10e9), ("b1", 1, 10e9), ("b1_fsdp", 1, 0.0))


def fp32_end_to_end():
    """Keep the embedded tokens in fp32 (``Model._embed`` rounds them to
    bf16): with fp32 parameters the whole step then runs in fp32."""
    from repro_torch.distributed.sharding import embed_rows
    from repro_torch.models import model as TMM
    TMM.Model._embed = lambda self, p, t: embed_rows(p["embed"], t)


def region_config(arch: str):
    """``arch``'s ``.reduced()`` config with an fp32 KV cache (so a decode
    reads back what the prefill computed, not its bf16 rounding)."""
    import dataclasses
    return dataclasses.replace(get_config(arch).reduced(),
                               kv_cache_dtype="float32")


def region_params(model):
    """The model's seed-0 parameters in fp32 and their logical axes."""
    from repro_torch.distributed.sharding import axes_tree
    ann = model.init_annotated(0, device="cpu")
    return TR.map_tree(lambda t: t.float(), unbox(ann)), axes_tree(ann)


def region_batch(cfg):
    return {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, REGION_BATCH, REGION_SEQ).items()}


def region_steps(model, params, batch, cache, serve_layout):
    """The serving half of a region case, in whatever layout its tensors
    have: the prefill of ``batch``'s first REGION_PROMPT tokens into
    ``cache``, then one decode step of the next token.  Returns
    {name: tensor} of the prefill's and the decode's logits and every
    cache leaf after each."""
    from repro_torch.models.model import Model
    out = {}
    with torch.no_grad():
        tokens = batch["tokens"]
        logits, cache, lengths = Model.prefill.__wrapped__(
            model, params, {"tokens": serve_layout(
                tokens[:, :REGION_PROMPT], ("batch", None))}, cache)
        out["prefill"] = logits
        for i, c in enumerate(TR.leaves(cache)):
            out[f"prefill_cache{i}"] = c.clone()
        logits, cache = Model.decode.__wrapped__(
            model, params, serve_layout(tokens[:, REGION_PROMPT],
                                        ("batch",)), cache, lengths)
        out["decode"] = logits
        for i, c in enumerate(TR.leaves(cache)):
            out[f"decode_cache{i}"] = c
    return out


def regions(rank: int, world: int, store: str, out_dir: str):
    """For each mesh of ``MESHES`` and arch of ``REGION_ARCHS`` (fp32 end
    to end, the plain path the dry-run traces): the training loss, its
    metrics and the gradient of every parameter with the parameters and
    batch laid out as ``DTensor``s by the train rules, under
    ``set_active`` and ``implicit_replication`` as the dry-run runs them;
    and for each of ``SERVE_CASES`` the prefill and one decode step with
    the parameters, prompt and cache laid out by the serve rules.  Every
    result is gathered whole (``full_tensor``); rank 0 writes them to
    ``OUT_DIR/regions.npz`` and the cache leaves' placements to
    ``OUT_DIR/regions.json``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.training.train_step import loss_and_grads
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    fp32_end_to_end()
    out, layouts = {}, {}

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t
                ).detach().float().numpy()
    try:
        for m, mcfg in MESHES.items():
            mesh = make_mesh_from_config(mcfg, "cpu")
            for arch in REGION_ARCHS:
                cfg = region_config(arch)
                model = build_model(cfg, attn_impl="plain")
                params, axes = region_params(model)
                batch = region_batch(cfg)

                def laid_out(rules, values, names):
                    return TR.map_tree(lambda v, ax: NamedSharding(
                        mesh, rules.spec_for(ax, v.shape)).distribute(v),
                        values, names)
                rules = make_rules(cfg, mcfg, "train")
                with set_active(mesh, rules), implicit_replication():
                    loss, metrics, grads = loss_and_grads(
                        model, laid_out(rules, params, axes),
                        laid_out(rules, batch, {k: ("batch", None)
                                                for k in batch}))
                key = f"{m}|{arch}"
                out[f"{key}|train|loss"] = whole(loss)
                out[f"{key}|train|aux"] = whole(metrics["aux"])
                for i, g in enumerate(TR.leaves(grads)):
                    out[f"{key}|train|grad{i}"] = whole(g)
                for name, B, budget in SERVE_CASES:
                    rules = make_rules(cfg, mcfg, "serve",
                                       hbm_budget_bytes=budget)
                    cache = laid_out(rules, model.init_cache(
                        B, REGION_SEQ, device="cpu"),
                        model.cache_axes(REGION_SEQ))
                    layouts[f"{key}|{name}"] = [
                        [str(p) for p in c.placements]
                        for c in TR.leaves(cache)]
                    with set_active(mesh, rules), implicit_replication():
                        got = region_steps(
                            model, laid_out(rules, params, axes),
                            {"tokens": batch["tokens"][:B]}, cache,
                            lambda t, ax: NamedSharding(mesh, rules.spec_for(
                                ax, t.shape)).distribute(t))
                    for k, v in got.items():
                        out[f"{key}|{name}|{k}"] = whole(v)
        if rank == 0:
            np.savez(os.path.join(out_dir, "regions.npz"), **out)
            with open(os.path.join(out_dir, "regions.json"), "w") as f:
                json.dump(layouts, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


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
        step = make_train_step(model, DP_TCFG, group=dist.group.WORLD)
        state = step(params, opt, batch)[:2]
        for i, leaf in enumerate(TR.leaves(state)):
            out[f"dp|{i}"] = leaf.detach().float().numpy()
        fp32_end_to_end()
        params, _ = init_train_state(model, DP_TCFG, 0, device="cpu")
        params = TR.map_tree(lambda t: t.float(), params)
        state = step(params, adamw_init(DP_TCFG.opt, params), batch)[:2]
        for i, leaf in enumerate(TR.leaves(state)):
            out[f"dp32|{i}"] = leaf.detach().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(coords, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "regions":
        regions(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
