"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on one rank of
a fake 256- or 512-rank mesh; the twin of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 512 fake host devices and
reads XLA's memory analysis and the post-SPMD HLO.  Here each cell runs
once, shape-only, in one process:

  * a ``"fake"`` process group of the mesh's ranks (``FakeStore``: every
    collective returns at once and moves nothing) and the production
    ``DeviceMesh`` over it (``launch/mesh.py``);
  * the model built with ``attn_impl="plain"``, the path the reference
    lowers (its model never calls its Pallas kernels either), its
    parameters from ``Model.init_annotated(device="meta")`` laid out as
    ``DTensor``s by the arch's sharding rules (``make_shardings``), the
    AdamW state beside them, the inputs from ``Model.input_specs`` and the
    caches from ``Model.init_cache``/``cache_axes``, all on ``meta``;
  * the step (train: loss, backward, AdamW; prefill; one decode token)
    under ``set_active(mesh, rules)``, so the models' ``shard_act``
    constraints lay their activations out (and their gradients, as JAX's
    do), and ``implicit_replication``, so tensors the models make
    themselves (RoPE tables, masks, positions) count as replicated; and
    under ``step_analysis.StepCounter``, which counts rank 0's local ops
    and collectives.

DTensor lays out the elementwise ops and reductions; the products and the
layers' cores run per rank on the local shards, laid out as GSPMD lays
them out (``distributed.sharding``: ``einsum_per_rank``,
``attend_per_rank`` with flash decoding over a cache split along T,
``per_rank`` regions for the SSD mixer and the one-hot MoE, the
vocab-parallel lookup and cross-entropy, the cache writes), since
DTensor's own strategies for them differ between torch versions or
gather whole tensors.  Nothing is allocated on any device: every tensor
is a ``meta`` shard.  A cell that DTensor cannot trace fails with the op
named, and ``main`` lists it; nothing is replicated to get past it.

For each cell this gives, per rank:
  * ``mem_argument_bytes``/``mem_output_bytes``/``mem_alias_bytes``: the
    local bytes of the step's arguments (parameters, AdamW state, inputs,
    caches), of its outputs, and of the outputs that reuse a donated
    argument (the parameters and moments, updated in place; the caches,
    written in place), as XLA's memory analysis reports them;
  * ``mem_temp_bytes``: the largest sum of local bytes the step itself
    held at once (``StepCounter.peak_live_bytes``), each storage live from
    the op that makes it to the last op that touches it, or to the step's
    end if the step returns it: liveness from the op stream, so the
    figure does not depend on when the tracing torch frees a tensor;
  * ``hlo_flops``/``hlo_bytes``/``collective_bytes`` from
    ``step_analysis`` (the reference's key names, so
    ``benchmarks/roofline.py``'s reader takes the JSON);
  * ``compile_s``: the trace's seconds (two and three repeats of the
    layer stack, carried to all of them, for a training or prefill step:
    ``trace_cell``);

and writes a JSON record under ``results/dryrun_torch/``.

Usage:
    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
from typing import Dict, Optional, Tuple

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import (SHAPES, MeshConfig, ModelConfig,
                                      ShapeConfig, ShapeKind,
                                      shape_applicable)
from repro_torch.launch.mesh import mesh_config
from repro_torch.serving import costmodel as CM

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


@contextlib.contextmanager
def fake_world(n: int):
    """A ``"fake"`` default process group of ``n`` ranks, this process rank
    0, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own process group; this "
                           "process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    import torch
    from repro_torch import tree as TR
    from torch.distributed.tensor import DTensor
    total = 0
    for t in TR.leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def _distribute(mesh, rules, values, axes):
    """``values`` (a tree of meta tensors) as DTensors laid out by the
    logical ``axes`` tree beside it."""
    from repro_torch import tree as TR
    from repro_torch.distributed.sharding import NamedSharding
    return TR.map_tree(
        lambda v, ax: NamedSharding(mesh, rules.spec_for(ax, v.shape))
        .distribute(v), values, axes)


def _repeats(cfg: ModelConfig) -> int:
    """How many times the layer stack repeats its block pattern; an
    encoder-decoder's two stacks are cut together, so 0 (it is traced
    whole) unless they are equally deep."""
    from repro_torch.models.transformer import num_repeats
    if not cfg.is_encdec:
        return num_repeats(cfg)
    return cfg.num_layers if cfg.encoder_layers == cfg.num_layers else 0


def _with_repeats(cfg: ModelConfig, r: int) -> ModelConfig:
    """``cfg`` with its layer stack cut to ``r`` repeats of its pattern."""
    if cfg.is_encdec:
        return dataclasses.replace(cfg, num_layers=r, encoder_layers=r)
    return dataclasses.replace(cfg, num_layers=r * cfg.num_layers
                               // _repeats(cfg))


# the fields of a traced step that grow by the same amount with each
# repeat of the layer stack
LINEAR_FIELDS = ("param_bytes", "opt_state_bytes", "cache_bytes",
                 "mem_argument_bytes", "mem_output_bytes", "mem_temp_bytes",
                 "mem_alias_bytes", "hlo_flops", "hlo_bytes", "hlo_dots")


def _extrapolate(two: Dict, three: Dict, n: int) -> Dict:
    """The step at ``n`` repeats from the steps at two and three:
    x(n) = x(2) + (n - 2) (x(3) - x(2)), field by field (an integer stays
    an integer).  From two repeats on, every repeat adds the same ops; the
    first may not (a prefill's RoPE tables die in it when no repeat
    follows, so its peak is lower)."""
    def line(a, b):
        return a + (n - 2) * (b - a)
    out = dict(two)
    for k in LINEAR_FIELDS:
        if k in two:
            out[k] = line(two[k], three[k])
    out["collective_bytes"] = {
        k: line(two["collective_bytes"].get(k, 0.0),
                three["collective_bytes"].get(k, 0.0))
        for k in sorted(set(two["collective_bytes"])
                        | set(three["collective_bytes"]))}
    out["op_counts"] = {
        k: line(two["op_counts"].get(k, 0), three["op_counts"].get(k, 0))
        for k in sorted(set(two["op_counts"]) | set(three["op_counts"]))}
    return out


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mcfg: MeshConfig, *,
               moment_dtype: Optional[str] = None,
               rule_overrides: Optional[dict] = None,
               flags: Tuple[str, ...] = (),
               serve_hbm_budget: float = 10e9) -> Dict:
    """Trace one step of ``cfg`` at ``shape`` on rank 0 of ``mcfg``'s mesh
    over a fake group (``lower_cell``'s body).  Returns the cell's
    ``info`` without its names.

    The layer stack is a Python loop, unrolled as it is traced, so a step
    of R repeats of the block pattern is R copies of one repeat's ops, on
    the same shapes and layouts.  With R > 3 a training or prefill step
    is traced at two and three repeats and every count is carried to R
    along that line, as the reference multiplies a ``while`` body by its
    trip count (``hlo_analysis.py``); its peak of live bytes lies in the
    stack and grows along the line too (by each repeat's saved residual
    in training, by nothing in a prefill).  A decode step (one token a
    layer, cheap to trace, its peak possibly in the head) traces all R.
    The rules and the AdamW moment dtype are the full model's."""
    import torch

    from repro_torch.distributed.sharding import make_rules

    train = shape.kind == ShapeKind.TRAIN
    rules = make_rules(cfg, mcfg, "train" if train else "serve",
                       hbm_budget_bytes=serve_hbm_budget,
                       overrides=rule_overrides, flags=flags)
    if train and moment_dtype is None:
        moment_dtype = "bfloat16" if cfg.param_count() > 5e10 else "float32"
    R = _repeats(cfg)
    cut = R > 3 and shape.kind != ShapeKind.DECODE
    t0 = time.time()
    with fake_world(mcfg.num_devices):
        mesh = _mesh(mcfg)
        if cut:
            info = _extrapolate(*(
                _trace_step(_with_repeats(cfg, r), shape, mesh, rules,
                            moment_dtype) for r in (2, 3)), R)
        else:
            info = _trace_step(cfg, shape, mesh, rules, moment_dtype)
    info.update(seq_len=shape.seq_len, global_batch=shape.global_batch,
                torch_version=torch.__version__,
                tp=dict(zip(mcfg.axes, mcfg.shape)).get("model", 1),
                traced_repeats=[2, 3] if cut else "all",
                compile_s=round(time.time() - t0, 1))
    return info


def _mesh(mcfg: MeshConfig):
    """The production mesh when ``mcfg`` is one, else ``mcfg``'s, over the
    fake group.  Its device type is ``cuda`` whatever the machine (no
    device is touched: the shards are ``meta``): on a ``cpu`` mesh DTensor
    stands an all-gather in for each all-to-all, as gloo needs, and a
    ``meta`` one has no device handle for its vocab-parallel lookups."""
    from repro_torch.launch.mesh import (make_mesh_from_config,
                                         make_production_mesh)
    for multi_pod in (False, True):
        if mcfg == mesh_config(multi_pod=multi_pod):
            return make_production_mesh(multi_pod=multi_pod,
                                        device_type="cuda")
    return make_mesh_from_config(mcfg, "cuda")


def _trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                moment_dtype: Optional[str]) -> Dict:
    """One traced step of ``cfg`` (see ``trace_cell``): its memory fields
    and ``StepCounter``'s counts."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import axes_tree, set_active, unbox
    from repro_torch.launch.step_analysis import StepCounter
    from repro_torch.models import build_model
    from repro_torch.models.model import Model
    from repro_torch.training import (AdamWConfig, TrainConfig, adamw_init,
                                      make_train_step)

    model = build_model(cfg, attn_impl="plain")
    ann = model.init_annotated(0, device="meta")
    axes = axes_tree(ann)
    params = _distribute(mesh, rules, unbox(ann), axes)
    values, in_axes = model.input_specs(shape)
    inputs = _distribute(mesh, rules, values, in_axes)
    mem: Dict[str, int] = {"param_bytes": _local_bytes(params)}
    counter = StepCounter()
    train = shape.kind == ShapeKind.TRAIN
    if train:
        tcfg = TrainConfig(opt=AdamWConfig(moment_dtype=moment_dtype))
        opt = adamw_init(tcfg.opt, unbox(ann))
        opt = {"m": _distribute(mesh, rules, opt["m"], axes),
               "v": _distribute(mesh, rules, opt["v"], axes),
               "step": distribute_tensor(opt["step"], mesh,
                                         (Replicate(),) * mesh.ndim)}
        mem["opt_state_bytes"] = _local_bytes(opt)
        args = (params, opt, inputs)
        step, aliased = make_train_step(model, tcfg), (params, opt)
    else:
        B, S = shape.global_batch, shape.seq_len
        cache = _distribute(mesh, rules, model.init_cache(
            B, S, enc_len=S, device="meta"), model.cache_axes(S))
        mem["cache_bytes"] = _local_bytes(cache)
        # the body under no_grad: DTensor cannot make its views of
        # tensors from outside inference mode inside it
        if shape.kind == ShapeKind.PREFILL:
            args = (params, inputs, cache)
            step = functools.partial(Model.prefill.__wrapped__, model)
        else:
            args = (params, inputs["tokens"], cache, inputs["lengths"])
            step = functools.partial(Model.decode.__wrapped__, model)
        aliased = (cache,)
    with set_active(mesh, rules), implicit_replication(), counter, \
            counter.naming_failures(), torch.set_grad_enabled(train):
        out = step(*args)
    counter.keep(out)
    roof = counter.result()
    return dict(
        mem,
        mem_argument_bytes=_local_bytes(args),
        mem_output_bytes=_local_bytes(out),
        mem_temp_bytes=roof.peak_live_bytes,
        mem_alias_bytes=_local_bytes(aliased),
        hlo_flops=roof.flops,
        hlo_bytes=roof.hbm_bytes,
        collective_bytes=dict(roof.collective_by_type,
                              total=roof.collective_bytes),
        hlo_loops=roof.loop_count,
        hlo_dots=roof.dot_count,
        op_counts=roof.op_counts,
    )


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               moment_dtype: Optional[str] = None,
               rule_overrides: Optional[dict] = None,
               flags: Tuple[str, ...] = (),
               cfg_overrides: Optional[dict] = None,
               serve_hbm_budget: float = 10e9) -> Dict:
    """Trace one (arch, shape, mesh) cell.  Returns its ``info``."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell skipped by assignment rule: {reason}")
    mcfg = mesh_config(multi_pod=multi_pod)
    info = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi_pod_2x16x16" if multi_pod else "single_pod_16x16",
        "chips": mcfg.num_devices,
        "kind": shape.kind.value,
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "remat": cfg.remat,
        "params_b": cfg.param_count(),
        "active_params_b": cfg.active_param_count(),
    }
    info.update(trace_cell(cfg, shape, mcfg, moment_dtype=moment_dtype,
                           rule_overrides=rule_overrides, flags=flags,
                           serve_hbm_budget=serve_hbm_budget))
    return info


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                   tp: int) -> float:
    """Lower-bound per-device HBM bytes for one step (ideal fusion): weights
    + optimizer traffic + layer activations + KV cache + logits.  The
    traced value is the upper bound (no fusion at all); truth lies
    between."""
    bp = 2 if "16" in cfg.param_dtype else 4
    params, active = cfg.param_count(), cfg.active_param_count()
    B_loc = max(1, shape.global_batch // (chips // tp))
    d, L, V = cfg.d_model, cfg.num_layers + cfg.encoder_layers, cfg.vocab_size
    cm = CM.CostModel(cfg)
    if shape.kind == ShapeKind.TRAIN:
        S = shape.seq_len
        weights = 3.0 * active * bp / tp              # fwd + remat-fwd + bwd
        opt = params * (4 + 4 + 4 + 4 + 2 + 2) / chips  # m,v r/w grads p
        acts = 3.0 * 6 * L * B_loc * S * d * 2
        logits = 4.0 * B_loc * S * V * 2 / tp
        return weights + opt + acts + logits
    if shape.kind == ShapeKind.PREFILL:
        S = shape.seq_len
        weights = active * bp / tp
        acts = 6 * L * B_loc * S * d * 2
        kv = B_loc * S * cm.kv_bytes_per_token()
        return weights + acts + kv
    # decode
    weights = active * bp / tp
    kv = B_loc * (cm.kv_bytes_total(shape.seq_len) + cm.ssm_state_bytes())
    return weights + kv


def roofline_terms(info: Dict) -> Dict:
    """The reference's roofline at one H100's peaks (``serving.costmodel``:
    bf16 dense, HBM, NVLink each way); all numerators are per rank.  A
    shape outside ``SHAPES`` is rebuilt from ``info``'s ``seq_len`` and
    ``global_batch``, and ``tp`` is its mesh's ``model`` axis (16 on the
    production meshes, as the reference fixes it)."""
    PEAK, BW, LINK = CM.PEAK_FLOPS, CM.HBM_BW, CM.ICI_BW
    t_compute = info["hlo_flops"] / PEAK
    t_memory = info["hlo_bytes"] / BW
    t_coll = info["collective_bytes"].get("total", 0.0) / LINK
    cfg = get_config(info["arch"])
    if info.get("kv_cache_dtype"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype=info["kv_cache_dtype"])
    shape = SHAPES.get(info["shape"]) or ShapeConfig(
        info["shape"], info["seq_len"], info["global_batch"],
        ShapeKind(info["kind"]))
    tp = info.get("tp", 16)
    a_bytes = analytic_bytes(cfg, shape, info["chips"], tp)
    t_memory_lb = a_bytes / BW
    tokens = {"train": shape.tokens, "prefill": shape.tokens,
              "decode": shape.global_batch}[info["kind"]]
    mult = 3.0 if info["kind"] == "train" else 1.0  # fwd+bwd
    model_flops = mult * 2.0 * info["active_params_b"] * tokens \
        / info["chips"]
    dominant = max(
        [("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)], key=lambda kv: kv[1])[0]
    dominant_lb = max(
        [("compute", t_compute), ("memory", t_memory_lb),
         ("collective", t_coll)], key=lambda kv: kv[1])[0]
    step = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_lb_s": t_memory_lb,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "dominant_lb": dominant_lb,
        "model_flops_per_device": model_flops,
        "useful_flops_frac": model_flops / info["hlo_flops"]
        if info["hlo_flops"] else 0.0,
        "mfu_bound": (model_flops / PEAK) / step if step else 0.0,
    }


def cell_line(info: Dict) -> str:
    """One line for a cell: per-rank GB (and whether they fit one card),
    FLOPs, collective bytes by type, roofline terms and trace seconds."""
    gb = per_rank_bytes(info) / 1e9
    roof = info["roofline"]
    coll = {k: f"{v:.3e}" for k, v in info["collective_bytes"].items()}
    return (f"{info['arch']} x {info['shape']} x {info['mesh']}: "
            f"{gb:.2f} GB/rank (fits {CM.HBM_PER_CHIP / 1e9:.0f} GB: "
            f"{gb * 1e9 <= CM.HBM_PER_CHIP}), flops {info['hlo_flops']:.4e}, "
            f"bytes {info['hlo_bytes']:.4e}, collectives {coll}, "
            f"t_compute {roof['t_compute_s']:.4e} s, t_memory "
            f"{roof['t_memory_s']:.4e} s, t_collective "
            f"{roof['t_collective_s']:.4e} s ({roof['dominant']}), "
            f"trace {info['compile_s']} s, torch {info['torch_version']}")


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             verbose: bool = True) -> Dict:
    info = lower_cell(arch, shape_name, multi_pod=multi_pod)
    info["roofline"] = roofline_terms(info)
    if verbose:
        print(f"--- {cell_line(info)}")
    os.makedirs(outdir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}.json"
    with open(os.path.join(outdir, fname), "w") as f:
        json.dump(info, f, indent=1)
    return info


def per_rank_bytes(info: Dict) -> int:
    """The bytes one rank holds at the step's peak: its arguments, the
    outputs that do not reuse them, and its temporaries."""
    return (info["mem_argument_bytes"] + info["mem_output_bytes"]
            - info["mem_alias_bytes"] + info["mem_temp_bytes"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = list_archs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for sname in shapes:
            ok, reason = shape_applicable(cfg, SHAPES[sname])
            if not ok:
                print(f"SKIP {arch} x {sname}: {reason}")
                continue
            for mp in meshes:
                try:
                    run_cell(arch, sname, mp, args.outdir)
                except Exception as e:
                    failures.append((arch, sname, mp, repr(e)[:300]))
                    print(f"FAIL {arch} x {sname} multi={mp}: {e!r}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL CELLS TRACED OK")


if __name__ == "__main__":
    main()
