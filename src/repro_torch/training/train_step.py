"""Training step: loss -> backward -> data-parallel mean -> optional int8
fake-quant of the gradients -> AdamW; the twin of
``repro/training/train_step.py``.

The gradient comes from autograd over ``Model.loss``.  On the card every
attention layer's forward runs the hand-written flash kernel and its
backward the hand-written ``flash_attention_bwd`` kernel
(``kernels.ops.FlashAttentionFn``), every Mamba-2 layer's the SSD scan
and its backward kernel (``kernels.ops.SSDScanFn``); MoE FFNs take their
gradient through the sorted expert dispatch (``models/moe.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import tree as TR
from repro_torch.distributed.sharding import laid_out_as
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_compression: str = "none"      # "none" | "int8"


@torch.no_grad()
def quantize_dequantize_int8(g):
    """Per-tensor symmetric int8 fake-quant: models the precision of an int8
    gradient all-reduce.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so both packages give the same bits."""
    if g.dim() == 0:
        return g
    gf = g.float()
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return (q * scale).to(g.dtype)


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads): the loss of ``batch`` and its gradient with
    respect to every leaf of ``params`` (each made a leaf that requires
    grad), in a tree of the same structure."""
    leaves = TR.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    grads = [laid_out_as(g, p) for g, p in
             zip(torch.autograd.grad(loss, leaves), leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            TR.unflatten_like(params, grads))


def grad_mean(group):
    """Returns fn(g) -> the mean over ``group``'s ranks of each rank's
    ``g``: the ranks' gradients all-gathered, summed in ``g``'s dtype in
    rank order and divided by the group's size, so every rank holds the
    same bits."""
    def fn(g):
        n = dist.get_world_size(group)
        g = g.contiguous()          # NCCL gathers into contiguous buffers
        parts = [torch.empty_like(g) for _ in range(n)]
        dist.all_gather(parts, g, group=group)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total / n
    return fn


def make_train_step(model: Model, tcfg: TrainConfig, *, group=None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics).  The parameters and moments are updated in place (see
    ``training/optimizer.py``).

    With a data-parallel process ``group`` each rank takes the gradient of
    its own shard of the batch, and the ranks' gradients are averaged
    (``grad_mean``) before anything else: the gradient of the mean loss
    over the global batch wherever every rank's shard has as many
    unmasked tokens (``make_batch``'s batches do), which is what the JAX
    twin takes under GSPMD.  ``grad_compression="int8"`` then fake-quantizes
    that mean, Q(mean_r g_r), as the JAX twin does.  The wire-level int8
    all-reduce (``distributed.collectives.compressed_allreduce``) computes
    mean_r Q(g_r), another function, and no train step calls it."""
    if tcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {tcfg.grad_compression!r} not "
                         f"in ('none', 'int8')")
    reduce = grad_mean(group) if group is not None else None

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch)
        if reduce is not None:
            grads = TR.map_tree(reduce, grads)
        if tcfg.grad_compression == "int8":
            grads = TR.map_tree(quantize_dequantize_int8, grads)
        params, opt_state, opt_metrics = adamw_update(
            tcfg.opt, grads, opt_state, params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, tcfg: TrainConfig, seed: int = 0, *,
                     device="cuda"):
    """(params, opt_state): ``model.init(seed)`` on ``device`` and AdamW's
    zero state beside it (``loss_and_grads`` makes each parameter a leaf
    that requires grad).  The JAX twin also returns the annotated tree of
    its sharding axes; here ``model.init_annotated`` gives that tree."""
    params = model.init(seed, device=device)
    return params, adamw_init(tcfg.opt, params)
