"""AdamW on trees of tensors: the twin of ``repro/training/optimizer.py``.

The same update as the JAX package's: linear warmup and cosine decay,
clipping by the global norm, fp32 update math, moments kept in
``moment_dtype`` (fp32 by default, bf16 for the largest archs), no weight
decay on tensors of fewer than two dimensions, and each new parameter cast
back to its own dtype.  The JAX version returns new trees; this one
writes the parameters and moments in place under ``torch.no_grad()`` (so a
step holds no second copy of the parameters, and the parameters stay the
leaves autograd differentiates) and returns the same trees.  The step
count, the learning rate and the bias corrections are fp32 tensors on the
parameters' device, as JAX's are, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as TR


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"moment_dtype {name!r} is not a torch dtype")
    return dt


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, an fp32 scalar tensor on ``step``'s
    device (``step``: an int or an integer tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    """Zero moments in ``moment_dtype`` beside each parameter, and the step
    count, an int32 scalar on the parameters' device."""
    dt = _dtype(cfg.moment_dtype)
    leaves = TR.leaves(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {
        "m": TR.map_tree(zeros, params),
        "v": TR.map_tree(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in TR.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step.  Returns (params, state, metrics), the parameters and the
    moments updated in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if p.dim() >= 2 and cfg.weight_decay > 0:   # no decay on norms
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    for p, g, m, v in zip(TR.leaves(params), TR.leaves(grads),
                          TR.leaves(state["m"]), TR.leaves(state["v"])):
        upd(p, g, m, v)
    state = dict(state, step=step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
