"""Plain fp32 reference of a Mixtral-style decoder (arXiv:2401.04088):
pre-norm RMSNorm blocks of grouped-query attention with RoPE and a
sliding window, and a sparse MoE FFN of SwiGLU experts with top-k
routing (the softmax of the k largest router logits, as published).

Departures from the publication, each the configuration as it is run:
the norms' epsilon is the file's ``norm_eps`` (published 1e-5); the
layers are the file's ``num_layers`` (a cut); the router runs in fp32.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from flexbench.reference import common as C


def _norm(model):
    eps = float(model["norm_eps"])
    return lambda x, p: C.rms_norm(x, p["scale"], eps)


def moe(x, p: Dict, model: Dict, precision: str):
    """The sparse FFN of x [L, d]: each token's top-k experts, weighted by
    the softmax of their router logits."""
    k = model["moe"]["top_k"]
    logits = x @ p["router"]                                  # fp32 [L, E]
    top, idx = torch.topk(logits, k, dim=-1)
    gate = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    for e in range(logits.shape[-1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(C.matmul(xe, p["w_gate"][e], precision)) * \
            C.matmul(xe, p["w_up"][e], precision)
        out = C.matmul(h, p["w_down"][e], precision)
        y.index_add_(0, rows, out * gate[rows, slot, None])
    return y


def logits(weights: Dict, model: Dict, seqs: Sequence[Tuple],
           precision: str = "fp32") -> List[torch.Tensor]:
    """See ``common.forward``."""
    norm = _norm(model)

    def block(h, p, ctx):
        h = C.attention_sublayer(h, p, model, norm, **ctx)
        return h + moe(norm(h, p["norm_ffn"]), p["moe"], model,
                       ctx["precision"])

    return C.forward(weights, model, seqs, block_fn=block, norm_fn=norm,
                     precision=precision)
