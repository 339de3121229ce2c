"""Plain fp32 reference of a Nemotron-4-style decoder (arXiv:2402.16819):
pre-norm LayerNorm blocks of grouped-query attention with RoPE and a
non-gated squared-ReLU MLP, untied embedding and head, no biases in the
products; an int8 KV cache where the configuration states one (its
decode steps read every cached key and value through the quantization).

Departures from the publication, each the configuration as it is run:
the norms' epsilon is the file's ``norm_eps`` (published 1e-5); the norm
is a plain LayerNorm, where the published one learns ``1 + scale``
(the same function under another parameterization); the rotary fraction
is the file's ``rotary_fraction``; the layers are the file's
``num_layers`` (a cut).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from flexbench.reference import common as C


def _norm(model):
    eps = float(model["norm_eps"])
    return lambda x, p: C.layer_norm(x, p["scale"], p["bias"], eps)


def mlp(x, p: Dict, precision: str):
    h = torch.relu(C.matmul(x, p["wi"], precision)).square()
    return C.matmul(h, p["wo"], precision)


def logits(weights: Dict, model: Dict, seqs: Sequence[Tuple],
           precision: str = "fp32") -> List[torch.Tensor]:
    """See ``common.forward``."""
    norm = _norm(model)

    def block(h, p, ctx):
        h = C.attention_sublayer(h, p, model, norm, **ctx)
        return h + mlp(norm(h, p["norm_ffn"]), p["mlp"], ctx["precision"])

    return C.forward(weights, model, seqs, block_fn=block, norm_fn=norm,
                     precision=precision)
