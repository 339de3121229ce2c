"""Collective helpers: an int8-compressed all-reduce on ``torch.distributed``.

The twin of ``repro/distributed/collectives.py``.  A data-parallel
gradient reduction runs in the gradients' dtype; to send fewer bytes, the
reduction has to run explicitly on quantized values.
``compressed_allreduce(group)`` returns a function of one rank's partial
``g`` that gives every rank the mean over the group's ranks of each
rank's ``q * scale``: ``q`` the int8 quantization of its ``g`` under one
fp32 scale (``amax / 127``, as ``_quant``), cast back to ``g``'s dtype.
That is the function the reference computes.

Wire design: each rank all-gathers the int8 payloads and the fp32 scales,
then sums the dequantized partials in fp32 in rank order, so every rank
holds the same bits (a replicated gradient must).  Bytes each rank sends
for a tensor of ``numel`` elements over ``n`` ranks, ring algorithms:

    this design (all-gather of int8)   (n - 1) * numel  (+ 4 (n - 1) scales)
    bf16 all-reduce                    4 (n - 1) / n * numel

so it halves a bf16 all-reduce's bytes at n = 2, matches them at n = 4,
and sends more beyond (n / 4 times as many).  The reference's claim of
about half bf16's payload does not hold for its own code either: it
computes an int32 sum of the int8 values, discards it, and reduces the
fp32 products ``q * scale``.  The port does not compute the discarded sum.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import collective_matmul_hint

__all__ = ["compressed_allreduce", "collective_matmul_hint", "wire_bytes"]


def _quant(g) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and their fp32 scale (``amax / 127``, at least 1e-12);
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale


def compressed_allreduce(group=None):
    """Returns fn(g) -> the mean over ``group``'s ranks (the default group
    when None) of each rank's dequantized int8 ``g``, in ``g``'s dtype and
    shape; every rank gets the same bits."""
    def fn(g):
        n = dist.get_world_size(group)
        q, scale = _quant(g.contiguous())   # NCCL gathers contiguous ones
        scale = scale.reshape(1)
        qs = [torch.empty_like(q) for _ in range(n)]
        scales = [torch.empty_like(scale) for _ in range(n)]
        dist.all_gather(qs, q, group=group)
        dist.all_gather(scales, scale, group=group)
        total = qs[0].float() * scales[0][0]
        for q_r, s_r in zip(qs[1:], scales[1:]):
            total = total + q_r.float() * s_r[0]
        return (total / n).to(g.dtype)
    return fn


def wire_bytes(numel: int, n: int) -> Tuple[float, float]:
    """(bytes this design sends a rank, bytes a bf16 ring all-reduce
    sends a rank) for one tensor of ``numel`` elements over ``n`` ranks."""
    return (n - 1) * (numel + 4.0), 4.0 * (n - 1) / n * numel
