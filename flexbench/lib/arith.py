"""Operations and bytes of the model step and of the attention kernels,
and the roofline bound: the benchmark's own arithmetic, from the
configuration file's sizes alone.

The kernels' counts and ``bound`` are frozen copies of ``chip_smoke.py``
(``bound``, and the FLOP and byte formulas of its flash and paged
timings): each input read once and each output written once; a bound is
the larger of operations over the bf16 tensor-core peak and bytes over
the HBM bandwidth.  Peaks: one NVIDIA H100 SXM (data sheet, dense, 700 W).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """Least time on the card for the work: operations over the bf16 peak
    or bytes over HBM bandwidth, whichever is larger."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of a causal prompt of S tokens, each query seeing
    at most ``window`` keys (0: no window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    # rows 0 .. window-1 see i + 1 keys, the rest see `window`
    return window * (window + 1) // 2 + (S - window) * window


def flash_call(S: int, H: int, KVH: int, D: int, window: int = 0,
               elt: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one causal prefill call of the flash kernel
    on one sequence of S tokens: 4 H D a (q, k) pair; q and out
    [S, H, D], k and v [S, KVH, D], each read or written once."""
    flops = 4.0 * H * D * causal_pairs(S, window)
    nbytes = 2 * (S * H * D + S * KVH * D) * elt
    return flops, nbytes


def paged_call(lens: Iterable[int], H: int, KVH: int, D: int, ps: int,
               elt: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one decode call of the paged kernel: one
    query token a row attending ``lens[b]`` cached positions; q read and
    out written, the K and V rows used, the page-table rows and the
    lengths (int32)."""
    lens = [int(n) for n in lens]
    B, n_tok = len(lens), sum(lens)
    flops = 4.0 * H * D * n_tok
    nbytes = (2 * B * H * D * elt
              + 2 * n_tok * KVH * D * elt
              + sum(math.ceil(n / ps) for n in lens) * 4
              + B * 4)
    return flops, nbytes


def page_size(T: int) -> int:
    """Tokens a page when a cache of T slots is viewed as pages (the
    port's slot caches: the largest power of two up to 64 dividing T)."""
    return math.gcd(T, 64)


class ModelArith:
    """Model FLOPs of a configuration file's ``model`` sizes: the work the
    result needs.  A token's products use 2 x the parameters it
    activates (attention projections, the dense MLP, or the router and
    top-k experts); attention adds 4 H D a (q, k) pair; the output head
    runs once a prefill (the last position) and once a decode row."""

    def __init__(self, model: Dict):
        m = model
        self.L = int(m["num_layers"])
        self.d = int(m["d_model"])
        self.H = int(m["num_heads"])
        self.KVH = int(m["num_kv_heads"])
        self.D = int(m["head_dim"])
        self.f = int(m["d_ff"])
        self.V = int(m["vocab_size"])
        self.window = int(m.get("sliding_window", 0))
        gated = m["activation"] in ("swiglu", "geglu")
        mats = 3 if gated else 2
        attn = self.d * self.H * self.D * 2 + self.d * self.KVH * self.D * 2
        moe = m.get("moe")
        if moe:
            ffn = self.d * moe["num_experts"] + \
                moe["top_k"] * mats * self.d * self.f
        else:
            ffn = mats * self.d * self.f
        self.layer_params = attn + ffn      # activated by one token
        self.head_params = self.d * self.V

    def prefill_flops(self, S: int) -> float:
        per_layer = 2.0 * S * self.layer_params + \
            4.0 * self.H * self.D * causal_pairs(S, self.window)
        return self.L * per_layer + 2.0 * self.head_params

    def decode_flops(self, contexts: Iterable[int]) -> float:
        """One decode step over the active rows, each attending its
        ``contexts`` entry (already cut to the window)."""
        total = 0.0
        for c in contexts:
            total += self.L * (2.0 * self.layer_params
                               + 4.0 * self.H * self.D * int(c)) \
                + 2.0 * self.head_params
        return total
