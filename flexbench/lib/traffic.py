"""The one traffic generator: it reads a cell's traffic file (a JSON
object of parameters, ``workloads/<cell>.json``) and the run's seed.

The sizes and gaps come from a fixed pool drawn from the file's
``base_seed``; the run's seed only reorders them inside blocks of
consecutive entries (the file's ``reorder_block``, or 32) and draws the
prompts' token ids.  So every seed serves the same set of prompt and output lengths and the same
arrival gaps (up to the last, partial block), in another order: seeds
change the order, not the amount of work.

An open loop (``"loop": "open"``) sends each request when it is due,
whatever the engine is doing.  A closed loop (``"loop": "closed"``) has
``clients`` clients, started evenly over ``ramp_s``; each sends its next
request when its last one ends.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

from flexbench.lib import samplers

BLOCK = 32


@dataclasses.dataclass(frozen=True)
class Item:
    """One request's sizes: its prompt's token ids and its output length."""
    prompt: np.ndarray
    max_new: int


def _clipped(spec: Dict, rng, n: int) -> np.ndarray:
    knobs = {k: v for k, v in spec.items()
             if k not in ("dist", "mean", "min", "max")}
    x = samplers.lengths(spec["dist"], rng, n, spec["mean"], **knobs)
    return np.clip(x, spec["min"], spec["max"]).astype(int)


def _block_order(rng, n: int, block: int) -> np.ndarray:
    """A permutation of range(n) that moves entries only inside blocks of
    ``block`` consecutive indices."""
    order = np.arange(n)
    for b0 in range(0, n, block):
        order[b0:b0 + block] = b0 + rng.permutation(min(block, n - b0))
    return order


def _seed_rng(seed: int, stream: int):
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def pool_size(traffic: Dict, seconds: float) -> int:
    """Requests the run may need.  Open loop: every arrival of the warm-up
    and the window, with room for the gaps' spread.  Closed loop: the
    file's ``pool``."""
    if traffic["loop"] == "open":
        n = traffic["arrival"]["rate"] * (traffic["warm_s"] + seconds)
        return int(math.ceil(1.5 * n)) + BLOCK
    return int(traffic["pool"])


def block(traffic: Dict) -> int:
    """Entries a seed reorders among: the file's ``reorder_block``, or
    ``BLOCK``.  A smaller block keeps each seed's work nearer in time to
    every other seed's, so that the tails of an open loop spread less
    between seeds."""
    return int(traffic.get("reorder_block", BLOCK))


def items(traffic: Dict, seed: int, vocab: int, seconds: float) -> List[Item]:
    """The run's requests in the order they are sent."""
    n = pool_size(traffic, seconds)
    base = np.random.default_rng(int(traffic["base_seed"]))
    plens = _clipped(traffic["prompt"], base, n)
    olens = _clipped(traffic["output"], base, n)
    order = _block_order(_seed_rng(seed, 0), n, block(traffic))
    toks = _seed_rng(seed, 1)
    return [Item(prompt=toks.integers(0, vocab, int(plens[i])),
                 max_new=int(olens[i])) for i in order]


def arrivals(traffic: Dict, seed: int, seconds: float) -> np.ndarray:
    """Open loop: each request's due time, seconds from the traffic's
    start.  The gaps come from the base pool, reordered by the seed."""
    arr = dict(traffic["arrival"])
    process, rate = arr.pop("process"), arr.pop("rate")
    n = pool_size(traffic, seconds)
    base = np.random.default_rng(int(traffic["base_seed"]) + 1)
    t = samplers.arrivals(process, base, n, rate, **arr)
    gaps = np.diff(t, prepend=0.0)
    return np.cumsum(gaps[_block_order(_seed_rng(seed, 2), n,
                                       block(traffic))])


def client_starts(traffic: Dict) -> np.ndarray:
    """Closed loop: when each client sends its first request, seconds
    from the traffic's start, evenly over the ramp."""
    c = int(traffic["clients"])
    return np.arange(c) * (float(traffic["ramp_s"]) / c)


def lead_s(traffic: Dict) -> float:
    """Seconds of traffic before the measured window opens."""
    if traffic["loop"] == "open":
        return float(traffic["warm_s"])
    return float(traffic["ramp_s"]) + float(traffic["warm_s"])
