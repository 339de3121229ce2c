"""Token-length samplers (the traffic subsystem, v5).

Every sampler maps ``(rng, n, mean, **knobs)`` to an int array of ``n``
token counts (always >= 1).  Registered by name so prompt classes pick
their input/output distributions declaratively; unknown names raise
ValueError.

Built-ins:
  * ``fixed``     — every request exactly ``mean`` tokens (no RNG draws).
  * ``lognormal`` — the v4 generator's distribution, parameterized by
    coefficient of variation; ``cv <= 0`` degenerates to ``fixed`` without
    consuming RNG state (bit-compat with the old ``make_workload``).
  * ``pareto``    — heavy-tailed with finite mean (``alpha > 1``): the
    occasional 50k-token monster prompt that wrecks tenant-blind queues.
  * ``empirical`` — resample a measured histogram of ``(tokens, weight)``
    pairs (the fb_etc_dists idea: drive the simulator with production
    length traces instead of parametric fits).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


def fixed(rng, n: int, mean: float) -> np.ndarray:
    return np.full(n, int(mean), dtype=int)


def lognormal(rng, n: int, mean: float, cv: float = 0.2) -> np.ndarray:
    """Lognormal with the given mean and coefficient of variation.

    Draw-for-draw identical to the v4 ``make_workload`` length path, so
    old seeds reproduce through the shim; ``cv <= 0`` is ``fixed`` and
    draws nothing."""
    if cv <= 0:
        return fixed(rng, n, mean)
    sigma = np.sqrt(np.log(1 + cv ** 2))
    mu = np.log(mean) - sigma ** 2 / 2
    return np.maximum(1, rng.lognormal(mu, sigma, size=n).astype(int))


def pareto(rng, n: int, mean: float, alpha: float = 2.5) -> np.ndarray:
    """Pareto (Lomax-shifted) lengths with the given mean; ``alpha``
    controls tail heaviness — smaller alpha, fatter tail.  Needs
    ``alpha > 1`` for the mean to exist: ``xm = mean * (alpha-1)/alpha``."""
    if alpha <= 1:
        raise ValueError(f"pareto lengths need alpha > 1, got {alpha}")
    xm = mean * (alpha - 1.0) / alpha
    return np.maximum(1, (xm * (1.0 + rng.pareto(alpha, size=n))).astype(int))


def empirical(rng, n: int, mean: float = 0.0, hist=()) -> np.ndarray:
    """Resample a measured histogram: ``hist`` is a sequence of
    ``(tokens, weight)`` pairs; ``mean`` is ignored (the trace decides)."""
    if not hist:
        raise ValueError("empirical lengths need hist=((tokens, weight), ...)")
    vals = np.asarray([v for v, _ in hist], dtype=int)
    w = np.asarray([w for _, w in hist], dtype=float)
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError("empirical length weights must be >= 0, sum > 0")
    return np.maximum(1, rng.choice(vals, size=n, p=w / w.sum()))


LENGTHS: Dict[str, Callable] = {
    "fixed": fixed,
    "lognormal": lognormal,
    "pareto": pareto,
    "empirical": empirical,
}


def register_lengths(name: str, fn: Callable) -> None:
    LENGTHS[name] = fn


def list_lengths() -> List[str]:
    return sorted(LENGTHS)


def make_lengths(name: str, rng, n: int, mean: float, **knobs) -> np.ndarray:
    """Sample ``n`` token lengths from the sampler registered as ``name``.

    Raises ``ValueError`` on unknown names — never a silent fallback."""
    try:
        fn = LENGTHS[name]
    except KeyError:
        raise ValueError(
            f"unknown length sampler {name!r}; "
            f"registered: {list_lengths()}") from None
    return fn(rng, n, mean, **knobs)
