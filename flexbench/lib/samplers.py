"""Arrival and length samplers, frozen copies of the port's
``repro_torch/traffic/arrivals.py`` (``poisson``, ``gamma``, ``uniform``)
and ``repro_torch/traffic/lengths.py`` (``fixed``, ``lognormal``) as of
the benchmark's first version.  They stay here unchanged so that a change
to the program's traffic code cannot change the benchmark's traffic."""
from __future__ import annotations

import numpy as np


def poisson(rng, n: int, rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def uniform(rng, n: int, rate: float) -> np.ndarray:
    return np.cumsum(np.full(n, 1.0 / rate))


def gamma(rng, n: int, rate: float, cv: float = 2.0) -> np.ndarray:
    """Gamma-renewal gaps with mean ``1/rate`` and coefficient of
    variation ``cv`` (shape ``1/cv^2``; ``cv=1`` is Poisson)."""
    if cv <= 0:
        return uniform(rng, n, rate)
    shape = 1.0 / (cv * cv)
    gaps = rng.gamma(shape, scale=1.0 / (rate * shape), size=n)
    return np.cumsum(gaps)


def fixed(rng, n: int, mean: float) -> np.ndarray:
    return np.full(n, int(mean), dtype=int)


def lognormal(rng, n: int, mean: float, cv: float = 0.2) -> np.ndarray:
    """Lognormal with the given mean and coefficient of variation;
    ``cv <= 0`` is ``fixed`` and draws nothing."""
    if cv <= 0:
        return fixed(rng, n, mean)
    sigma = np.sqrt(np.log(1 + cv ** 2))
    mu = np.log(mean) - sigma ** 2 / 2
    return np.maximum(1, rng.lognormal(mu, sigma, size=n).astype(int))


ARRIVALS = {"poisson": poisson, "uniform": uniform, "gamma": gamma}
LENGTHS = {"fixed": fixed, "lognormal": lognormal}


def arrivals(name: str, rng, n: int, rate: float, **knobs) -> np.ndarray:
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    if name not in ARRIVALS:
        raise ValueError(f"unknown arrival process {name!r}; "
                         f"known: {sorted(ARRIVALS)}")
    return ARRIVALS[name](rng, n, rate, **knobs)


def lengths(name: str, rng, n: int, mean: float, **knobs) -> np.ndarray:
    if name not in LENGTHS:
        raise ValueError(f"unknown length sampler {name!r}; "
                         f"known: {sorted(LENGTHS)}")
    return LENGTHS[name](rng, n, mean, **knobs)
