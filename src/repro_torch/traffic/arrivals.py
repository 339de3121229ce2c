"""Composable arrival processes (the traffic subsystem, v5).

Every process maps ``(rng, n, rate, **knobs)`` to a sorted array of ``n``
arrival times (seconds from the trace start).  Processes are registered by
name so :class:`~repro_torch.traffic.TrafficSpec` and the legacy
``make_workload`` shim can sweep them from CLIs; **unknown names raise
ValueError** (the v4 generator silently treated any unknown string as
"uniform" — a misspelled ``arrival=`` ran the wrong experiment without a
trace).

Built-ins:
  * ``poisson``  — memoryless open-loop arrivals (exponential gaps).  The
    RNG draw sequence is bit-identical to the v4 ``make_workload`` path,
    so existing seeds reproduce byte-for-byte through the shim.
  * ``uniform``  — fixed ``1/rate`` gaps (no RNG draws).
  * ``gamma``    — renewal process with gamma gaps: ``cv > 1`` is burstier
    than Poisson (heavy clumping), ``cv < 1`` smoother.
  * ``mmpp``     — Markov-modulated Poisson by *phase schedule*: cycles
    through ``phases=((duration_s, rate_mult), ...)`` — the diurnal /
    flash-crowd shapes (a 10x burst phase is ``(burst_s, 10.0)``).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


def poisson(rng, n: int, rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def uniform(rng, n: int, rate: float) -> np.ndarray:
    return np.cumsum(np.full(n, 1.0 / rate))


def gamma(rng, n: int, rate: float, cv: float = 2.0) -> np.ndarray:
    """Gamma-renewal gaps with mean ``1/rate`` and the given coefficient
    of variation: shape ``1/cv^2``, so ``cv=1`` degenerates to Poisson."""
    if cv <= 0:
        return uniform(rng, n, rate)
    shape = 1.0 / (cv * cv)
    gaps = rng.gamma(shape, scale=1.0 / (rate * shape), size=n)
    return np.cumsum(gaps)


def mmpp(rng, n: int, rate: float,
         phases=((8.0, 1.0), (2.0, 10.0))) -> np.ndarray:
    """Phase-scheduled Poisson: the instantaneous rate is
    ``rate * mult`` inside each ``(duration_s, mult)`` phase, cycling
    through the schedule until ``n`` arrivals are drawn.  A ``mult`` of 0
    models a dead phase (time passes, nothing arrives).  Memorylessness
    makes the redraw-at-phase-boundary construction exact."""
    if not phases:
        raise ValueError("mmpp needs at least one (duration_s, mult) phase")
    if all(m <= 0 for _, m in phases):
        raise ValueError("mmpp needs at least one phase with mult > 0")
    out = np.empty(n, dtype=float)
    t = 0.0
    pi = 0
    dur, mult = phases[0]
    end = float(dur)
    k = 0
    while k < n:
        r = rate * mult
        if r > 0:
            gap = float(rng.exponential(1.0 / r))
            if t + gap <= end:
                t += gap
                out[k] = t
                k += 1
                continue
        # phase boundary (or a dead phase): jump to the next phase and
        # redraw — exact for exponential gaps (memoryless)
        t = end
        pi += 1
        dur, mult = phases[pi % len(phases)]
        end = t + float(dur)
    return out


ARRIVALS: Dict[str, Callable] = {
    "poisson": poisson,
    "uniform": uniform,
    "gamma": gamma,
    "mmpp": mmpp,
}


def register_arrival(name: str, fn: Callable) -> None:
    ARRIVALS[name] = fn


def list_arrivals() -> List[str]:
    return sorted(ARRIVALS)


def make_arrivals(name: str, rng, n: int, rate: float,
                  **knobs) -> np.ndarray:
    """Build ``n`` arrival times from the process registered as ``name``.

    Raises ``ValueError`` on unknown names — never a silent fallback."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    try:
        fn = ARRIVALS[name]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {name!r}; "
            f"registered: {list_arrivals()}") from None
    return fn(rng, n, rate, **knobs)
