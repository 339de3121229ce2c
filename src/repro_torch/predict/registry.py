"""Predictor registry: construct any learned model by name (v9).

    from repro_torch.predict import make_predictor

    make_predictor("ridge_latency", l2=1e-6)        # central estimate
    make_predictor("quantile_latency", tau=0.9)     # pessimistic p90
    make_predictor("ridge_latency", trace="flextrace-123-0.json")
    make_predictor("length_quantile", q=0.9)        # output-length sketch

Thin wrapper over the shared :mod:`repro_torch.registry` helper, so unknown
names raise the unified :class:`~repro_torch.registry.UnknownNameError` and
unknown knobs raise ``TypeError`` naming the accepted set — the same
contract as ``make_policy`` / ``make_traffic`` / ``make_topology`` /
``make_cache``.
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.predict.latency import LatencyModel
from repro_torch.predict.length import LengthPredictor
from repro_torch.registry import Registry

_REG = Registry("predictor")


def register_predictor(name: str, factory: Callable,
                       knobs: tuple = ()) -> None:
    """Register a predictor constructor under a sweepable name."""
    _REG.register(name, factory, knobs=knobs)


def list_predictors() -> List[str]:
    return _REG.names()


def make_predictor(name: str, **knobs):
    """Build the predictor registered as ``name`` with the given knobs."""
    return _REG.make(name, **knobs)


def _quantile_latency(l2: float = 1e-6, tau: float = 0.9,
                      trace: str = "") -> LatencyModel:
    return LatencyModel(l2=l2, tau=tau, trace=trace)


register_predictor("ridge_latency", LatencyModel,
                   knobs=("l2", "tau", "trace"))
register_predictor("quantile_latency", _quantile_latency,
                   knobs=("l2", "tau", "trace"))
register_predictor("length_quantile", LengthPredictor,
                   knobs=("q", "bins", "max_len", "min_count",
                          "default_len"))
