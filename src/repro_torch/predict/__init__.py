# Predictive scheduling models (v9) — learned latency / output-length
# predictors behind one registry, per the ROADMAP's "Predictive
# scheduling" item and "Latency Prediction for LLM Inference on NPU
# Systems" (PAPERS.md).
#
#   LatencyModel    — per-op latency predictor: per-phase ridge (or
#                     residual-shifted quantile) fit over
#                     [1, tokens, ctx, tokens*ctx], fitted offline from
#                     FLEX_PROFILE Chrome traces or bootstrapped from the
#                     analytic cost model; every fit attaches a
#                     calibration report (MAPE + p90 relative error).
#   LengthPredictor — online output-length predictor: a running
#                     log-binned quantile sketch per (prompt class,
#                     tenant) key, updated from completed requests.
#   ChunkAdapter    — online chunk-size adapter: retunes
#                     chunk_prefill_tokens per decision point from the
#                     predicted decode-slack (inverts the latency model).
#
# Everything is constructed through make_predictor(name, **knobs), a thin
# wrapper over the shared repro_torch.registry helper — the same unknown-name /
# strict-knob contract as make_policy / make_traffic / make_cache.
#
# Both predictors track ONLINE error (MAPE, p90, over/under-prediction
# counts) against every observation, so the `prediction` section of
# Cluster.run() results reports misprediction honestly alongside any
# policy win.
from repro_torch.predict.adapt import ChunkAdapter
from repro_torch.predict.features import (OpSample, cost_model_samples,
                                    load_samples, samples_from_events)
from repro_torch.predict.latency import LatencyModel
from repro_torch.predict.length import LengthPredictor, QuantileSketch
from repro_torch.predict.registry import (list_predictors, make_predictor,
                                    register_predictor)

__all__ = [
    "ChunkAdapter", "LatencyModel", "LengthPredictor", "OpSample",
    "QuantileSketch", "cost_model_samples", "list_predictors",
    "load_samples", "make_predictor", "register_predictor",
    "samples_from_events",
]
