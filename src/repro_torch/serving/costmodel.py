"""Roofline cost model: per-phase step times for the cluster simulator.

The twin of ``repro/serving/costmodel.py``, the same code apart from its
import paths, its hardware constants and its derates.  The constants are
one NVIDIA H100 SXM's (NVIDIA's data sheet): 989 TFLOP/s dense bf16,
3.35 TB/s of HBM3, 80 GB of it, and NVLink at 900 GB/s a GPU, 450 GB/s
each way.  ``InstanceSpec``'s derates are fitted to the card
(``chip_smoke.py``'s ``sim`` phase; beside them, the card and the
shapes).  The analytic terms are those of the dry-run's roofline
(``launch/dryrun.py``); its traced FLOPs/bytes can be fed back in through
``calibration`` multipliers so simulated times track the traced steps.

Phase behaviour (paper Figures 1-2):
  * prefill — compute-term dominated (large matmuls over the whole prompt);
  * decode — memory-term dominated: every step re-reads the weights and the
    KV cache; past the bandwidth knee extra compute share buys nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.profiler import HBM_BW_BYTES, PEAK_FLOPS

HBM_BW = HBM_BW_BYTES        # bytes/s / chip (H100 SXM, HBM3)
# NVLink (fourth generation): 900 GB/s a GPU in both directions together
# (NVIDIA's H100 SXM data sheet), so 450 GB/s each way
ICI_BW = 450e9               # bytes/s each way, the one-directional rate
HBM_PER_CHIP = 80e9          # H100 SXM HBM capacity


@dataclasses.dataclass
class InstanceSpec:
    """A logical serving instance spanning `chips` devices."""
    name: str
    chips: int
    # modeled efficiencies (MFU-style derates; calibratable) and the fixed
    # per-launch overhead (dispatch + host + collective setup), fitted by
    # least squares to the host times of olmo-1b at full width on one
    # card ("NVIDIA H100 80GB HBM3, 700.00 W" by nvidia-smi): prefills of
    # 128, 512 and 2048 tokens at batch 1 and decode steps at batch 1, 2
    # and 4 over contexts of 512 and 2048 (``chip_smoke.py``'s sim phase;
    # rms error 3.0 ms).  The port's host dispatch of ~900 kernels a step
    # sets the overhead; the memory term absorbs part of it too
    compute_eff: float = 0.806
    bw_eff: float = 0.122
    launch_overhead_s: float = 0.0131
    # fraction of each step spent in non-overlapped collectives (TP/EP);
    # the reference's: one card has no collective to fit it to
    collective_frac: float = 0.08


@dataclasses.dataclass
class CostModel:
    cfg: ModelConfig
    weight_bytes_per_chip: Optional[float] = None
    calibration_flops: float = 1.0      # HLO_FLOPs / MODEL_FLOPS from dry-run
    calibration_bytes: float = 1.0

    def __post_init__(self):
        self.n_params = self.cfg.param_count()
        self.n_active = self.cfg.active_param_count()
        self.bytes_per_param = 2 if "16" in self.cfg.param_dtype else 4
        # one-entry memos for the decode hot path: every decode step
        # evaluates the same (spec, batch, context) point several times
        # (estimate at enqueue, duration + meta + compute share at
        # dispatch) — keyed on the VALUES the terms depend on, so a hit is
        # exactly the recomputation it skips
        self._terms_key = None
        self._terms_val = (0.0, 0.0)
        self._kv_key: Optional[int] = None
        self._kv_val = 0.0

    # ------------------------------------------------------------ helpers
    def kv_bytes_per_token(self) -> float:
        """KV-cache bytes appended per generated/prefilled token."""
        cfg = self.cfg
        bpe = 1 if cfg.kv_cache_dtype == "int8" else 2
        n_attn = cfg.num_attention_layers()
        window = cfg.sliding_window or 0
        kv = 2 * n_attn * cfg.num_kv_heads * cfg.head_dim * bpe
        # ssm/hybrid: constant state, amortized ~0 per token
        return float(kv)

    def kv_bytes_total(self, context: int) -> float:
        if context == self._kv_key:
            return self._kv_val
        cfg = self.cfg
        eff_ctx = context
        if cfg.sliding_window and not cfg.local_global_alternating:
            eff_ctx = min(context, cfg.sliding_window)
        per_tok = self.kv_bytes_per_token()
        if cfg.local_global_alternating and cfg.sliding_window:
            # half the layers are windowed
            full = per_tok / 2 * context
            local = per_tok / 2 * min(context, cfg.sliding_window)
            out = full + local
        else:
            out = per_tok * eff_ctx
        self._kv_key, self._kv_val = context, out
        return out

    def ssm_state_bytes(self) -> float:
        cfg = self.cfg
        if cfg.ssm is None:
            return 0.0
        d_inner = cfg.ssm.expand * cfg.d_model
        nheads = d_inner // cfg.ssm.head_dim
        n_ssm = cfg.num_layers - cfg.num_attention_layers() \
            + (cfg.encoder_layers if False else 0)
        per_layer = nheads * cfg.ssm.head_dim * cfg.ssm.state_dim * 4
        return float(n_ssm * per_layer)

    def weights_bytes(self) -> float:
        return self.n_params * self.bytes_per_param

    # --------------------------------------------------------- step times
    def _prefill_terms(self, spec: InstanceSpec, tokens: int,
                       context: int = 0) -> "tuple[float, float]":
        """(t_compute, t_memory) of one prefill launch (roofline terms).
        Attention flops (causal): 2 * 2 * tokens * ctx/2 * H * D per
        layer — see ``prefill_flops``."""
        flops = self.prefill_flops(tokens, context)
        bytes_ = (self.weights_bytes()
                  + tokens * self.kv_bytes_per_token()) * self.calibration_bytes
        return (flops / (spec.chips * PEAK_FLOPS * spec.compute_eff),
                bytes_ / (spec.chips * HBM_BW * spec.bw_eff))

    def _decode_terms(self, spec: InstanceSpec, batch: int,
                      avg_context: int) -> "tuple[float, float]":
        """(t_compute, t_memory) of one decode step (roofline terms)."""
        key = (spec.chips, spec.compute_eff, spec.bw_eff, batch, avg_context)
        if key == self._terms_key:
            return self._terms_val
        flops = 2.0 * self.n_active * batch * self.calibration_flops
        bytes_ = (self.weights_bytes()
                  + batch * self.kv_bytes_total(avg_context)
                  + batch * self.ssm_state_bytes()) * self.calibration_bytes
        out = (flops / (spec.chips * PEAK_FLOPS * spec.compute_eff),
               bytes_ / (spec.chips * HBM_BW * spec.bw_eff))
        self._terms_key, self._terms_val = key, out
        return out

    def prefill_flops(self, tokens: int, context: int = 0) -> float:
        """Model FLOPs of prefilling ``tokens`` at ``context`` total
        attention context — the numerator of the prefill roofline compute
        term, exposed for recompute-savings telemetry (the prefix-cache
        tier reports FLOPs it avoided by skipping cached tokens)."""
        cfg = self.cfg
        flops = 2.0 * self.n_active * tokens * self.calibration_flops
        ctx = max(context, tokens)
        flops += 2.0 * cfg.num_attention_layers() * tokens * ctx \
            * cfg.num_heads * cfg.head_dim
        return flops

    def prefill_time(self, spec: InstanceSpec, tokens: int,
                     context: int = 0) -> float:
        """One prefill launch over `tokens` prompt tokens (sum over batch)."""
        t = max(self._prefill_terms(spec, tokens, context))
        return t * (1 + spec.collective_frac) + spec.launch_overhead_s

    def decode_time(self, spec: InstanceSpec, batch: int,
                    avg_context: int) -> float:
        """One decode step for a batch of sequences at `avg_context`."""
        t = max(self._decode_terms(spec, batch, avg_context))
        return t * (1 + spec.collective_frac) + spec.launch_overhead_s

    # ------------------------------------------------- vectorized
    # Array evaluation of the same roofline expressions: one NumPy pass
    # over every in-flight op of a device instead of a Python call per op.
    # Each expression below is written in the SAME operand order as its
    # scalar twin, so element-wise float64 results are bit-identical to a
    # Python-loop evaluation (IEEE ops are deterministic; only the loop is
    # vectorized, never the arithmetic).

    def prefill_times(self, spec: InstanceSpec, tokens,
                      contexts=None) -> np.ndarray:
        """`prefill_time` over arrays of chunk sizes / attention contexts
        (the chunked-prefill enqueue costs all chunks in one shot)."""
        toks = np.asarray(tokens, dtype=np.float64)
        ctx = np.zeros_like(toks) if contexts is None \
            else np.asarray(contexts, dtype=np.float64)
        cfg = self.cfg
        flops = 2.0 * self.n_active * toks * self.calibration_flops
        flops = flops + 2.0 * cfg.num_attention_layers() * toks \
            * np.maximum(ctx, toks) * cfg.num_heads * cfg.head_dim
        bytes_ = (self.weights_bytes()
                  + toks * self.kv_bytes_per_token()) * self.calibration_bytes
        t_c = flops / (spec.chips * PEAK_FLOPS * spec.compute_eff)
        t_m = bytes_ / (spec.chips * HBM_BW * spec.bw_eff)
        t = np.maximum(t_c, t_m)
        return t * (1 + spec.collective_frac) + spec.launch_overhead_s

    def _kv_bytes_total_arr(self, ctx: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        per_tok = self.kv_bytes_per_token()
        if cfg.local_global_alternating and cfg.sliding_window:
            return per_tok / 2 * ctx \
                + per_tok / 2 * np.minimum(ctx, cfg.sliding_window)
        if cfg.sliding_window and not cfg.local_global_alternating:
            ctx = np.minimum(ctx, cfg.sliding_window)
        return per_tok * ctx

    def decode_times(self, spec: InstanceSpec, batches,
                     avg_contexts) -> np.ndarray:
        """`decode_time` over arrays of batch sizes / average contexts
        (the fluid engine rates whole drain trajectories in one pass)."""
        b = np.asarray(batches, dtype=np.float64)
        ctx = np.asarray(avg_contexts, dtype=np.float64)
        flops = 2.0 * self.n_active * b * self.calibration_flops
        bytes_ = (self.weights_bytes()
                  + b * self._kv_bytes_total_arr(ctx)
                  + b * self.ssm_state_bytes()) * self.calibration_bytes
        t_c = flops / (spec.chips * PEAK_FLOPS * spec.compute_eff)
        t_m = bytes_ / (spec.chips * HBM_BW * spec.bw_eff)
        t = np.maximum(t_c, t_m)
        return t * (1 + spec.collective_frac) + spec.launch_overhead_s

    # ---------------------------------------------- compute-demand shares
    # An op's "compute share" is its compute-boundedness: the fraction of
    # the device's FLOP throughput it actually converts into progress
    # (t_compute / max(t_compute, t_memory)).  The execution-queue
    # contention model splits FLOP throughput among concurrent compute-
    # queue ops in proportion to these shares, so a bandwidth-bound decode
    # step (share << 1) rides beside a compute-bound prefill chunk
    # (share ~= 1) nearly for free — the paper's co-location claim.
    MIN_COMPUTE_SHARE = 0.05

    @classmethod
    def _share(cls, t_compute: float, t_memory: float) -> float:
        t = max(t_compute, t_memory, 1e-12)
        return min(1.0, max(cls.MIN_COMPUTE_SHARE, t_compute / t))

    def prefill_compute_share(self, spec: InstanceSpec, tokens: int,
                              context: int = 0) -> float:
        return self._share(*self._prefill_terms(spec, tokens, context))

    def decode_compute_share(self, spec: InstanceSpec, batch: int,
                             avg_context: int) -> float:
        return self._share(*self._decode_terms(spec, batch, avg_context))

    # ------------------------------------------------ phase meta for ops
    def decode_meta(self, spec: InstanceSpec, batch: int, avg_context: int) -> Dict:
        return {
            "bytes": (self.weights_bytes() / spec.chips
                      + batch * self.kv_bytes_total(avg_context) / spec.chips),
            "flops": 2.0 * self.n_active * batch / spec.chips,
            "tokens": batch,
            # v9 predictors featurize on (tokens, ctx); for decode the
            # context is the batch's mean sequence length
            "ctx": avg_context,
        }

    def prefill_meta(self, spec: InstanceSpec, tokens: int) -> Dict:
        return {
            "bytes": self.weights_bytes() / spec.chips,
            "flops": 2.0 * self.n_active * tokens / spec.chips,
            "tokens": tokens,
        }

    # -------------------------------------------------------- memory/misc
    def kv_capacity_tokens(self, spec: InstanceSpec,
                           reserve_frac: float = 0.1) -> int:
        """How many KV tokens fit on the instance after weights."""
        wpc = self.weight_bytes_per_chip
        if wpc is None:
            wpc = self.weights_bytes() / spec.chips
        free = spec.chips * (HBM_PER_CHIP * (1 - reserve_frac)) \
            - self.weights_bytes()
        per_tok = max(self.kv_bytes_per_token(), 1.0)
        return max(0, int(free / per_tok))

    def transfer_time(self, kv_tokens: int, bw: float = ICI_BW,
                      latency_s: float = 0.001) -> float:
        """KV-cache movement between disaggregated instances (contention-free
        reference; the simulator times real transfers with LinkModel)."""
        return latency_s + kv_tokens * self.kv_bytes_per_token() / bw

    def decode_bandwidth_utilization(self, core_frac: float, batch: int,
                                     avg_context: int,
                                     spec: Optional[InstanceSpec] = None) -> float:
        """Figure 2: HBM utilization as a function of allocated compute share.

        With `core_frac` of the AI cores, compute time stretches by 1/frac;
        bandwidth util = t_memory / max(t_compute/frac, t_memory)."""
        spec = spec or InstanceSpec("one", 1)
        flops = 2.0 * self.n_active * batch
        bytes_ = self.weights_bytes() + batch * self.kv_bytes_total(avg_context)
        t_c = flops / (spec.chips * PEAK_FLOPS * spec.compute_eff * core_frac)
        t_m = bytes_ / (spec.chips * HBM_BW * spec.bw_eff)
        return t_m / max(t_c, t_m)

__all__ = ["CostModel", "InstanceSpec",
           "PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_PER_CHIP"]
