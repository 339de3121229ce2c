"""Online chunk-size adaptation from predicted decode-slack (v9).

Micro-batched prefill (v4) made ``chunk_prefill_tokens`` a real online
knob: a prefill is split into chunks so decode steps can interleave and
TPOT stays bounded while long prompts stream in.  The static knob is a
compromise — too small and launch overhead dominates an idle device, too
large and a co-located decode batch misses its TPOT SLO during every
chunk.

:class:`ChunkAdapter` retunes the knob per decision point (every prefill
enqueue) from the latency model:

  * no decode batch on the device → no one to protect → one big chunk
    (0 = unchunked: prefill at full roofline speed);
  * decode running → the chunk must fit the predicted **decode slack**,
    ``headroom * tpot_slo - predicted_step``: the time the tightest
    co-located tenant can spare between steps.  The model's
    ``invert_tokens`` maps that budget back to a token count.

All decisions are clamped to ``[min_tokens, max_tokens]``, rounded to
``quantum`` (page-aligned launches), and counted for telemetry.
"""
from __future__ import annotations

from typing import Dict


class ChunkAdapter:
    """Per-instance adaptive ``chunk_prefill_tokens`` (stateful counters:
    construct one per instance, like admission policies)."""

    def __init__(self, latency, base_tokens: int = 0,
                 min_tokens: int = 128, max_tokens: int = 8192,
                 headroom: float = 0.5, quantum: int = 64):
        self.latency = latency
        self.base_tokens = int(base_tokens)
        self.min_tokens = max(1, int(min_tokens))
        self.max_tokens = max(self.min_tokens, int(max_tokens))
        self.headroom = float(headroom)
        self.quantum = max(1, int(quantum))
        self.decisions = 0
        self.adapted = 0        # decisions that deviated from the base
        self.last_tokens = self.base_tokens
        self._min_seen = 0
        self._max_seen = 0

    def chunk_tokens(self, decode_batch: int, avg_ctx: float,
                     tpot_slo_s: float) -> int:
        """The chunk size to use for a prefill enqueued NOW.

        ``decode_batch`` / ``avg_ctx`` describe the instance's current
        decode batch; ``tpot_slo_s`` is the tightest TPOT SLO among the
        decoding requests (<= 0 when none carries one).  Returns 0 for
        "don't chunk"."""
        self.decisions += 1
        out = self.base_tokens
        if decode_batch <= 0:
            out = 0                      # idle decode: full-speed prefill
        elif tpot_slo_s > 0.0:
            step = self.latency.predict("decode", float(decode_batch),
                                        float(avg_ctx))
            slack = self.headroom * tpot_slo_s - (step or 0.0)
            toks = self.latency.invert_tokens(
                "prefill", max(slack, 0.0), float(avg_ctx))
            if toks is not None:
                out = min(max(int(toks), self.min_tokens), self.max_tokens)
                out -= out % self.quantum
                out = max(out, self.quantum)
        if out != self.base_tokens:
            self.adapted += 1
        self.last_tokens = out
        self._min_seen = out if self._min_seen == 0 \
            else min(self._min_seen, out)
        self._max_seen = max(self._max_seen, out)
        return out

    def debug_state(self) -> Dict[str, float]:
        return {"chunk_decisions": self.decisions,
                "chunk_adapted": self.adapted,
                "chunk_last": self.last_tokens,
                "chunk_min": self._min_seen,
                "chunk_max": self._max_seen}
