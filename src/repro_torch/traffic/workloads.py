"""Named workload generators (the traffic subsystem, v5).

The v4 ``serving/workload.py`` generators live here now (that module is a
one-release re-export shim).  ``make_workload`` keeps the exact v4 RNG
draw sequence — arrivals first, then input lengths, then output lengths
on one ``default_rng(seed)`` — so every existing seeded test and
benchmark reproduces byte-for-byte.  One deliberate behavior change: the
old code silently treated ANY unknown ``arrival=`` string as "uniform";
unknown names now raise ``ValueError``.

New tiered generators (``tiered``, ``tiered_burst``) emit multi-tenant
traffic over the default Zipf prompt-class catalog, and ``closed_loop``
builds a :class:`~repro_torch.traffic.closed_loop.ClosedLoopPool` for the
driver-loop feedback path.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.traffic.arrivals import make_arrivals
from repro_torch.traffic.closed_loop import ClosedLoopPool
from repro_torch.traffic.lengths import make_lengths
from repro_torch.traffic.spec import DEFAULT_CLASSES, TrafficSpec
from repro_torch.traffic.tenants import TenantClass, default_tiers


def make_workload(n: int, input_len: int, output_len: int, *,
                  rate: float, seed: int = 0, length_cv: float = 0.0,
                  arrival: str = "poisson", tenant: Optional[TenantClass]
                  = None, **arrival_knobs) -> List[Request]:
    """`rate` req/s; lengths lognormal around the means when length_cv>0.

    v4-seed-compatible for arrival in {"poisson", "uniform"}; any
    registered arrival process (gamma, mmpp, ...) works via
    ``**arrival_knobs``; ``tenant`` tags every request with one tier."""
    rng = np.random.default_rng(seed)
    arrivals = make_arrivals(arrival, rng, n, rate, **arrival_knobs)
    ins = make_lengths("lognormal", rng, n, input_len, cv=length_cv)
    outs = make_lengths("lognormal", rng, n, output_len, cv=length_cv)
    return [Request(prompt_len=int(i), max_new_tokens=int(o),
                    arrival_time=float(t),
                    tenant=tenant.name if tenant else "",
                    slo=tenant.slo if tenant else None)
            for i, o, t in zip(ins, outs, arrivals)]


def bursty_phase_shift(n_bursts: int = 2, burst_gap_s: float = 20.0,
                       n_prefill: int = 240, prefill_rate: float = 120.0,
                       prefill_io=(2048, 64),
                       n_decode: int = 80, decode_rate: float = 8.0,
                       decode_io=(128, 1024), seed: int = 0
                       ) -> List[Request]:
    """Bursty, phase-shifted workload: each cycle opens with a dense
    prefill-heavy burst (long prompts, short outputs, near-simultaneous
    arrivals) and then shifts to a decode-heavy tail (short prompts, long
    outputs).  Static deployments provisioned for the average mix are
    mis-provisioned in BOTH halves of every cycle — the regime where
    dynamic role-switching pays (paper's motivation for adapting the P/D
    split at runtime)."""
    reqs: List[Request] = []
    for b in range(n_bursts):
        t0 = b * 2 * burst_gap_s
        burst = make_workload(n_prefill, *prefill_io, rate=prefill_rate,
                              seed=seed + 2 * b, length_cv=0.2)
        for r in burst:
            r.arrival_time += t0
        tail = make_workload(n_decode, *decode_io, rate=decode_rate,
                             seed=seed + 2 * b + 1, length_cv=0.2)
        for r in tail:
            r.arrival_time += t0 + burst_gap_s
        reqs.extend(burst)
        reqs.extend(tail)
    return sorted(reqs, key=lambda r: r.arrival_time)


# --- the paper's workloads -------------------------------------------------

def deepseek_1k1k(n: int = 2000, rate: float = 700.0, seed: int = 0):
    """Table 3 '1K-1K': balanced input/output (prefill-bottlenecked at 6P2D)."""
    return make_workload(n, 1024, 1024, rate=rate, seed=seed, length_cv=0.2)


def deepseek_1k4k(n: int = 600, rate: float = 170.0, seed: int = 0):
    """Table 3 '1K-4K': decode-heavy (decode-bottlenecked at 6P2D)."""
    return make_workload(n, 1024, 4096, rate=rate, seed=seed, length_cv=0.2)


def qwen_grid():
    """Table 4: four I/O pairs, request_rate=4, 200 requests each."""
    cells = [(256, 256), (256, 1024), (1024, 256), (1024, 1024)]
    return {f"{i}/{o}": make_workload(200, i, o, rate=4.0, seed=42)
            for i, o in cells}


# --- shared-prefix multi-turn traffic (prefix-cache tier, v6) --------------

def multi_turn(n: int = 300, rate: float = 30.0, seed: int = 0,
               conversations: int = 16, system_tokens: int = 512,
               turn_tokens: int = 128, output_tokens: int = 64,
               zipf_alpha: float = 1.1, arrival: str = "poisson",
               vocab: int = 32000) -> List[Request]:
    """Shared-prefix chat traffic: every request carries REAL token ids.

    ``conversations`` concurrent conversations share one ``system_tokens``
    system-prompt head; each conversation then grows its own history —
    turn ``t``'s prompt is the system head, the ``t`` previous (user turn
    + assistant reply) exchanges, and a fresh ``turn_tokens`` user turn.
    Arrivals are drawn per the arrival process and conversations are
    picked Zipf-``zipf_alpha`` (hot conversations turn over fast), so
    consecutive requests of one conversation share a long, growing
    prefix and ALL requests share the system head — the regime where a
    page-aligned prefix index converts prompt tokens into cache hits.

    Token ids are deterministic in ``seed``: the cache tier (and its
    benchmark) sees identical hash chains run-to-run."""
    rng = np.random.default_rng(seed)
    arrivals = make_arrivals(arrival, rng, n, rate)
    system = rng.integers(0, vocab, size=system_tokens, dtype=np.int32)
    # per-conversation token streams, grown lazily as turns accumulate
    streams: List[np.ndarray] = [
        np.empty(0, np.int32) for _ in range(max(1, conversations))]
    turns = [0] * len(streams)
    # Zipf over conversation ranks (same zeta idiom as TrafficSpec)
    ranks = np.arange(1, len(streams) + 1, dtype=np.float64)
    weights = ranks ** -zipf_alpha
    weights /= weights.sum()
    reqs: List[Request] = []
    per_turn = turn_tokens + output_tokens
    for t in arrivals:
        c = int(rng.choice(len(streams), p=weights))
        need = turns[c] * per_turn + turn_tokens
        if streams[c].shape[0] < need:
            grow = rng.integers(0, vocab, size=need - streams[c].shape[0],
                                dtype=np.int32)
            streams[c] = np.concatenate([streams[c], grow])
        prompt = np.concatenate([system, streams[c][:need]])
        turns[c] += 1
        reqs.append(Request(prompt_len=int(prompt.shape[0]),
                            max_new_tokens=int(output_tokens),
                            arrival_time=float(t),
                            tenant=f"conv{c}",
                            prompt_tokens=prompt))
    return reqs


# --- tiered multi-tenant traffic -------------------------------------------

def tiered(n: int = 400, rate: float = 40.0, seed: int = 0,
           zipf_alpha: float = 1.1, ttft_scale: float = 1.0,
           tpot_scale: float = 1.0,
           tiers: Tuple[TenantClass, ...] = ()) -> List[Request]:
    """Steady Poisson multi-tenant traffic: Zipf mix over the default
    prompt-class catalog, tenants by the interactive/standard/batch split."""
    spec = TrafficSpec(n=n, rate=rate, arrival="poisson",
                       classes=DEFAULT_CLASSES, zipf_alpha=zipf_alpha,
                       tenants=tiers or default_tiers(ttft_scale, tpot_scale))
    return spec.generate(seed)


def tiered_burst(n: int = 600, rate: float = 30.0, burst_mult: float = 10.0,
                 base_s: float = 8.0, burst_s: float = 2.0, seed: int = 0,
                 zipf_alpha: float = 1.1, ttft_scale: float = 1.0,
                 tpot_scale: float = 1.0,
                 tiers: Tuple[TenantClass, ...] = ()) -> List[Request]:
    """Tiered traffic under an MMPP flash crowd: calm at ``rate`` for
    ``base_s``, then ``burst_mult``x for ``burst_s``, cycling — the regime
    where tenant-blind admission lets batch traffic crowd interactive out."""
    spec = TrafficSpec(
        n=n, rate=rate, arrival="mmpp",
        arrival_knobs={"phases": ((base_s, 1.0), (burst_s, burst_mult))},
        classes=DEFAULT_CLASSES, zipf_alpha=zipf_alpha,
        tenants=tiers or default_tiers(ttft_scale, tpot_scale))
    return spec.generate(seed)


def closed_loop(users: int = 16, think_time_s: float = 2.0,
                requests_per_user: int = 8, seed: int = 0,
                zipf_alpha: float = 1.1, ttft_scale: float = 1.0,
                tpot_scale: float = 1.0, tiered_tenants: bool = True,
                spec: Optional[TrafficSpec] = None) -> ClosedLoopPool:
    """N closed-loop clients over the tiered mix (see
    :class:`ClosedLoopPool`): pass the result to ``Cluster.run(traffic=...)``."""
    if spec is None:
        spec = TrafficSpec(
            classes=DEFAULT_CLASSES, zipf_alpha=zipf_alpha,
            tenants=(default_tiers(ttft_scale, tpot_scale)
                     if tiered_tenants else ()))
    return ClosedLoopPool(spec, users=users, think_time_s=think_time_s,
                          requests_per_user=requests_per_user, seed=seed)
